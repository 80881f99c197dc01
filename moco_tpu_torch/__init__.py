"""PyTorch/CUDA port of moco_tpu: the MoCo v1/v2 ResNet pretrain step on one
NVIDIA Hopper card, with hand-written CUDA kernels for the BatchNorm
reductions and the per-sample Gaussian blur (`csrc/`).

The JAX package `moco_tpu` is the reference; this package imports nothing
from it and nothing of JAX. Entry point: `python -m moco_tpu_torch.train`.
"""
