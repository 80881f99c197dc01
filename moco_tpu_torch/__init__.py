"""PyTorch/CUDA port of moco_tpu: the MoCo v1/v2 ResNet pretrain step on
NVIDIA Hopper cards, one card or one process per card (`parallel/`), with
hand-written CUDA kernels for the BatchNorm reductions, the per-sample
Gaussian blur and the fused BN->ReLU->conv family (`csrc/`).

The JAX package `moco_tpu` is the reference; this package imports nothing
from it and nothing of JAX. Entry point: `python -m moco_tpu_torch.train`.
"""
