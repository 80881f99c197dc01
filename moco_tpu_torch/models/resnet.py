"""ResNet encoders (port of `moco_tpu/models/resnet.py`).

Same structure and parameter names as the flax modules, so
`weights.params_from_jax` maps one tree onto the other leaf by leaf:

- `forward` takes NHWC images like the JAX model; inside, activations are
  channels_last NCHW tensors (an NHWC tensor seen through `permute`).
- Parameters are f32. A conv casts its input and weight to the compute
  dtype at use (flax `nn.Conv(dtype=..., param_dtype=float32)`); the pooled
  features and the head run in f32. Casts are written out, not autocast,
  which would run the f32 head in bf16.
- Bottleneck is v1.5 (stride on the 3x3). 3x3 convs pad 1 on both sides,
  also at stride 2. The stem is the plain 7x7/2 conv with pad 3 (the JAX
  package's space-to-depth stem is the same convolution re-tiled for the
  TPU's matrix unit), BN, ReLU, 3x3/2 max-pool; `cifar_stem` is 3x3/1
  with no pool.
- Initialization follows flax: convs and dense kernels lecun-normal
  (truncated), dense biases 0, BN scale 1 and bias 0.
- `fused_bn_conv=True` runs the blocks' interior bn->relu->conv passes
  through the fused kernels (`models/fused_block.py`) with the same
  parameters. Unlike the JAX package, which fuses on the TPU only, the path
  is taken wherever it is configured: on the CPU the kernels' wrappers take
  their plain versions.
- `bn_group` (`sync_bn`): every BN of the backbone, the stem's and the
  blocks', takes its train-mode statistics over that process group's global
  batch (`models/fast_bn.py`). As in the JAX package, whose fused tail is
  "ignored for SyncBN", a `bn_group` keeps the fused tail off.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from moco_tpu_torch.models.fast_bn import FastBatchNorm
from moco_tpu_torch.models.fused_block import (
    fused_bn_relu_conv2,
    fused_bn_relu_conv2_s2,
    fused_bn_relu_conv3,
)

_TRUNC_STD = 0.87962566103423978  # std of a unit normal truncated to [-2, 2]


def lecun_normal_(w: torch.Tensor, fan_in: int, generator: torch.Generator) -> None:
    """flax `lecun_normal`: truncated normal with variance 1/fan_in."""
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    with torch.no_grad():
        nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std, generator=generator)


class Conv(nn.Module):
    """Bias-free conv, f32 OIHW weight cast to the compute dtype at use."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int = 1,
                 padding: int = 0, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.stride, self.padding, self.dtype = stride, padding, dtype
        self.weight = nn.Parameter(torch.empty(cout, cin, kernel, kernel))

    def reset_parameters(self, generator: torch.Generator) -> None:
        cout, cin, kh, kw = self.weight.shape
        lecun_normal_(self.weight, cin * kh * kw, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight.to(self.dtype, memory_format=torch.channels_last)
        return F.conv2d(x.to(self.dtype), w, None, self.stride, self.padding)


class BasicBlock(nn.Module):
    """2x 3x3 residual block (ResNet-18/34). `fused_tail=True` runs
    bn1 -> relu -> conv2 (always stride 1) as one fused pass."""

    expansion = 1

    def __init__(self, cin: int, filters: int, stride: int, dtype, fused_tail: bool = False,
                 bn_group=None):
        super().__init__()
        self.fused_tail = fused_tail
        self.conv1 = Conv(cin, filters, 3, stride, 1, dtype)
        self.bn1 = FastBatchNorm(filters, group=bn_group)
        self.conv2 = Conv(filters, filters, 3, 1, 1, dtype)
        self.bn2 = FastBatchNorm(filters, group=bn_group)
        self.has_downsample = stride != 1 or cin != filters
        if self.has_downsample:
            self.downsample_conv = Conv(cin, filters, 1, stride, 0, dtype)
            self.downsample_bn = FastBatchNorm(filters, group=bn_group)

    def forward(self, x):
        y = self.conv1(x)
        if self.fused_tail:
            y = fused_bn_relu_conv2(self, y)
        else:
            y = self.conv2(F.relu(self.bn1(y)))
        y = self.bn2(y)
        res = self.downsample_bn(self.downsample_conv(x)) if self.has_downsample else x
        return F.relu(res + y)


class Bottleneck(nn.Module):
    """1x1 -> 3x3(stride) -> 1x1(x4) residual block (ResNet-50/101/152, v1.5).
    `fused_tail=True` runs both interior passes fused: bn1 -> relu -> conv2
    (stride 1 or 2) and bn2 -> relu -> conv3."""

    expansion = 4

    def __init__(self, cin: int, filters: int, stride: int, dtype, fused_tail: bool = False,
                 bn_group=None):
        super().__init__()
        self.fused_tail = fused_tail
        out = filters * self.expansion
        self.conv1 = Conv(cin, filters, 1, 1, 0, dtype)
        self.bn1 = FastBatchNorm(filters, group=bn_group)
        self.conv2 = Conv(filters, filters, 3, stride, 1, dtype)
        self.bn2 = FastBatchNorm(filters, group=bn_group)
        self.conv3 = Conv(filters, out, 1, 1, 0, dtype)
        self.bn3 = FastBatchNorm(out, group=bn_group)
        self.has_downsample = stride != 1 or cin != out
        if self.has_downsample:
            self.downsample_conv = Conv(cin, out, 1, stride, 0, dtype)
            self.downsample_bn = FastBatchNorm(out, group=bn_group)

    def forward(self, x):
        y = self.conv1(x)
        if self.fused_tail:
            mid = fused_bn_relu_conv2 if self.conv2.stride == 1 else fused_bn_relu_conv2_s2
            y = fused_bn_relu_conv3(self, mid(self, y))
        else:
            y = self.conv2(F.relu(self.bn1(y)))
            y = self.conv3(F.relu(self.bn2(y)))
        y = self.bn3(y)
        res = self.downsample_bn(self.downsample_conv(x)) if self.has_downsample else x
        return F.relu(res + y)


class ResNet(nn.Module):
    """ResNet encoder of RGB images ending in a `num_classes`-dim `fc` head
    (the MoCo embedding), or the v2 MLP head `fc_hidden -> ReLU -> fc` with
    `mlp_head=True`; `num_classes=None` has no head and returns the pooled
    f32 backbone features (`feature_dim` wide: the linear probe's and the
    kNN bank's input). `fused_bn_conv=True` fuses the blocks' interior
    bn -> relu -> conv passes (`fused_tail`), unless `bn_group` syncs the
    BNs over a process group."""

    def __init__(self, stage_sizes, block_cls, num_classes: int | None = 128,
                 mlp_head: bool = False, cifar_stem: bool = False, width: int = 64,
                 dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None, fused_bn_conv: bool = False,
                 bn_group=None):
        super().__init__()
        fused_tail = fused_bn_conv and bn_group is None
        self.dtype = dtype
        self.cifar_stem = cifar_stem
        if cifar_stem:
            self.conv1 = Conv(3, width, 3, 1, 1, dtype)
        else:
            self.conv1 = Conv(3, width, 7, 2, 3, dtype)
        self.bn1 = FastBatchNorm(width, group=bn_group)
        cin = width
        self.block_names = []
        for i, num_blocks in enumerate(stage_sizes):
            for j in range(num_blocks):
                stride = 2 if i > 0 and j == 0 else 1
                name = f"layer{i + 1}_{j}"
                block = block_cls(cin, width * 2**i, stride, dtype, fused_tail=fused_tail,
                                  bn_group=bn_group)
                self.add_module(name, block)
                self.block_names.append(name)
                cin = width * 2**i * block_cls.expansion
        self.feature_dim = cin
        self.num_classes = num_classes
        self.mlp_head = mlp_head and num_classes is not None
        if self.mlp_head:
            self.fc_hidden = nn.Linear(cin, cin)
        if num_classes is not None:
            self.fc = nn.Linear(cin, num_classes)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.reset_parameters(generator)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """flax's initializers, drawn in module order from `generator`."""
        for mod in self.modules():
            if isinstance(mod, Conv):
                mod.reset_parameters(generator)
            elif isinstance(mod, nn.Linear):
                lecun_normal_(mod.weight, mod.in_features, generator)
                with torch.no_grad():
                    mod.bias.zero_()

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        """images: NHWC [B, H, W, 3] -> [B, num_classes] f32 (the pooled
        [B, feature_dim] features without a head)."""
        x = images.permute(0, 3, 1, 2).to(self.dtype)  # channels_last NCHW view
        x = F.relu(self.bn1(self.conv1(x)))
        if not self.cifar_stem:
            x = F.max_pool2d(x, 3, 2, 1)
        for name in self.block_names:
            x = getattr(self, name)(x)
        x = x.mean(dim=(2, 3)).float()  # global average pool
        if self.num_classes is None:
            return x
        if self.mlp_head:
            x = F.relu(self.fc_hidden(x))
        return self.fc(x)


def _resnet(stage_sizes, block_cls, width=64):
    def build(**kw) -> ResNet:
        kw.setdefault("width", width)
        return ResNet(stage_sizes, block_cls, **kw)

    return build


ARCHS = {
    "resnet18": _resnet((2, 2, 2, 2), BasicBlock),
    "resnet34": _resnet((3, 4, 6, 3), BasicBlock),
    "resnet50": _resnet((3, 4, 6, 3), Bottleneck),
    "resnet101": _resnet((3, 4, 23, 3), Bottleneck),
    "resnet152": _resnet((3, 8, 36, 3), Bottleneck),
    # 2-stage, width-16 micro-ResNet for tests on the CPU
    "resnet_tiny": _resnet((1, 1), BasicBlock, width=16),
}


def build_resnet(arch: str, **kwargs) -> ResNet:
    if arch not in ARCHS:
        raise ValueError(f"unknown arch {arch!r}; choose from {sorted(ARCHS)}")
    return ARCHS[arch](**kwargs)
