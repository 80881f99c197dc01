"""Vision Transformer backbone of MoCo v3 (port of `moco_tpu/models/vit.py`).

ViT-S/16 is 12 blocks of width 384 with 12 heads of 32 (moco-v3's
`vit_small`, not timm's 6 heads); at 224 px, 14 x 14 = 196 patch tokens and
a class token. The flax module names are kept, so `weights.params_from_jax`
maps path to path: `patch_embed`, `cls_token`, `block{i}.norm1`,
`block{i}.attn.{query,key,value,out}`, `block{i}.norm2`, `block{i}.mlp_fc1`,
`block{i}.mlp_fc2`, `norm` (and `head` with `num_classes`).

flax's conventions, kept:

- `forward` takes the port's NHWC batch. Parameters are f32 and cast to the
  compute dtype at use; the class-token feature and the head are f32.
- LayerNorm: epsilon 1e-6, statistics and normalization in f32, the output
  in the compute dtype.
- Attention keeps flax's parameter layouts: `query/key/value.weight`
  [D, H, hd] with bias [H, hd], `out.weight` [H, hd, D]. The query is
  divided by sqrt(head dim) (in the compute dtype) before the q.k product;
  the scores and the weighted sum are two batched matmuls around a softmax,
  as the JAX package computes them (no fused attention kernel there, and
  none here).
- The MLP's GELU is the exact erf form.
- The position embedding is the fixed 2-D sin-cos grid of `image_size`, a
  buffer outside the state_dict (another input size computes its own grid,
  as the JAX model does on every call); `cls_token` is drawn from
  normal(1e-6).
- `frozen_patch_embed=True` (moco-v3's random patch projection) sets
  `requires_grad=False` on `patch_embed`: no gradient reaches it, and the
  optimizer leaves it out.
- `remat=True` recomputes each block in the backward
  (`torch.utils.checkpoint`, non-reentrant): flax's `nn.remat` per block.
"""

from __future__ import annotations

import math
from functools import partial

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from moco_tpu_torch.models.resnet import lecun_normal_


def sincos_2d_position_embedding(h: int, w: int, dim: int) -> torch.Tensor:
    """The fixed 2-D sin-cos embedding [1, h*w, dim] f32 (moco-v3's
    `build_2d_sincos_position_embedding`, temperature 10000)."""
    if dim % 4:
        raise ValueError(f"the sin-cos embedding needs dim divisible by 4, got {dim}")
    grid_h = np.arange(h, dtype=np.float32)
    grid_w = np.arange(w, dtype=np.float32)
    gw, gh = np.meshgrid(grid_w, grid_h)
    pos_dim = dim // 4
    omega = 1.0 / (10000 ** (np.arange(pos_dim, dtype=np.float32) / pos_dim))
    out_w = np.einsum("hw,d->hwd", gw, omega).reshape(h * w, pos_dim)
    out_h = np.einsum("hw,d->hwd", gh, omega).reshape(h * w, pos_dim)
    emb = np.concatenate([np.sin(out_w), np.cos(out_w), np.sin(out_h), np.cos(out_h)],
                         axis=1)
    return torch.from_numpy(emb[None].astype(np.float32))


class LayerNorm(nn.Module):
    """flax `nn.LayerNorm`: `weight`/`bias` are its `scale`/`bias`."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # in f32 from the compute dtype and back (CUDA's layer_norm takes no
        # bf16 input with f32 weights)
        return F.layer_norm(x.float(), (x.shape[-1],), self.weight, self.bias,
                            self.eps).to(x.dtype)


class Dense(nn.Module):
    """A flax `DenseGeneral` weight in flax's layout: `weight` [*in, *out]
    and `bias` [*out]; `in_dims` leading axes contract."""

    def __init__(self, shape: tuple[int, ...], in_dims: int):
        super().__init__()
        self.in_dims = in_dims
        self.weight = nn.Parameter(torch.empty(shape))
        self.bias = nn.Parameter(torch.zeros(shape[in_dims:]))

    def reset_parameters(self, generator: torch.Generator) -> None:
        lecun_normal_(self.weight, math.prod(self.weight.shape[:self.in_dims]), generator)

    def matrix(self, dtype) -> tuple[torch.Tensor, torch.Tensor]:
        """(weight as [in, out], bias as [out]) in `dtype`."""
        k = math.prod(self.weight.shape[:self.in_dims])
        return self.weight.to(dtype).reshape(k, -1), self.bias.to(dtype).reshape(-1)


class Attention(nn.Module):
    """flax `MultiHeadDotProductAttention` (self-attention, no dropout)."""

    def __init__(self, dim: int, num_heads: int, dtype):
        super().__init__()
        if dim % num_heads:
            raise ValueError(f"width {dim} is not a multiple of {num_heads} heads")
        self.num_heads, self.head_dim, self.dtype = num_heads, dim // num_heads, dtype
        self.query = Dense((dim, num_heads, self.head_dim), 1)
        self.key = Dense((dim, num_heads, self.head_dim), 1)
        self.value = Dense((dim, num_heads, self.head_dim), 1)
        self.out = Dense((num_heads, self.head_dim, dim), 2)
        # flax divides by sqrt(head dim) cast to the compute dtype
        self.scale = float(torch.tensor(math.sqrt(self.head_dim)).to(dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, t, d = x.shape
        h, hd = self.num_heads, self.head_dim
        mats = [m.matrix(self.dtype) for m in (self.query, self.key, self.value)]
        w = torch.cat([m[0] for m in mats], dim=1)
        bias = torch.cat([m[1] for m in mats])
        qkv = torch.addmm(bias, x.reshape(b * t, d), w)
        qkv = qkv.view(b, t, 3, h, hd).permute(2, 0, 3, 1, 4)       # [3, B, H, T, hd]
        q, k, v = qkv.unbind(0)
        scores = torch.matmul(q / self.scale, k.transpose(-1, -2))  # [B, H, T, T]
        probs = torch.softmax(scores, dim=-1)
        o = torch.matmul(probs, v).permute(0, 2, 1, 3).reshape(b * t, h * hd)
        w_out, b_out = self.out.matrix(self.dtype)
        return torch.addmm(b_out, o, w_out).view(b, t, d)


class TransformerBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_ratio: float, dtype):
        super().__init__()
        self.dtype = dtype
        self.norm1 = LayerNorm(dim)
        self.attn = Attention(dim, num_heads, dtype)
        self.norm2 = LayerNorm(dim)
        self.mlp_fc1 = nn.Linear(dim, int(dim * mlp_ratio))
        self.mlp_fc2 = nn.Linear(int(dim * mlp_ratio), dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.norm1(x))
        y = self.norm2(x)
        y = F.linear(y, self.mlp_fc1.weight.to(self.dtype), self.mlp_fc1.bias.to(self.dtype))
        y = F.gelu(y, approximate="none")
        y = F.linear(y, self.mlp_fc2.weight.to(self.dtype), self.mlp_fc2.bias.to(self.dtype))
        return x + y


class ViT(nn.Module):
    """ViT encoder: the class-token feature [B, width] f32
    (`num_classes=None`, `feature_dim` wide) or a linear head over it."""

    def __init__(self, patch_size: int = 16, width: int = 384, depth: int = 12,
                 num_heads: int = 12, mlp_ratio: float = 4.0, num_classes: int | None = None,
                 frozen_patch_embed: bool = True, remat: bool = False,
                 dtype: torch.dtype = torch.float32, image_size: int = 224,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.patch_size, self.width, self.depth = patch_size, width, depth
        self.num_heads, self.num_classes = num_heads, num_classes
        self.remat, self.dtype = remat, dtype
        self.feature_dim = width
        self.patch_embed = nn.Conv2d(3, width, patch_size, stride=patch_size)
        self.cls_token = nn.Parameter(torch.empty(1, 1, width))
        self.block_names = []
        for i in range(depth):
            self.add_module(f"block{i}", TransformerBlock(width, num_heads, mlp_ratio, dtype))
            self.block_names.append(f"block{i}")
        self.norm = LayerNorm(width)
        if num_classes is not None:
            self.head = nn.Linear(width, num_classes)
        grid = image_size // patch_size
        self.register_buffer("pos_embed", sincos_2d_position_embedding(grid, grid, width),
                             persistent=False)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.reset_parameters(generator)
        if frozen_patch_embed:
            self.patch_embed.requires_grad_(False)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """flax's initializers, drawn in module order from `generator`."""
        with torch.no_grad():
            for mod in self.modules():
                if isinstance(mod, nn.Conv2d):
                    lecun_normal_(mod.weight, mod.weight[0].numel(), generator)
                    mod.bias.zero_()
                elif isinstance(mod, nn.Linear):
                    lecun_normal_(mod.weight, mod.in_features, generator)
                    mod.bias.zero_()
                elif isinstance(mod, Dense):
                    mod.reset_parameters(generator)
            self.cls_token.normal_(0.0, 1e-6, generator=generator)

    def position_embedding(self, gh: int, gw: int) -> torch.Tensor:
        """The sin-cos grid of a (gh, gw) patch grid in the compute dtype."""
        pos = self.pos_embed
        if pos.shape[1] != gh * gw:
            pos = sincos_2d_position_embedding(gh, gw, self.width).to(pos.device)
        return pos.to(self.dtype)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        """images: NHWC [B, H, W, 3] -> [B, feature_dim] f32 (or the head's
        [B, num_classes])."""
        b, h, w, _ = images.shape
        gh, gw = h // self.patch_size, w // self.patch_size
        x = images.permute(0, 3, 1, 2).to(self.dtype)
        x = F.conv2d(x, self.patch_embed.weight.to(self.dtype),
                     self.patch_embed.bias.to(self.dtype), stride=self.patch_size)
        x = x.permute(0, 2, 3, 1).reshape(b, gh * gw, self.width)
        x = x + self.position_embedding(gh, gw)
        cls = self.cls_token.to(self.dtype).expand(b, 1, self.width)
        x = torch.cat([cls, x], dim=1)
        for name in self.block_names:
            block = getattr(self, name)
            if self.remat and torch.is_grad_enabled():
                x = checkpoint(block, x, use_reentrant=False)
            else:
                x = block(x)
        feat = self.norm(x)[:, 0].float()
        if self.num_classes is None:
            return feat
        return self.head(feat)


ViT_Small = partial(ViT, width=384, depth=12, num_heads=12)
ViT_Base = partial(ViT, width=768, depth=12, num_heads=12)
ViT_Large = partial(ViT, width=1024, depth=24, num_heads=16)
ViT_Huge = partial(ViT, width=1280, depth=32, num_heads=16, patch_size=14)
# test arch: moco-v3's 32 per head at width 64
ViT_Tiny = partial(ViT, width=64, depth=2, num_heads=2)

VIT_ARCHS = {"vit_tiny": ViT_Tiny, "vit_small": ViT_Small, "vit_base": ViT_Base,
             "vit_large": ViT_Large, "vit_huge": ViT_Huge}
VIT_FEATURE_DIMS = {"vit_tiny": 64, "vit_small": 384, "vit_base": 768, "vit_large": 1024,
                    "vit_huge": 1280}


def build_vit(arch: str, num_classes: int | None = None, **kwargs) -> ViT:
    if arch not in VIT_ARCHS:
        raise ValueError(f"unknown vit arch {arch!r}; choose from {sorted(VIT_ARCHS)}")
    return VIT_ARCHS[arch](num_classes=num_classes, **kwargs)
