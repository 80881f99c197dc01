"""Analytic-FLOPs MFU estimation (port of `moco_tpu/telemetry/mfu.py`: the
same FLOP counts; the peak table gains the H100).

MFU = achieved FLOP/s ÷ peak FLOP/s. The numerator comes from an ANALYTIC
count of the model's matmul/conv FLOPs (the standard convention: 2 FLOPs
per multiply-add, convs + dense layers only — BN/activations/pooling are
bandwidth, not FLOPs, and would flatter the number), scaled by the MoCo
step's encoder-pass structure:

  v1/v2 — query encoder forward+backward (3 fwd-equivalents, the standard
          1+2 fwd/bwd accounting) + key encoder forward (1): 4× per image
  v3    — BOTH crops through both encoders: query fwd+bwd on 2 crops (6)
          + momentum forward on 2 crops (2): 8× per image

Projection heads ARE counted (they are dense layers); the v3
predictor/projector MLPs beyond the configured head are not — they are
<0.5% of a ResNet-50/ViT step and the estimate documents itself as
backbone-dominated via `flops_per_image` in the run_start record.

The denominator is a per-chip peak-FLOPs table keyed on the device's name
(`torch.cuda.get_device_name`; the TPU rows keep the JAX table's
`device_kind` names), overridable via `config.peak_flops_per_chip` — the
only honest option on the CPU or unlisted hardware, where detection
yields None and MFU is omitted rather than fabricated.
"""

from __future__ import annotations

# (substring of the device name lowercased, peak bf16 FLOP/s per chip).
# Ordered: more specific entries first — "h100 pcie" must win over "h100",
# "v5p" over "v5". The NVIDIA rows are the dense bf16 tensor-core peaks
# (without sparsity) of NVIDIA's H100 Tensor Core GPU datasheet: H100 SXM
# 989.4 TFLOP/s (torch reports it as "NVIDIA H100 80GB HBM3"), H100 PCIe
# 756 TFLOP/s. The TPU rows are the JAX package's (Cloud TPU docs).
PEAK_FLOPS_BF16 = (
    ("h100 pcie", 756e12),
    ("h100", 989.4e12),
    ("v6e", 918e12),
    ("v5p", 459e12),
    ("v5e", 197e12),
    ("v5 lite", 197e12),   # some jax versions report v5e as "TPU v5 lite"
    ("v4", 275e12),
    ("v3", 123e12),
    ("v2", 45e12),
)


def detect_peak_flops(device_kind: str) -> float | None:
    """Peak bf16 FLOP/s for a device name, None if unknown (the CPU, any
    other GPU) — callers must then rely on the config override or skip
    MFU."""
    kind = (device_kind or "").lower()
    for key, peak in PEAK_FLOPS_BF16:
        if key in kind:
            return peak
    return None


def _conv_flops(h_out: int, w_out: int, k: int, c_in: int, c_out: int) -> float:
    return 2.0 * h_out * w_out * k * k * c_in * c_out


def _conv_out(size: int, k: int, stride: int, pad: int) -> int:
    return (size + 2 * pad - k) // stride + 1


# mirrors models/resnet.py: (stage_sizes, bottleneck?, width)
_RESNET_SPECS = {
    "resnet18": ((2, 2, 2, 2), False, 64),
    "resnet34": ((3, 4, 6, 3), False, 64),
    "resnet50": ((3, 4, 6, 3), True, 64),
    "resnet101": ((3, 4, 23, 3), True, 64),
    "resnet152": ((3, 8, 36, 3), True, 64),
    "resnet_tiny": ((1, 1), False, 16),
}

# mirrors models/vit.py: (width, depth, patch_size)
FEATURE_DIMS = {"resnet18": 512, "resnet34": 512, "resnet50": 2048, "resnet101": 2048,
                "resnet152": 2048, "resnet_tiny": 32}

_VIT_SPECS = {
    "vit_small": (384, 12, 16),
    "vit_base": (768, 12, 16),
    "vit_large": (1024, 24, 16),
    "vit_huge": (1280, 32, 14),
    "vit_tiny": (64, 2, 16),
}


def resnet_fwd_flops(arch: str, image_size: int, cifar_stem: bool = False) -> float:
    """Forward conv FLOPs per image for the flax ResNet in models/resnet.py
    (2·H·W·K²·Cin·Cout per conv, including downsample projections;
    excludes BN/ReLU/pool and any head — see head_fwd_flops)."""
    stage_sizes, bottleneck, width = _RESNET_SPECS[arch]
    flops = 0.0
    if cifar_stem:
        size = image_size  # 3x3/1 conv, no pool
        flops += _conv_flops(size, size, 3, 3, width)
    else:
        size = _conv_out(image_size, 7, 2, 3)
        flops += _conv_flops(size, size, 7, 3, width)
        size = _conv_out(size, 3, 2, 1)  # max-pool: no FLOPs, changes size
    expansion = 4 if bottleneck else 1
    c_in = width
    for i, num_blocks in enumerate(stage_sizes):
        filters = width * 2**i
        c_out = filters * expansion
        for j in range(num_blocks):
            stride = 2 if i > 0 and j == 0 else 1
            out_size = _conv_out(size, 3, stride, 1)
            if bottleneck:
                flops += _conv_flops(size, size, 1, c_in, filters)          # conv1 1x1
                flops += _conv_flops(out_size, out_size, 3, filters, filters)  # conv2 3x3/s
                flops += _conv_flops(out_size, out_size, 1, filters, c_out)    # conv3 1x1
            else:
                flops += _conv_flops(out_size, out_size, 3, c_in, filters)  # conv1 3x3/s
                flops += _conv_flops(out_size, out_size, 3, filters, filters)  # conv2 3x3
            if stride != 1 or c_in != c_out:  # downsample projection
                flops += _conv_flops(out_size, out_size, 1, c_in, c_out)
            c_in, size = c_out, out_size
    return flops


def vit_fwd_flops(arch: str, image_size: int) -> float:
    """Forward matmul FLOPs per image for the flax ViT in models/vit.py:
    patch embed + per-block (qkv, scores, attn·V, proj, 4x MLP); excludes
    LayerNorm/GELU and any head."""
    width, depth, patch = _VIT_SPECS[arch]
    grid = image_size // patch
    n = grid * grid + 1  # patch tokens + class token
    d = width
    flops = 2.0 * (grid * grid) * (patch * patch * 3) * d  # patch embed conv
    per_block = (
        2.0 * n * d * (3 * d)      # qkv projection
        + 2.0 * n * n * d          # Q·Kᵀ scores
        + 2.0 * n * n * d          # scores·V
        + 2.0 * n * d * d          # output projection
        + 2.0 * 2 * n * d * (4 * d)  # MLP fc1 + fc2 (ratio 4)
    )
    return flops + depth * per_block


def head_fwd_flops(arch: str, embed_dim: int, mlp_head: bool) -> float:
    """Projection-head dense FLOPs per image (fc, or the v2 2-layer MLP)."""
    if arch in _VIT_SPECS:
        feat = _VIT_SPECS[arch][0]
    else:
        feat = FEATURE_DIMS[arch]
    if mlp_head:
        return 2.0 * feat * feat + 2.0 * feat * embed_dim
    return 2.0 * feat * embed_dim


def model_fwd_flops(arch: str, image_size: int, *, cifar_stem: bool = False,
                    embed_dim: int = 128, mlp_head: bool = False) -> float:
    """Backbone + head forward FLOPs per image for any supported arch."""
    if arch in _VIT_SPECS:
        body = vit_fwd_flops(arch, image_size)
    elif arch in _RESNET_SPECS:
        body = resnet_fwd_flops(arch, image_size, cifar_stem)
    else:
        raise ValueError(f"no analytic FLOPs model for arch {arch!r}")
    return body + head_fwd_flops(arch, embed_dim, mlp_head)


# fwd-equivalent encoder passes per image: fwd+bwd = 3 fwd (standard 1+2
# accounting), momentum fwd = 1
_STEP_MULTIPLIER = {"v1": 3 + 1, "v2": 3 + 1, "v3": 2 * 3 + 2 * 1}


def train_step_flops(config) -> float:
    """Analytic FLOPs for ONE global-batch training step of `config`."""
    per_image = model_fwd_flops(
        config.arch, config.image_size, cifar_stem=config.cifar_stem,
        embed_dim=config.embed_dim, mlp_head=config.mlp_head,
    )
    return per_image * _STEP_MULTIPLIER[config.variant] * config.batch_size


class MFUEstimator:
    """step wall time → model-FLOPs utilization fraction.

    `peak_flops_per_chip` None/0 disables (mfu() returns None) — never
    fabricate a denominator."""

    def __init__(self, flops_per_step: float, n_chips: int,
                 peak_flops_per_chip: float | None, sharding: str = "dp"):
        self.flops_per_step = float(flops_per_step)
        self.n_chips = max(int(n_chips), 1)
        self.peak_flops_per_chip = (
            float(peak_flops_per_chip) if peak_flops_per_chip else None
        )
        # the sharding mode the MFU is reported under: the analytic FLOPs
        # are layout-invariant, so the estimator carries the label rather
        # than a different count
        self.sharding = sharding

    @classmethod
    def for_config(cls, config, n_chips: int, device_kind: str = ""):
        peak = config.peak_flops_per_chip or detect_peak_flops(device_kind)
        return cls(train_step_flops(config), n_chips, peak,
                   sharding=getattr(config, "sharding", "dp"))

    def mfu(self, step_s: float) -> float | None:
        if not self.peak_flops_per_chip or step_s <= 0:
            return None
        achieved = self.flops_per_step / step_s
        return achieved / (self.peak_flops_per_chip * self.n_chips)
