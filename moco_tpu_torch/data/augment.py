"""On-device MoCo augmentation (port of `moco_tpu/data/augment.py`).

The host stages uint8 images; every random transform runs on the device,
batched, in two separate steps:

1. `sample_view` draws one view's parameters for the whole batch from a
   `torch.Generator` (crop boxes by torchvision's 10-trial rule, flips,
   jitter factors/order/apply flags, grayscale flags, blur taps);
2. `apply_view` applies them with deterministic functions, which the tests
   hold against the JAX package's on the same parameters.

Recipes (`aug_config_for`): v1 = RRC(0.2-1) + grayscale .2 BEFORE jitter
(.4,.4,.4,.4) always + flip; v2 `--aug-plus` = RRC + jitter (.4,.4,.4,.1)
p=.8 + grayscale .2 + blur sigma U(.1,2) p=.5 + flip; v3 = an ASYMMETRIC
pair (`v3_aug_configs`): RRC(crop_min-1) + jitter (.4,.4,.2,.1) p=.8 +
grayscale .2 + flip in both views, view 1 blurred always (p=1), view 2
blurred at p=.1 and solarized at p=.2 (`x >= 0.5 -> 1 - x`). Then ImageNet
normalize. The flip is folded into the crop's resample matrix. The blur is
applied by the kernel over the whole batch: last, after normalize, in a
view without solarize (the taps are symmetric and sum to 1, so it commutes
with flip and normalize: the TPU program's order when its Pallas blur is
on); in a solarizing view on the [0, 1] image before solarize and
normalize, since solarize does not commute with it (the JAX package's
in-pipeline order there). The pipeline runs in `AugConfig.dtype` (bf16 for
the ImageNet preset); contrast's mean and the HSV round trip run in f32.

`augment_batch` draws one view a sample (the linear probe's train crop);
with `eval_aug_config` (`deterministic=True`) it draws nothing and takes
the centered square of side `crop_frac * min(h, w)`, the region
resize(256) -> center-crop(224) reads from the original image.

Staging extents: a batch may carry `extents` [B, 3] `(valid_h, valid_w,
rot)` (the ImageFolder canvas): the image fills the top-left `[valid_h,
valid_w]` of the canvas, and `rot = 1` marks a portrait image staged
transposed. The crop is drawn and resampled in staged coordinates over the
valid area and the output transposed back; a horizontal flip of the final
image is a flip of the staged H axis for such samples.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import NamedTuple

import torch

from moco_tpu_torch.ops.blur import blur_radius, blur_weights, gaussian_blur_batch
from moco_tpu_torch.ops.matmul_resize import crop_resize

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class AugConfig(NamedTuple):
    out_size: int = 224
    min_scale: float = 0.2
    max_scale: float = 1.0
    brightness: float = 0.4
    contrast: float = 0.4
    saturation: float = 0.4
    hue: float = 0.4              # v2 uses 0.1
    jitter_prob: float = 1.0      # v2 uses 0.8
    grayscale_prob: float = 0.2
    blur_prob: float = 0.0        # v2 uses 0.5
    blur_sigma: tuple[float, float] = (0.1, 2.0)
    flip_prob: float = 0.5
    solarize_prob: float = 0.0    # v3's second view uses 0.2 (threshold 0.5)
    deterministic: bool = False   # eval: fixed-aspect center crop, no randomness
    grayscale_first: bool = False  # v1 applies RandomGrayscale BEFORE ColorJitter
    rrc_trials: int = 10          # torchvision get_params rejection draws
    crop_frac: float = 0.875      # deterministic: center-crop fraction of min(h, w)
    dtype: str = "float32"


def v1_aug_config(out_size: int = 224) -> AugConfig:
    return AugConfig(out_size=out_size, grayscale_first=True)


def v2_aug_config(out_size: int = 224) -> AugConfig:
    return AugConfig(out_size=out_size, hue=0.1, jitter_prob=0.8, blur_prob=0.5)


def eval_aug_config(out_size: int = 224, crop_frac: float = 0.875) -> AugConfig:
    """The deterministic eval transform: `crop_frac=0.875` is resize(256)
    -> center-crop(224); CIFAR-style protocols evaluate the full image
    (`crop_frac=1.0`, see `default_eval_crop_frac`)."""
    return AugConfig(
        out_size=out_size, crop_frac=crop_frac,
        jitter_prob=0.0, grayscale_prob=0.0, blur_prob=0.0, flip_prob=0.0,
        brightness=0.0, contrast=0.0, saturation=0.0, hue=0.0,
        deterministic=True,
    )


def default_eval_crop_frac(image_size: int) -> float:
    """Small images (CIFAR) evaluate the full image; ImageNet sizes the
    224/256 center crop."""
    return 1.0 if image_size < 96 else 0.875


def v3_aug_configs(out_size: int = 224, min_scale: float = 0.08
                   ) -> tuple[AugConfig, AugConfig]:
    """moco-v3's asymmetric per-view recipes: both views jitter
    (.4,.4,.2,.1) p=.8 + grayscale .2 + flip; view 1 always blurs, view 2
    blurs at p=.1 and solarizes at p=.2. `min_scale` is `--crop-min`."""
    base = AugConfig(out_size=out_size, min_scale=min_scale, saturation=0.2, hue=0.1,
                     jitter_prob=0.8, grayscale_prob=0.2)
    return base._replace(blur_prob=1.0), base._replace(blur_prob=0.1, solarize_prob=0.2)


def aug_config_for(config):
    """The recipe for a PretrainConfig, in the config's compute dtype: v3,
    the `(view 1, view 2)` pair with `crop_min or 0.08`; the v2 stack with
    `aug_plus`; else v1."""
    if config.variant == "v3":
        return tuple(c._replace(dtype=config.compute_dtype) for c in
                     v3_aug_configs(config.image_size, min_scale=config.crop_min or 0.08))
    cfg = v2_aug_config(config.image_size) if config.aug_plus else v1_aug_config(config.image_size)
    return cfg._replace(dtype=config.compute_dtype)


@dataclass
class ViewParams:
    """One view's random draws for a batch of B samples."""

    y0: torch.Tensor              # [B] f32 crop box, source pixels
    x0: torch.Tensor
    crop_h: torch.Tensor
    crop_w: torch.Tensor
    flip: torch.Tensor            # [B] bool horizontal flip
    jitter_factors: torch.Tensor  # [B, 3] f32 brightness/contrast/saturation
    hue_shift: torch.Tensor       # [B] f32
    jitter_perm: torch.Tensor     # [B, 4] int64 order of the four jitter ops
    jitter_apply: torch.Tensor    # [B] bool
    gray_apply: torch.Tensor      # [B] bool
    blur_taps: torch.Tensor       # [B, 2R+1] f32 (identity where skipped)
    valid_h: torch.Tensor | None = None  # [B] staged content extent (None: the canvas)
    valid_w: torch.Tensor | None = None
    rot: torch.Tensor | None = None      # [B] bool, portrait staged transposed
    solarize: torch.Tensor | None = None  # [B] bool (None: a recipe without solarize)


def _uniform(shape, lo, hi, generator, device) -> torch.Tensor:
    return torch.empty(shape, device=device).uniform_(lo, hi, generator=generator)


def rrc_params(ext_h: torch.Tensor, ext_w: torch.Tensor, cfg: AugConfig,
               generator: torch.Generator):
    """Crop boxes (y0, x0, crop_h, crop_w) [B] with torchvision's
    `RandomResizedCrop.get_params`: `rrc_trials` (area, log-ratio) draws,
    the first that fits wins; if none fits, the image aspect clamped to
    [3/4, 4/3], centered. `cfg.deterministic`: the centered square of side
    `crop_frac * min(h, w)`, with no draw."""
    b, dev, n = ext_h.shape[0], ext_h.device, cfg.rrc_trials
    ext_h, ext_w = ext_h.float(), ext_w.float()
    if cfg.deterministic:
        side = cfg.crop_frac * torch.minimum(ext_h, ext_w)
        return (ext_h - side) / 2.0, (ext_w - side) / 2.0, side, side
    area = (ext_h * ext_w)[:, None] * _uniform((b, n), cfg.min_scale, cfg.max_scale,
                                               generator, dev)
    log_ratio = _uniform((b, n), math.log(3.0 / 4.0), math.log(4.0 / 3.0), generator, dev)
    ratio = torch.exp(log_ratio)
    ws = torch.sqrt(area * ratio)
    hs = torch.sqrt(area / ratio)
    valid = (ws <= ext_w[:, None]) & (hs <= ext_h[:, None]) & (ws >= 1.0) & (hs >= 1.0)
    idx = valid.int().argmax(dim=1, keepdim=True)  # first accepted draw
    ok = valid.any(dim=1)
    in_ratio = ext_w / ext_h
    fb_w = torch.where(in_ratio > 4.0 / 3.0, ext_h * (4.0 / 3.0), ext_w)
    fb_h = torch.where(in_ratio < 0.75, ext_w / 0.75, ext_h)
    cw = torch.where(ok, ws.gather(1, idx)[:, 0], fb_w)
    ch = torch.where(ok, hs.gather(1, idx)[:, 0], fb_h)
    uy = torch.rand(b, device=dev, generator=generator)
    ux = torch.rand(b, device=dev, generator=generator)
    y0 = torch.where(ok, uy * (ext_h - ch), (ext_h - ch) / 2.0)
    x0 = torch.where(ok, ux * (ext_w - cw), (ext_w - cw) / 2.0)
    return y0, x0, ch, cw


def sample_view(ext_h: torch.Tensor, ext_w: torch.Tensor, cfg: AugConfig,
                generator: torch.Generator, rot: torch.Tensor | None = None
                ) -> ViewParams:
    """Draw one view's parameters for a batch whose images have extents
    (ext_h, ext_w) [B] (and `rot` [B] bool, staged transposed), on the
    generator's device. The extents ride along in the parameters. A
    `deterministic` config draws nothing (`generator` may be None): no
    flip, and every other transform off."""
    b, dev = ext_h.shape[0], ext_h.device
    y0, x0, ch, cw = rrc_params(ext_h, ext_w, cfg, generator)
    if cfg.deterministic:
        off = torch.zeros(b, dtype=torch.bool, device=dev)
        return ViewParams(y0, x0, ch, cw, off, torch.ones(b, 3, device=dev),
                          torch.zeros(b, device=dev),
                          torch.arange(4, device=dev).expand(b, 4), off, off,
                          torch.zeros(b, 0, device=dev), ext_h, ext_w, rot)
    flip = torch.rand(b, device=dev, generator=generator) < cfg.flip_prob
    # torchvision samples each factor from U(max(0, 1-x), 1+x)
    factors = torch.stack([
        _uniform((b,), max(0.0, 1.0 - x), 1.0 + x, generator, dev)
        for x in (cfg.brightness, cfg.contrast, cfg.saturation)
    ], dim=1)
    hue_shift = _uniform((b,), -cfg.hue, cfg.hue, generator, dev)
    # a uniform permutation of the four ops per sample (torchvision's randperm(4))
    perm = torch.argsort(torch.rand((b, 4), device=dev, generator=generator), dim=1)
    jitter_apply = torch.rand(b, device=dev, generator=generator) < cfg.jitter_prob
    gray_apply = torch.rand(b, device=dev, generator=generator) < cfg.grayscale_prob
    taps = blur_weights(b, blur_radius(cfg.out_size), cfg.blur_sigma, cfg.blur_prob,
                        generator, dev)
    # drawn only by a solarizing recipe: the v1/v2 draws stay as they were
    solarize = (torch.rand(b, device=dev, generator=generator) < cfg.solarize_prob
                if cfg.solarize_prob > 0 else None)
    return ViewParams(y0, x0, ch, cw, flip, factors, hue_shift, perm, jitter_apply,
                      gray_apply, taps, ext_h, ext_w, rot, solarize)


# ---------------------------------------------------------------------------
# deterministic transforms over NHWC batches [B, H, W, 3] in [0, 1]
# ---------------------------------------------------------------------------


def _per_sample(v: torch.Tensor) -> torch.Tensor:
    return v.view(-1, 1, 1, 1)


_LUMA = (0.299, 0.587, 0.114)
# the weights as the image dtype holds them: the JAX package's are
# weak-typed constants, rounded to the pipeline dtype (bf16: 0.298828125,
# 0.5859375, 0.11376953125) before they multiply
_LUMA_IN = {dt: tuple(float(torch.tensor(w).to(dt)) for w in _LUMA) for dt in _DTYPES.values()}


def grayscale(img: torch.Tensor) -> torch.Tensor:
    """ITU-R 601-2 luma (PIL's 'L'), [B, H, W] in the image dtype, with the
    weights rounded to that dtype."""
    wr, wg, wb = _LUMA_IN[img.dtype]
    return img[..., 0] * wr + img[..., 1] * wg + img[..., 2] * wb


def rgb_to_hsv(rgb: torch.Tensor) -> torch.Tensor:
    r, g, b = rgb.unbind(-1)
    maxc = rgb.amax(dim=-1)
    minc = rgb.amin(dim=-1)
    delta = maxc - minc
    safe_delta = torch.where(delta == 0, 1.0, delta)
    s = torch.where(maxc == 0, 0.0, delta / torch.where(maxc == 0, 1.0, maxc))
    rc = (maxc - r) / safe_delta
    gc = (maxc - g) / safe_delta
    bc = (maxc - b) / safe_delta
    h = torch.where(maxc == r, bc - gc,
                    torch.where(maxc == g, 2.0 + rc - bc, 4.0 + gc - rc))
    h = torch.where(delta == 0, 0.0, h / 6.0) % 1.0
    return torch.stack([h, s, maxc], dim=-1)


def hsv_to_rgb(hsv: torch.Tensor) -> torch.Tensor:
    h, s, v = hsv.unbind(-1)
    i = torch.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    i = i.long() % 6

    def pick(c0, c1, c2, c3, c4, c5):
        return torch.where(i == 0, c0, torch.where(i == 1, c1, torch.where(
            i == 2, c2, torch.where(i == 3, c3, torch.where(i == 4, c4, c5)))))

    return torch.stack([pick(v, q, p, p, t, v), pick(t, v, v, q, p, p),
                        pick(p, p, t, v, v, q)], dim=-1)


def _blend_op(x, op, active, factors):
    """One of brightness (op 0), contrast (1), saturation (2) per sample:
    `clip(f*x + (1-f)*m)` with m = 0, mean gray, gray; `f = 1` where the
    slot is inactive."""
    g = grayscale(x)
    mean_g = g.float().mean(dim=(1, 2)).to(x.dtype)
    m = torch.where(_per_sample(op == 2), g[..., None],
                    torch.where(_per_sample(op == 1), _per_sample(mean_g), 0.0))
    f = torch.where(active, factors.gather(1, op[:, None])[:, 0], 1.0).to(x.dtype)
    f = _per_sample(f)
    return torch.clamp(f * x + (1.0 - f) * m, 0.0, 1.0)


def _hue(x, shift):
    hsv = rgb_to_hsv(x.float())
    h = (hsv[..., 0] + shift[:, None, None]) % 1.0
    return hsv_to_rgb(torch.stack([h, hsv[..., 1], hsv[..., 2]], dim=-1)).to(x.dtype)


def color_jitter(img: torch.Tensor, factors: torch.Tensor, hue_shift: torch.Tensor,
                 perm: torch.Tensor, use_hue: bool = True) -> torch.Tensor:
    """ColorJitter with each sample's op order `perm` (op ids 0..3 =
    brightness, contrast, saturation, hue). The three blends before hue run,
    then hue once, then the blends after it."""
    b = img.shape[0]
    slots = torch.arange(4, device=img.device).expand(b, 4)
    cheap_pos = torch.argsort(torch.where(perm == 3, 99, slots), dim=1)[:, :3]
    cheap_ops = perm.gather(1, cheap_pos)         # blend op ids in chain order
    hue_rank = (perm == 3).int().argmax(dim=1)    # blends that precede hue
    out = img
    for j in range(3):
        out = _blend_op(out, cheap_ops[:, j], j < hue_rank, factors)
    if use_hue:
        out = _hue(out, hue_shift)
    for j in range(3):
        out = _blend_op(out, cheap_ops[:, j], j >= hue_rank, factors)
    return out


def solarize(img: torch.Tensor, apply: torch.Tensor) -> torch.Tensor:
    """torchvision RandomSolarize(threshold=128) on [0, 1] images: pixels
    >= 0.5 inverted, in the samples where `apply` [B] is set."""
    return torch.where(_per_sample(apply) & (img >= 0.5), 1.0 - img, img)


def normalize(img: torch.Tensor) -> torch.Tensor:
    """(img - mean) / std with the ImageNet constants in the image dtype."""
    mean = torch.tensor(IMAGENET_MEAN, dtype=torch.float32, device=img.device)
    inv_std = torch.tensor(IMAGENET_STD, dtype=torch.float32, device=img.device).reciprocal()
    return (img - mean.to(img.dtype)) * inv_std.to(img.dtype)


def apply_view(images_u8: torch.Tensor, p: ViewParams, cfg: AugConfig) -> torch.Tensor:
    """uint8 [B, H, W, 3] -> [B, S, S, 3] in `cfg.dtype`, given the draws."""
    img = images_u8.to(_DTYPES[cfg.dtype]) / 255.0
    flip_h, flip_v = p.flip, None
    if p.rot is not None:
        # a horizontal flip of the final image flips the staged H axis of a
        # sample staged transposed
        flip_h, flip_v = p.flip & ~p.rot, p.flip & p.rot
    img = crop_resize(img, p.y0, p.x0, p.crop_h, p.crop_w, cfg.out_size, flip_h, flip_v,
                      p.valid_h, p.valid_w)
    if p.rot is not None:
        img = torch.where(_per_sample(p.rot), img.transpose(1, 2), img).contiguous()

    def jitter(x):
        out = color_jitter(x, p.jitter_factors, p.hue_shift, p.jitter_perm, cfg.hue > 0)
        return torch.where(_per_sample(p.jitter_apply), out, x)

    def gray(x):
        return torch.where(_per_sample(p.gray_apply), grayscale(x)[..., None], x)

    stages = [(cfg.grayscale_prob, gray), (cfg.jitter_prob, jitter)]
    if not cfg.grayscale_first:
        stages.reverse()
    for prob, fn in stages:
        if prob > 0:
            img = fn(img)
    if cfg.solarize_prob > 0:
        # solarize does not commute with the blur: blur the [0, 1] image first
        if cfg.blur_prob > 0:
            img = gaussian_blur_batch(img, p.blur_taps, blur_radius(cfg.out_size))
        return normalize(solarize(img, p.solarize))
    img = normalize(img)
    if cfg.blur_prob > 0:
        img = gaussian_blur_batch(img, p.blur_taps, blur_radius(cfg.out_size))
    return img


def _split_extents(images_u8: torch.Tensor, extents: torch.Tensor | None):
    """(ext_h, ext_w, rot) [B] of a batch; None extents cover the canvas."""
    b, h, w, _ = images_u8.shape
    if extents is None:
        ext_h = torch.full((b,), float(h), device=images_u8.device)
        ext_w = torch.full((b,), float(w), device=images_u8.device)
        return ext_h, ext_w, None
    return extents[:, 0].float(), extents[:, 1].float(), extents[:, 2] > 0


def augment_batch(images_u8: torch.Tensor, generator: torch.Generator | None,
                  cfg: AugConfig, extents: torch.Tensor | None = None) -> torch.Tensor:
    """uint8 [B, H, W, 3] -> [B, S, S, 3]: one view, one draw per sample
    from `generator` (None for a `deterministic` config); `extents` as in
    `two_crops`."""
    ext_h, ext_w, rot = _split_extents(images_u8, extents)
    return apply_view(images_u8, sample_view(ext_h, ext_w, cfg, generator, rot), cfg)


def _rows_of(p: ViewParams, lo: int, n: int) -> ViewParams:
    """Rows [lo, lo + n) of every per-sample draw."""
    return ViewParams(**{f.name: None if getattr(p, f.name) is None
                         else getattr(p, f.name)[lo:lo + n] for f in dataclasses.fields(p)})


def _placed(v: torch.Tensor | None, lo: int, total: int) -> torch.Tensor | None:
    """`v` as rows [lo, lo + len(v)) of a `total`-row tensor of ones."""
    if v is None:
        return None
    out = v.new_ones((total,) + tuple(v.shape[1:]))
    out[lo:lo + v.shape[0]] = v
    return out


def two_crops(images_u8: torch.Tensor, cfg, generator: torch.Generator,
              extents: torch.Tensor | None = None, rows: tuple[int, int] | None = None
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Two independent views (query, key; v3's view 1, view 2) of a uint8
    batch; `cfg` is one AugConfig for both views or a `(cfg_view1,
    cfg_view2)` pair (v3); `extents` [B, 3] `(valid_h, valid_w, rot)` on
    the batch's device, None for the full canvas.

    `rows=(offset, global_batch)`: the batch is rows [offset, offset + B)
    of a global batch split over processes. The draws are made for the
    whole global batch from `generator` (seeded and advanced alike on
    every process) and each process keeps its rows, as the JAX step draws
    the global batch's views with one key: the crops do not depend on how
    many processes share the batch."""
    cfgs = (cfg, cfg) if isinstance(cfg, AugConfig) else tuple(cfg)
    ext_h, ext_w, rot = _split_extents(images_u8, extents)
    if rows is None:
        views = [sample_view(ext_h, ext_w, c, generator, rot) for c in cfgs]
    else:
        lo, total = rows
        placed = [_placed(v, lo, total) for v in (ext_h, ext_w, rot)]
        views = [_rows_of(sample_view(*placed[:2], c, generator, placed[2]), lo,
                          images_u8.shape[0]) for c in cfgs]
    return (apply_view(images_u8, views[0], cfgs[0]),
            apply_view(images_u8, views[1], cfgs[1]))
