"""Crop + antialiased bilinear resize as two batched matmuls (port of
`moco_tpu/ops/matmul_resize.py`).

    out[b, :, :, c] = Rv[b] @ img[b, :, :, c] @ Rh[b]^T

with per-sample interpolation matrices whose rows hold the triangle-filter
weights of one output coordinate (support widened by the minification
factor: antialiased, as PIL resizes; renormalized over in-bounds taps). A
flip reverses the matrix rows instead of the image. Where a sample's
content fills only the top-left `[valid_h, valid_w]` of the canvas (an
ImageFolder staging canvas), taps at or beyond the valid size are masked
out and the row renormalized: the boundary handling a tightly-sized image
would get.
"""

from __future__ import annotations

import torch


def interp_matrix(src_size: int, out_size: int, crop_start: torch.Tensor,
                  crop_size: torch.Tensor, valid_size: torch.Tensor | None = None
                  ) -> torch.Tensor:
    """[B, out_size, src_size] row-stochastic weights mapping each sample's
    window [crop_start, crop_start + crop_size) onto out_size samples; with
    `valid_size` [B], only source rows below it carry weight."""
    dev = crop_start.device
    crop_start = crop_start.float()
    scale = crop_size.float() / out_size                                   # [B]
    o = torch.arange(out_size, dtype=torch.float32, device=dev)
    pos = crop_start[:, None] + (o[None, :] + 0.5) * scale[:, None] - 0.5   # [B, O]
    idx = torch.arange(src_size, dtype=torch.float32, device=dev)
    support = torch.clamp(scale, min=1.0)
    dist = (pos[:, :, None] - idx).abs() / support[:, None, None]
    w = torch.clamp(1.0 - dist, min=0.0)
    if valid_size is not None:
        w = w * (idx < valid_size.float()[:, None, None])
    return w / torch.clamp(w.sum(dim=2, keepdim=True), min=1e-8)


def crop_resize(img: torch.Tensor, y0: torch.Tensor, x0: torch.Tensor,
                crop_h: torch.Tensor, crop_w: torch.Tensor, out_size: int,
                flip_h: torch.Tensor | None = None, flip_v: torch.Tensor | None = None,
                valid_h: torch.Tensor | None = None, valid_w: torch.Tensor | None = None
                ) -> torch.Tensor:
    """Resample each box [y0:y0+crop_h, x0:x0+crop_w] of `img` [B, H, W, C]
    to [B, out, out, C] in the image dtype, its columns reversed where
    `flip_h` [B] is set and its rows where `flip_v` is; content limited to
    `[valid_h, valid_w]` [B] where given. The matrices are cast to the
    image dtype; each matmul accumulates in f32 and rounds once."""
    b, h, w, c = img.shape
    rv = interp_matrix(h, out_size, y0, crop_h, valid_h)
    rh = interp_matrix(w, out_size, x0, crop_w, valid_w)
    if flip_v is not None:
        rv = torch.where(flip_v[:, None, None], rv.flip(1), rv)
    if flip_h is not None:
        rh = torch.where(flip_h[:, None, None], rh.flip(1), rh)
    rv = rv.to(img.dtype)
    rh = rh.to(img.dtype)
    # [B,O,H] @ [B,H,W*C] -> [B,O,W,C]
    tmp = torch.matmul(rv, img.reshape(b, h, w * c)).view(b, out_size, w, c)
    # contract W: [B,P,W] @ [B,W,O*C] -> [B,P,O,C] -> [B,O,P,C]
    tmp = tmp.permute(0, 2, 1, 3).reshape(b, w, out_size * c)
    out = torch.matmul(rh, tmp).view(b, out_size, out_size, c)
    return out.permute(0, 2, 1, 3).contiguous()
