"""The port's augmentation against the JAX package's, piece by piece on the
same sampled parameters (f32), and the port's samplers by their statistics.

The two frameworks draw different random numbers, so each deterministic
transform gets identical numpy parameters on both sides; the samplers are
checked against the distributions they must draw from.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moco_tpu.data import augment as jaug
from moco_tpu.ops import matmul_resize as jresize
from moco_tpu_torch.data import augment as aug
from moco_tpu_torch.ops import matmul_resize as resize

# f32 transforms in the same op order; matmul sums in another order: ~1e-6
TOL = dict(rtol=1e-5, atol=2e-6)


def _crop_params(rng, b, h, w):
    ch = rng.uniform(4, h, b).astype(np.float32)
    cw = rng.uniform(4, w, b).astype(np.float32)
    y0 = (rng.uniform(0, 1, b) * (h - ch)).astype(np.float32)
    x0 = (rng.uniform(0, 1, b) * (w - cw)).astype(np.float32)
    return y0, x0, ch, cw


def test_interp_matrix_matches_jax():
    rng = np.random.RandomState(0)
    y0, _, ch, _ = _crop_params(rng, 5, 40, 40)
    ch[0] = 10.0  # magnification: the triangle's support stays 1 pixel
    ref = jax.vmap(lambda s, c: jresize.interp_matrix(40, 16, s, c, True))(y0, ch)
    got = resize.interp_matrix(40, 16, torch.from_numpy(y0), torch.from_numpy(ch))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_crop_resize_with_flips_matches_jax():
    rng = np.random.RandomState(1)
    b, h, w, s = 6, 24, 32, 16
    img = rng.rand(b, h, w, 3).astype(np.float32)
    y0, x0, ch, cw = _crop_params(rng, b, h, w)
    flip = np.array([0, 1, 0, 1, 1, 0], bool)
    ref = jax.vmap(lambda im, a, c, d, e, f: jresize.crop_resize(
        im, a, c, d, e, s, True, flip_h=f))(img, y0, x0, ch, cw, flip)
    t = torch.from_numpy
    got = resize.crop_resize(t(img), t(y0), t(x0), t(ch), t(cw), s, t(flip))
    assert got.shape == (b, s, s, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    unflipped = resize.crop_resize(t(img), t(y0), t(x0), t(ch), t(cw), s, t(~flip))
    np.testing.assert_allclose(got.numpy()[1], unflipped.numpy()[1][:, ::-1], **TOL)


def _jitter_params(rng, b):
    factors = rng.uniform(0.6, 1.4, (b, 3)).astype(np.float32)
    hue = rng.uniform(-0.4, 0.4, b).astype(np.float32)
    perm = np.stack([rng.permutation(4) for _ in range(b)]).astype(np.int64)
    return factors, hue, perm


@pytest.mark.parametrize("use_hue", [True, False])
def test_color_jitter_matches_jax_reference_order(use_hue):
    """The port's batched jitter equals the JAX package's sequential
    reference (`_apply_jitter_ops`, one `lax.switch` per slot) for every
    sample's own op order."""
    rng = np.random.RandomState(2)
    b = 24
    img = rng.rand(b, 8, 8, 3).astype(np.float32)
    factors, hue, perm = _jitter_params(rng, b)
    ref = jax.vmap(lambda im, f, hs, p: jaug._apply_jitter_ops(
        im, (f[0], f[1], f[2]), hs, p, use_hue))(img, factors, hue, perm.astype(np.int32))
    got = aug.color_jitter(torch.from_numpy(img), torch.from_numpy(factors),
                           torch.from_numpy(hue), torch.from_numpy(perm), use_hue)
    # the HSV round trip's divisions and floor: ~1e-6 in f32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


def test_hsv_round_trip_matches_jax():
    rng = np.random.RandomState(3)
    rgb = rng.rand(4, 6, 6, 3).astype(np.float32)
    rgb[0, 0, 0] = [0.5, 0.5, 0.5]  # gray: zero saturation, hue 0
    rgb[0, 0, 1] = [0.0, 0.0, 0.0]
    hsv_j = np.asarray(jaug._rgb_to_hsv(jnp.asarray(rgb)))
    hsv_t = aug.rgb_to_hsv(torch.from_numpy(rgb))
    np.testing.assert_allclose(hsv_t.numpy(), hsv_j, **TOL)
    np.testing.assert_allclose(aug.hsv_to_rgb(hsv_t).numpy(),
                               np.asarray(jaug._hsv_to_rgb(jnp.asarray(hsv_j))), **TOL)


def test_grayscale_and_normalize_match_jax():
    rng = np.random.RandomState(4)
    img = rng.rand(3, 5, 5, 3).astype(np.float32)
    np.testing.assert_allclose(aug.grayscale(torch.from_numpy(img)).numpy(),
                               np.asarray(jaug._grayscale(jnp.asarray(img))), **TOL)
    ref = (img - jaug.IMAGENET_MEAN) * jaug.IMAGENET_INV_STD
    np.testing.assert_allclose(aug.normalize(torch.from_numpy(img)).numpy(), ref, **TOL)


def test_apply_view_composes_the_jax_pieces():
    """A whole v2 view from fixed draws equals the same pieces composed from
    the JAX package's functions: crop (with flip), jitter where applied,
    grayscale where applied, normalize, blur."""
    from moco_tpu.ops.pallas_blur import gaussian_blur_batch as jblur

    rng = np.random.RandomState(5)
    b, size, out = 6, 20, 12
    u8 = rng.randint(0, 256, (b, size, size, 3), dtype=np.uint8)
    cfg = aug.v2_aug_config(out)
    y0, x0, ch, cw = _crop_params(rng, b, size, size)
    factors, hue, perm = _jitter_params(rng, b)
    flip = np.array([1, 0, 1, 0, 1, 0], bool)
    jit_on = np.array([1, 1, 0, 1, 0, 1], bool)
    gray_on = np.array([0, 1, 1, 0, 0, 0], bool)
    radius = aug.blur_radius(out)
    taps = aug.blur_weights(b, radius, cfg.blur_sigma, 0.5, torch.Generator().manual_seed(0))
    t = torch.from_numpy
    p = aug.ViewParams(t(y0), t(x0), t(ch), t(cw), t(flip), t(factors), t(hue), t(perm),
                       t(jit_on), t(gray_on), taps)
    got = aug.apply_view(t(u8), p, cfg).numpy()

    img = jnp.asarray(u8, jnp.float32) / 255.0
    img = jax.vmap(lambda im, a, c, d, e, f: jresize.crop_resize(
        im, a, c, d, e, out, True, flip_h=f))(img, y0, x0, ch, cw, flip)
    jit = jax.vmap(lambda im, f, hs, pp: jaug._apply_jitter_ops_fast(
        im, (f[0], f[1], f[2]), hs, pp, True))(img, factors, hue, perm.astype(np.int32))
    img = jnp.where(jit_on[:, None, None, None], jit, img)
    gray = jnp.broadcast_to(jaug._grayscale(img)[..., None], img.shape)
    img = jnp.where(gray_on[:, None, None, None], gray, img)
    img = (img - jaug.IMAGENET_MEAN) * jaug.IMAGENET_INV_STD
    ref = np.asarray(jblur(img, jnp.asarray(taps.numpy()), radius, interpret=True))
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=2e-5)


def test_rrc_sampler_statistics():
    gen = torch.Generator().manual_seed(0)
    cfg = aug.v2_aug_config(32)
    n = 4000
    ext = torch.full((n,), 64.0)
    y0, x0, ch, cw = aug.rrc_params(ext, ext, cfg, gen)
    scale = (ch * cw / (64.0 * 64.0)).numpy()
    ratio = (cw / ch).numpy()
    assert scale.min() >= cfg.min_scale - 1e-5 and scale.max() <= cfg.max_scale + 1e-5
    assert ratio.min() >= 3 / 4 - 1e-5 and ratio.max() <= 4 / 3 + 1e-5
    assert (y0 >= 0).all() and (x0 >= 0).all()
    assert (y0 + ch <= 64 + 1e-4).all() and (x0 + cw <= 64 + 1e-4).all()
    # log-ratio is uniform: about half the boxes are wider than tall
    assert abs((ratio > 1).mean() - 0.5) < 0.05
    # mean scale of torchvision's rejection rule, simulated in numpy: draws
    # too wide or too tall for the square are rejected, so it sits below 0.6
    rng = np.random.RandomState(0)
    area = rng.uniform(0.2, 1.0, (200000, 10))
    r = np.exp(rng.uniform(np.log(3 / 4), np.log(4 / 3), area.shape))
    fits = (np.sqrt(area * r) <= 1) & (np.sqrt(area / r) <= 1)
    expected = area[np.arange(len(area)), fits.argmax(1)].mean()  # a fit exists
    assert abs(scale.mean() - expected) < 0.01  # std of the mean ~0.003


def test_rrc_sampler_falls_back_to_centered_clamped_aspect():
    """A 4x64 strip fits no draw with scale >= 0.2 and ratio <= 4/3: every
    box is torchvision's fallback, full height and width 4/3 of it, centered."""
    gen = torch.Generator().manual_seed(1)
    n = 64
    h, w = torch.full((n,), 4.0), torch.full((n,), 64.0)
    y0, x0, ch, cw = aug.rrc_params(h, w, aug.v2_aug_config(16), gen)
    np.testing.assert_allclose(ch.numpy(), 4.0)
    np.testing.assert_allclose(cw.numpy(), 4.0 * 4 / 3, rtol=1e-6)
    np.testing.assert_allclose(x0.numpy(), (64 - 16 / 3) / 2, rtol=1e-6)
    np.testing.assert_allclose(y0.numpy(), 0.0)


def test_sample_view_draws_what_the_recipe_says():
    gen = torch.Generator().manual_seed(2)
    cfg = aug.v2_aug_config(16)
    n = 4000
    ext = torch.full((n,), 32.0)
    p = aug.sample_view(ext, ext, cfg, gen)
    # binomial std at n=4000 is <= 0.008; 0.04 is five of them
    assert abs(p.flip.float().mean().item() - cfg.flip_prob) < 0.04
    assert abs(p.jitter_apply.float().mean().item() - cfg.jitter_prob) < 0.04
    assert abs(p.gray_apply.float().mean().item() - cfg.grayscale_prob) < 0.04
    f = p.jitter_factors.numpy()
    assert f.min() >= 0.6 and f.max() <= 1.4
    assert np.abs(p.hue_shift.numpy()).max() <= cfg.hue
    assert (np.sort(p.jitter_perm.numpy(), axis=1) == np.arange(4)).all()
    # every one of the 24 orders shows up
    assert len({tuple(r) for r in p.jitter_perm.tolist()}) == 24


def test_two_crops_shapes_and_dtype():
    gen = torch.Generator().manual_seed(3)
    u8 = torch.randint(0, 256, (4, 24, 24, 3), dtype=torch.uint8)
    cfg = aug.v2_aug_config(16)._replace(dtype="bfloat16")
    q, k = aug.two_crops(u8, cfg, gen)
    assert q.shape == k.shape == (4, 16, 16, 3)
    assert q.dtype == torch.bfloat16 and q.is_contiguous()
    assert torch.isfinite(q.float()).all() and not torch.equal(q, k)


# ---------------------------------------------------------------------------
# staging extents (valid_h, valid_w, rot): the ImageFolder canvas
# ---------------------------------------------------------------------------


def _extents(rng, b, h, w):
    """Per-sample content extents inside an [h, w] canvas, about half of
    them portraits staged transposed."""
    return np.stack([rng.randint(h // 3, h + 1, b), rng.randint(w // 3, w + 1, b),
                     rng.randint(0, 2, b)], axis=1).astype(np.int32)


def test_interp_matrix_with_valid_size_matches_jax():
    rng = np.random.RandomState(6)
    start = rng.uniform(0, 20, 6).astype(np.float32)
    size = rng.uniform(2, 30, 6).astype(np.float32)
    valid = np.asarray([40, 33, 17, 5, 29, 40], np.float32)
    ref = jax.vmap(lambda s, c, v: jresize.interp_matrix(40, 16, s, c, True, v))(
        start, size, valid)
    t = torch.from_numpy
    got = resize.interp_matrix(40, 16, t(start), t(size), t(valid))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    assert float(got[3, :, 5:].abs().max()) == 0.0  # no weight past the content


def test_crop_resize_with_extents_and_both_flips_matches_jax():
    rng = np.random.RandomState(7)
    b, h, w, s = 8, 24, 40, 12
    img = rng.rand(b, h, w, 3).astype(np.float32)  # noise past the extents too
    ext = _extents(rng, b, h, w)
    y0, x0, ch, cw = _crop_params(rng, b, h, w)
    ch = np.minimum(ch, ext[:, 0]).astype(np.float32)
    cw = np.minimum(cw, ext[:, 1]).astype(np.float32)
    fv = rng.rand(b) < 0.5
    fh = rng.rand(b) < 0.5
    vh, vw = ext[:, 0].astype(np.float32), ext[:, 1].astype(np.float32)
    ref = jax.vmap(lambda im, a, c, d, e, p, q, r, u: jresize.crop_resize(
        im, a, c, d, e, s, True, valid_h=p, valid_w=q, flip_v=r, flip_h=u))(
        img, y0, x0, ch, cw, vh, vw, fv, fh)
    t = torch.from_numpy
    got = resize.crop_resize(t(img), t(y0), t(x0), t(ch), t(cw), s, t(fh), t(fv), t(vh),
                             t(vw))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_apply_view_crop_on_rot_staged_extents_matches_jax():
    """The crop of a view on rot-staged extents against the JAX package's
    `_random_resized_crop`: the box and flip drawn by the JAX package's own
    samplers from the same keys, handed to the port's `apply_view` (no
    jitter, grayscale or blur, so the view is the normalized crop)."""
    rng = np.random.RandomState(8)
    b, h, w, out = 12, 20, 40, 12
    u8 = rng.randint(0, 256, (b, h, w, 3), dtype=np.uint8)
    ext = _extents(rng, b, h, w)
    assert 0 < ext[:, 2].sum() < b
    kw = dict(out_size=out, jitter_prob=0.0, grayscale_prob=0.0, blur_prob=0.0)
    jcfg, cfg = jaug.AugConfig(**kw), aug.AugConfig(**kw)
    keys = jax.random.split(jax.random.key(3), b)
    flip_keys = jax.random.split(jax.random.key(4), b)
    img = jnp.asarray(u8, jnp.float32) / 255.0
    ref = jax.vmap(lambda im, k, e, fk: jaug._random_resized_crop(im, k, jcfg, e, fk))(
        img, keys, jnp.asarray(ext), flip_keys)
    ref = (np.asarray(ref) - jaug.IMAGENET_MEAN) * jaug.IMAGENET_INV_STD
    box = jax.vmap(lambda k, e: jaug._rrc_params(k, e[0], e[1], jcfg))(keys, jnp.asarray(ext))
    flip = np.asarray(jax.vmap(lambda k: jax.random.uniform(k, ()) < jcfg.flip_prob)(
        flip_keys))
    assert 0 < flip.sum() < b
    t = torch.from_numpy
    y0, x0, ch, cw = (t(np.array(a)) for a in box)
    p = aug.ViewParams(y0, x0, ch, cw, t(flip), torch.ones(b, 3), torch.zeros(b),
                       torch.arange(4).repeat(b, 1), torch.zeros(b, dtype=torch.bool),
                       torch.zeros(b, dtype=torch.bool), torch.ones(b, 1),
                       t(ext[:, 0]).float(), t(ext[:, 1]).float(), t(ext[:, 2] > 0))
    got = aug.apply_view(t(u8), p, cfg).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=2e-5)


def test_apply_view_v2_on_extents_composes_the_jax_pieces():
    """A whole v2 view of a rot-staged batch from fixed draws equals the
    JAX package's pieces: the crop over the valid area with the flip on the
    staged H axis for transposed samples, the transpose back, jitter,
    grayscale, normalize, blur."""
    from moco_tpu.ops.pallas_blur import gaussian_blur_batch as jblur

    rng = np.random.RandomState(9)
    b, h, w, out = 8, 16, 32, 12
    u8 = rng.randint(0, 256, (b, h, w, 3), dtype=np.uint8)
    ext = _extents(rng, b, h, w)
    ext[:2, 2] = [0, 1]
    cfg = aug.v2_aug_config(out)
    y0, x0, ch, cw = _crop_params(rng, b, h, w)
    ch = np.minimum(ch, ext[:, 0]).astype(np.float32)
    cw = np.minimum(cw, ext[:, 1]).astype(np.float32)
    factors, hue, perm = _jitter_params(rng, b)
    flip = np.array([1, 1, 0, 1, 0, 1, 0, 1], bool)
    jit_on = np.array([1, 1, 0, 1, 0, 1, 1, 0], bool)
    gray_on = np.array([0, 1, 1, 0, 0, 0, 1, 0], bool)
    radius = aug.blur_radius(out)
    taps = aug.blur_weights(b, radius, cfg.blur_sigma, 0.5, torch.Generator().manual_seed(1))
    rot = ext[:, 2] > 0
    vh, vw = ext[:, 0].astype(np.float32), ext[:, 1].astype(np.float32)
    t = torch.from_numpy
    p = aug.ViewParams(t(y0), t(x0), t(ch), t(cw), t(flip), t(factors), t(hue), t(perm),
                       t(jit_on), t(gray_on), taps, t(vh), t(vw), t(rot))
    got = aug.apply_view(t(u8), p, cfg).numpy()

    img = jnp.asarray(u8, jnp.float32) / 255.0
    img = jax.vmap(lambda im, a, c, d, e, p_, q, r, u: jresize.crop_resize(
        im, a, c, d, e, out, True, valid_h=p_, valid_w=q, flip_v=r, flip_h=u))(
        img, y0, x0, ch, cw, vh, vw, flip & rot, flip & ~rot)
    img = jnp.where(rot[:, None, None, None], jnp.swapaxes(img, 1, 2), img)
    jit = jax.vmap(lambda im, f, hs, pp: jaug._apply_jitter_ops_fast(
        im, (f[0], f[1], f[2]), hs, pp, True))(img, factors, hue, perm.astype(np.int32))
    img = jnp.where(jit_on[:, None, None, None], jit, img)
    gray = jnp.broadcast_to(jaug._grayscale(img)[..., None], img.shape)
    img = jnp.where(gray_on[:, None, None, None], gray, img)
    img = (img - jaug.IMAGENET_MEAN) * jaug.IMAGENET_INV_STD
    ref = np.asarray(jblur(img, jnp.asarray(taps.numpy()), radius, interpret=True))
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=2e-5)


def test_two_crops_full_extents_equal_no_extents():
    """Extents that cover the whole canvas give the same bits as none."""
    u8 = torch.randint(0, 256, (4, 24, 24, 3), dtype=torch.uint8,
                       generator=torch.Generator().manual_seed(5))
    cfg = aug.v2_aug_config(16)
    ext = torch.tensor([[24, 24, 0]] * 4, dtype=torch.int32)
    a = aug.two_crops(u8, cfg, torch.Generator().manual_seed(6), ext)
    b = aug.two_crops(u8, cfg, torch.Generator().manual_seed(6))
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    # a transposed sample's view is the transposed canvas's view
    rot = torch.tensor([[24, 24, 1]] * 4, dtype=torch.int32)
    c = aug.two_crops(u8.transpose(1, 2).contiguous(), cfg, torch.Generator().manual_seed(6),
                      rot)
    for x, y in zip(c, b):
        assert x.shape == y.shape and torch.isfinite(x).all()


# ---------------------------------------------------------------------------
# the v1 recipe as a whole: its draws' distribution against the JAX package's
# ---------------------------------------------------------------------------


def _view_stats(q: np.ndarray, k: np.ndarray) -> dict:
    """Per-view statistics of a (query, key) batch of normalized NHWC views:
    channel means and variances within a view, whether the view is gray,
    and the correlation between a sample's two views."""
    views = np.concatenate([q, k])
    a, b = (v.reshape(len(v), -1) for v in (q, k))
    a, b = a - a.mean(1, keepdims=True), b - b.mean(1, keepdims=True)
    # a gray view has equal R, G, B before normalization
    rgb = views * np.asarray(aug.IMAGENET_STD) + np.asarray(aug.IMAGENET_MEAN)
    return dict(mean=views.mean((1, 2)), var=views.var((1, 2)),
                gray=(np.ptp(rgb, axis=-1).max((1, 2)) < 1e-4).astype(np.float64)[:, None],
                corr=((a * b).sum(1) / np.linalg.norm(a, axis=1)
                      / np.linalg.norm(b, axis=1))[:, None])


def test_v1_two_crops_statistics_match_jax():
    """The horizon's recipe (v1 at 32 px) on the horizon's texture images:
    the port's `two_crops` and the JAX package's draw views of the same
    distribution. The frameworks draw other random numbers, so the test
    holds statistics of 1024 views a side: the channel means and variances
    after the jitter and grayscale, the gray share, the correlation of a
    sample's two views (within 4 standard errors of the difference), and
    the crop scales and aspects (two-sample Kolmogorov-Smirnov on 20000
    boxes a side, p > 0.001; 50000 a side at three seeds gave p 0.28-0.77).
    The seeds are fixed, so the outcome does not vary from run to run."""
    from scipy.stats import ks_2samp

    from moco_tpu.data.datasets import SyntheticTextureDataset

    images, _, extents = SyntheticTextureDataset(num_samples=256, image_size=32,
                                                 num_classes=16).get_batch(np.arange(256))
    jcfg, cfg = jaug.v1_aug_config(32), aug.v1_aug_config(32)
    jtwo = jax.jit(lambda key: jaug.two_crops(jnp.asarray(images), key, jcfg,
                                              jnp.asarray(extents)))
    gen = torch.Generator().manual_seed(0)
    jax_views, port_views = [], []
    for r in range(2):
        jax_views.append([np.asarray(v) for v in jtwo(jax.random.key(r))])
        port_views.append([v.numpy() for v in aug.two_crops(
            torch.from_numpy(images), cfg, gen, torch.from_numpy(extents))])
    jstats = [_view_stats(*v) for v in jax_views]
    pstats = [_view_stats(*v) for v in port_views]
    for name in ("mean", "var", "gray", "corr"):
        js = np.concatenate([s[name] for s in jstats])
        ps = np.concatenate([s[name] for s in pstats])
        se = np.sqrt(js.var(0) / len(js) + ps.var(0) / len(ps))
        z = np.abs(js.mean(0) - ps.mean(0)) / se
        assert (z < 4).all(), (name, js.mean(0), ps.mean(0), z)
    # the crop boxes' own draws
    n = 20000
    keys = jax.vmap(lambda i: jax.random.fold_in(jax.random.key(3), i))(jnp.arange(n))
    _, _, jh, jw = (np.asarray(v) for v in jax.jit(jax.vmap(
        lambda key: jaug._rrc_params(key, 32.0, 32.0, jcfg)))(keys))
    ext = torch.full((n,), 32.0)
    _, _, ph, pw = (v.numpy() for v in aug.rrc_params(ext, ext, cfg,
                                                      torch.Generator().manual_seed(3)))
    assert ks_2samp(jh * jw, ph * pw).pvalue > 0.001
    assert ks_2samp(jw / jh, pw / ph).pvalue > 0.001


# ---------------------------------------------------------------------------
# the v1 recipe draw for draw: the JAX pipeline's own per-sample draws,
# packed into the port's ViewParams
# ---------------------------------------------------------------------------


def _jax_view_draws(view_key, n: int, cfg) -> dict:
    """Each sample's draws of one JAX view, from the pipeline's own keys:
    `_sample_keys` (one key a sample), `_augment_one`'s six-way split, then
    `_rrc_params` on the crop key, the flip and grayscale draws of
    `_random_resized_crop` / `_random_grayscale`, and `_color_jitter`'s
    six-way split and draws."""
    def one(key):
        kcrop, kjit, kgray, _kblur, kflip, _ksol = jax.random.split(key, 6)
        y0, x0, ch, cw = jaug._rrc_params(kcrop, 32.0, 32.0, cfg)
        kb, kc, ks, kh, kp, kperm = jax.random.split(kjit, 6)
        factors = jnp.stack([jax.random.uniform(k, (), minval=max(0.0, 1.0 - x), maxval=1.0 + x)
                             for k, x in ((kb, cfg.brightness), (kc, cfg.contrast),
                                          (ks, cfg.saturation))])
        return dict(
            y0=y0, x0=x0, crop_h=ch, crop_w=cw,
            flip=jax.random.uniform(kflip, ()) < cfg.flip_prob,
            jitter_factors=factors,
            hue_shift=jax.random.uniform(kh, (), minval=-cfg.hue, maxval=cfg.hue),
            jitter_perm=jax.random.permutation(kperm, 4),
            jitter_apply=jax.random.uniform(kp, ()) < cfg.jitter_prob,
            gray_apply=jax.random.uniform(kgray, ()) < cfg.grayscale_prob)

    with jax.disable_jit():  # op by op, as the reference views are made
        draws = jax.vmap(one)(jaug._sample_keys(view_key, 0, n))
    return {k: np.asarray(v) for k, v in draws.items()}


def _bf16_ulp(x: np.ndarray) -> np.ndarray:
    """The spacing of bf16 numbers at |x| (8 significant bits)."""
    mag = np.maximum(np.abs(x), np.finfo(np.float32).tiny)
    return np.exp2(np.floor(np.log2(mag)) - 7)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_v1_views_draw_for_draw_match_jax(dtype):
    """The horizon's views (v1 at 32 px, texture images) sample for sample:
    each JAX view's own draws (keys split as `jaug.two_crops` splits them)
    packed into the port's `ViewParams` and run through `apply_view` give
    `jaug.two_crops`'s views, its ops run one at a time (`disable_jit`).
    f32 within rtol 1e-5 / atol 1e-5 (the resize matmuls and the HSV round
    trip sum in another order); bf16, where both round every op, within one
    bf16 ulp of the larger value. The compiled program is not the
    reference here: XLA fuses the HSV conversion and, at pixels where two
    channels tie, picks another hue sector than the op-by-op run (on the
    CPU, 0.2-1.7% of a view's pixels)."""
    from moco_tpu.data.datasets import SyntheticTextureDataset

    n = 64
    images, _, extents = SyntheticTextureDataset(num_samples=n, image_size=32,
                                                 num_classes=16).get_batch(np.arange(n))
    jcfg, cfg = jaug.v1_aug_config(32)._replace(dtype=dtype), aug.v1_aug_config(32)._replace(
        dtype=dtype)
    key = jax.random.key(11)
    with jax.disable_jit():
        ref = [np.asarray(v.astype(jnp.float32)) for v in jaug.two_crops(
            jnp.asarray(images), key, jcfg, jnp.asarray(extents))]
    def t(a):
        return torch.from_numpy(np.array(a))

    for view_key, want in zip(jax.random.split(key), ref):
        d = _jax_view_draws(view_key, n, jcfg)
        assert d["gray_apply"].any() and not d["gray_apply"].all() and d["flip"].any()
        p = aug.ViewParams(
            t(d["y0"]), t(d["x0"]), t(d["crop_h"]), t(d["crop_w"]), t(d["flip"]),
            t(d["jitter_factors"]), t(d["hue_shift"]), t(d["jitter_perm"].astype(np.int64)),
            t(d["jitter_apply"]), t(d["gray_apply"]), torch.zeros(n, 0),
            t(extents[:, 0]).float(), t(extents[:, 1]).float(), t(extents[:, 2] > 0))
        got = aug.apply_view(t(images), p, cfg).float().numpy()
        if dtype == "float32":
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
        else:
            diff = np.abs(got - want)
            over = diff > _bf16_ulp(np.maximum(np.abs(got), np.abs(want)))
            assert not over.any(), (f"{over.sum()} of {over.size} values beyond one bf16 ulp, "
                                    f"max difference {diff.max()}")
