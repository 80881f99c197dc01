"""The port's blur against the JAX package's Pallas blur (interpret mode),
and the statistics of the port's tap sampler."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moco_tpu.ops.pallas_blur import blur_radius as jax_blur_radius
from moco_tpu.ops.pallas_blur import gaussian_blur_batch as jax_blur
from moco_tpu_torch.ops.blur import blur_radius, blur_taps, blur_weights, gaussian_blur_batch


def _taps(rng, b, radius):
    """Gaussian taps for random sigmas, with every other sample's taps set to
    the one-hot identity (a skipped blur)."""
    sigma = torch.from_numpy(rng.uniform(0.1, 2.0, b).astype(np.float32))
    apply = torch.from_numpy(np.arange(b) % 2 == 0)
    return blur_taps(sigma, apply, radius)


@pytest.mark.parametrize("radius,shape", [(1, (4, 9, 7)), (2, (4, 16, 16)), (3, (2, 12, 20))])
def test_plain_blur_matches_jax_kernel(radius, shape):
    rng = np.random.RandomState(radius)
    b, h, w = shape
    images = rng.randn(b, h, w, 3).astype(np.float32)
    taps = _taps(rng, b, radius)
    out_j = np.asarray(jax_blur(jnp.asarray(images), jnp.asarray(taps.numpy()), radius,
                                interpret=True))
    out_t = gaussian_blur_batch(torch.from_numpy(images), taps, radius).numpy()
    # f32, same tap order; only FMA contraction may differ: ~1e-7
    np.testing.assert_allclose(out_t, out_j, rtol=1e-6, atol=1e-6)
    # identity rows leave their sample untouched
    np.testing.assert_allclose(out_t[1::2], images[1::2], atol=1e-7)
    assert not np.allclose(out_t[0], images[0])


def test_blur_keeps_dtype_and_checks_inputs():
    img = torch.rand(2, 8, 8, 3).bfloat16()
    taps = blur_taps(torch.ones(2), torch.ones(2, dtype=torch.bool), 1)
    assert gaussian_blur_batch(img, taps, 1).dtype == torch.bfloat16
    with pytest.raises(ValueError):
        gaussian_blur_batch(img, taps, 2)                     # taps != 2R+1
    with pytest.raises(ValueError):
        gaussian_blur_batch(img.permute(0, 2, 1, 3), taps, 1)  # not contiguous


def test_blur_radius_matches_jax():
    for size in (8, 32, 96, 224):
        assert blur_radius(size) == jax_blur_radius(size)


def test_blur_weight_sampler_statistics():
    radius, b, prob = 11, 4000, 0.5
    gen = torch.Generator().manual_seed(0)
    w = blur_weights(b, radius, (0.1, 2.0), prob, gen)
    assert w.shape == (b, 2 * radius + 1) and w.dtype == torch.float32
    np.testing.assert_allclose(w.sum(1).numpy(), 1.0, rtol=1e-6)
    np.testing.assert_allclose(w.numpy(), w.flip(1).numpy(), atol=1e-7)  # symmetric
    identity = (w[:, radius] == 1.0).float().mean().item()
    # binomial std at n=4000 is ~0.008; 0.04 is five of them
    assert abs(identity - (1 - prob)) < 0.04
    blurred = w[w[:, radius] < 1.0]
    # sigma >= 0.1 puts the largest off-centre tap above exp(-50)/Z; sigma <= 2
    # keeps the centre tap above 1/(2*sqrt(2*pi)) ~ 0.2
    assert (blurred[:, radius] > 0.19).all()
    assert (blurred.argmax(1) == radius).all()
