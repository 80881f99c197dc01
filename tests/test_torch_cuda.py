"""The port's CUDA kernels against their plain PyTorch versions at awkward
shapes, on the card. Marked `cuda`; each test skips where there is no CUDA
device. Run on a GPU machine (no JAX needed) with:

    python -m pytest tests/test_torch_cuda.py --noconftest -q
"""

import pytest
import torch

from moco_tpu_torch.models.fast_bn import FastBatchNorm
from moco_tpu_torch.ops import blur, stats

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


SHAPES = [(1, 1), (7, 3), (1000, 24), (4097, 64), (300, 2050), (65536, 256)]


def _close_sums(got, ref, scale, rtol):
    for g, r, s in zip(got, ref, scale):
        assert bool(((g - r).abs() <= rtol * s + 1e-6).all()), float((g - r).abs().max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,c", SHAPES)
def test_channel_sums_kernel(cuda, m, c, dtype):
    gen = torch.Generator(device=cuda).manual_seed(m * c)
    x = (torch.randn((m, c), generator=gen, device=cuda) * 2 + 0.5).to(dtype)
    got = stats.channel_sums(x)
    xf = x.float()
    # f32 sums of the same values in another order
    _close_sums(got, stats.channel_sums_plain(x), (xf.abs().sum(0), (xf * xf).sum(0)), 1e-5)
    again = stats.channel_sums(x)
    assert all(torch.equal(a, b) for a, b in zip(got, again))  # no atomics: same bits


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,c", SHAPES)
def test_channel_grad_sums_kernel(cuda, m, c, dtype):
    gen = torch.Generator(device=cuda).manual_seed(m + c)
    x = torch.randn((m, c), generator=gen, device=cuda).to(dtype)
    dy = torch.randn((m, c), generator=gen, device=cuda).to(dtype)
    mean = torch.randn(c, generator=gen, device=cuda) * 0.1
    rstd = torch.rand(c, generator=gen, device=cuda) + 0.5
    got = stats.channel_grad_sums(dy, x, mean, rstd)
    dyf = dy.float()
    scale = (dyf.abs().sum(0), (dyf * (x.float() - mean) * rstd).abs().sum(0))
    _close_sums(got, stats.channel_grad_sums_plain(dy, x, mean, rstd), scale, 1e-5)


def test_unaligned_rows_take_narrow_loads(cuda):
    """A view that starts 2 bytes into its storage cannot use 16-byte loads."""
    base = torch.randn(1 + 513 * 64, device=cuda).bfloat16()
    x = base[1:].view(513, 64)
    assert x.data_ptr() % 16 != 0
    got = stats.channel_sums(x)
    xf = x.float()
    _close_sums(got, stats.channel_sums_plain(x), (xf.abs().sum(0), (xf * xf).sum(0)), 1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("radius,b,h,w", [(1, 3, 37, 53), (2, 2, 32, 32), (11, 4, 64, 40),
                                          (11, 2, 5, 7)])
def test_blur_kernel(cuda, radius, b, h, w, dtype):
    gen = torch.Generator(device=cuda).manual_seed(radius * h)
    images = torch.randn((b, h, w, 3), generator=gen, device=cuda).to(dtype)
    taps = blur.blur_weights(b, radius, (0.1, 2.0), 0.5, gen, cuda)
    got = blur.gaussian_blur_batch(images, taps, radius).float()
    ref = blur.gaussian_blur_batch_plain(images.float(), taps, radius)
    # f32: reassociation only; bf16: one rounding of the f32 result
    tol = 1e-5 if dtype == torch.float32 else 2.0 ** -7 * ref.abs() + 1e-5
    assert bool(((got - ref).abs() <= tol).all()), float((got - ref).abs().max())


def test_launch_counters_count_card_launches_only(cuda):
    before = (stats.channel_sums.launches, blur.gaussian_blur_batch.launches)
    stats.channel_sums(torch.ones(8, 4))
    stats.channel_sums(torch.ones(8, 4, device=cuda))
    taps = blur.blur_weights(1, 1, (1.0, 1.0), 1.0, torch.Generator(device=cuda), cuda)
    blur.gaussian_blur_batch(torch.ones(1, 4, 4, 3, device=cuda), taps, 1)
    assert (stats.channel_sums.launches, blur.gaussian_blur_batch.launches) == \
        (before[0] + 1, before[1] + 1)


def test_wrappers_raise_on_non_contiguous_cuda_input(cuda):
    with pytest.raises(ValueError):
        stats.channel_sums(torch.zeros(8, 16, device=cuda).t())


def test_fast_bn_on_card_matches_cpu(cuda):
    gen = torch.Generator().manual_seed(0)
    x = torch.randn((8, 16, 6, 6), generator=gen).to(memory_format=torch.channels_last)
    ct = torch.randn((8, 16, 6, 6), generator=gen)
    outs = []
    for dev in ("cpu", cuda):
        bn = FastBatchNorm(16).to(dev)
        xd = x.to(dev, copy=True).requires_grad_()
        (bn(xd) * ct.to(dev)).sum().backward()
        outs.append([t.detach().cpu() for t in (xd.grad, bn.weight.grad, bn.bias.grad,
                                                 bn.running_mean, bn.running_var)])
    for a, b in zip(*outs):
        torch.testing.assert_close(b, a, rtol=1e-4, atol=1e-5)
