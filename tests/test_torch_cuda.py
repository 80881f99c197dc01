"""The port's CUDA kernels against their plain PyTorch versions at awkward
shapes, on the card, with the Prefetcher, a full-state round trip, the kNN
and a one-rank NCCL step. Marked `cuda`; each test skips where there is no CUDA
device. Run on a GPU machine (no JAX needed) with:

    python -m pytest tests/test_torch_cuda.py --noconftest -q
"""

import dataclasses

import pytest
import torch

from moco_tpu_torch.models.fast_bn import FastBatchNorm
from moco_tpu_torch.ops import blur, fused_conv, fused_conv3x3, stats

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    """The card, under the package's f32 precision policy (TF32 off), as
    every entry point sets it."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    from moco_tpu_torch.utils.device import set_precision_policy

    set_precision_policy()
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.backends.cuda.matmul.allow_tf32 is False
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
    again = stats.channel_grad_sums(dy, x, mean, rstd)
    assert all(torch.equal(a, b) for a, b in zip(got, again))  # no atomics: same bits


def _grad_inputs(cuda, m, c, seed, dtype=torch.bfloat16):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    x = (torch.randn((m, c), generator=gen, device=cuda) * 2 + 0.5).to(dtype)
    dy = torch.randn((m, c), generator=gen, device=cuda).to(dtype)
    mean = x.float().mean(0)
    rstd = torch.rsqrt(x.float().var(0, correction=0) + 1e-5)
    return dy, x, mean, rstd


def _check_pair(dy, x, mean, rstd):
    """Both kernels against their plain versions, and a second run of each
    with the same bits."""
    xf, dyf = x.float(), dy.float()
    got = stats.channel_sums(x)
    _close_sums(got, stats.channel_sums_plain(x), (xf.abs().sum(0), (xf * xf).sum(0)), 1e-5)
    assert all(torch.equal(a, b) for a, b in zip(got, stats.channel_sums(x)))
    got = stats.channel_grad_sums(dy, x, mean, rstd)
    scale = (dyf.abs().sum(0), (dyf * (xf - mean) * rstd).abs().sum(0))
    _close_sums(got, stats.channel_grad_sums_plain(dy, x, mean, rstd), scale, 1e-5)
    assert all(torch.equal(a, b) for a, b in zip(got, stats.channel_grad_sums(dy, x, mean, rstd)))


# [N*H*W, C] of the 12 ResNet-50 BN shapes at batch 256, 224 px
R50_BN_SHAPES = [(3211264, 64), (802816, 64), (802816, 128), (802816, 256), (200704, 128),
                 (200704, 256), (200704, 512), (50176, 256), (50176, 512), (50176, 1024),
                 (12544, 512), (12544, 2048)]


@pytest.mark.parametrize("m,c", R50_BN_SHAPES)
def test_bn_pair_at_r50_shapes(cuda, m, c):
    _check_pair(*_grad_inputs(cuda, m, c, m + c))


@pytest.mark.parametrize("variant", ["lanes", "slabs", "one_slab"])
def test_bn_pair_forced_plans(cuda, variant):
    """Any plan that covers [M, C] gives the sums: one-lane tiles, a few
    slabs, one slab (the block is its own last block)."""
    import dataclasses

    dy, x, mean, rstd = _grad_inputs(cuda, 4097, 64, 3)
    xf, dyf = x.float(), dy.float()
    for operands in (1, 2):
        plan = stats.stats_plan(4097, 64, 2, operands)
        plan = {"lanes": dataclasses.replace(plan, lanes=1),
                "slabs": dataclasses.replace(plan, slabs=3),
                "one_slab": dataclasses.replace(plan, slabs=1)}[variant]
        if operands == 1:
            got = stats._launch_sums(x, plan)
            ref, scale = stats.channel_sums_plain(x), (xf.abs().sum(0), (xf * xf).sum(0))
        else:
            got = stats._launch_grad_sums(dy, x, mean, rstd, plan)
            ref = stats.channel_grad_sums_plain(dy, x, mean, rstd)
            scale = (dyf.abs().sum(0), (dyf * (xf - mean) * rstd).abs().sum(0))
        _close_sums(got, ref, scale, 1e-5)


def test_bn_pair_entry_points_refuse_plans_that_do_not_cover(cuda):
    """The C entry points return cudaErrorInvalidValue (1) for slabs that
    miss rows or leave one empty, an unsupported pack, odd lanes, or a
    batch the kernel does not take, and launch nothing."""
    from moco_tpu_torch.ops import _build

    lib = _build.load_library()
    x = torch.ones(1000, 64, device=cuda).bfloat16()
    ws = torch.empty(4096, device=cuda)
    tk = stats.tickets(x.device, _build.stream_handle(x.device), 64)
    stream = _build.stream_handle(x.device)
    for vec, lanes, batch, slabs, rps in [(8, 4, 8, 4, 200), (8, 4, 8, 6, 200), (16, 4, 8, 4, 250),
                                          (8, 3, 8, 4, 250), (8, 4, 4, 4, 250)]:
        assert lib.moco_channel_sums(x.data_ptr(), 1, 1000, 64, vec, lanes, batch, slabs, rps,
                                     ws.data_ptr(), tk.data_ptr(), stream) == 1
    mean, rstd = torch.zeros(64, device=cuda), torch.ones(64, device=cuda)
    for batch in (8, 2):  # two operands: 4 rows a batch
        assert lib.moco_channel_grad_sums(x.data_ptr(), x.data_ptr(), 1, mean.data_ptr(),
                                          rstd.data_ptr(), 1000, 64, 8, 4, batch, 4, 250,
                                          ws.data_ptr(), tk.data_ptr(), stream) == 1
    torch.cuda.synchronize()
    assert not bool(tk.any())


def test_bn_pair_replays_in_a_cuda_graph(cuda):
    """One call of each captured in a CUDA graph and replayed three times:
    the same bits each time, and the tickets back at 0."""
    dy, x, mean, rstd = _grad_inputs(cuda, 50176, 256, 4)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # plans, tickets and library made before capture
        eager = (stats.channel_sums(x), stats.channel_grad_sums(dy, x, mean, rstd))
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        out = (stats.channel_sums(x), stats.channel_grad_sums(dy, x, mean, rstd))
    for _ in range(3):
        for t in out:
            for v in t:
                v.fill_(float("nan"))
        graph.replay()
        torch.cuda.synchronize()
        for got, ref in zip(out, eager):
            assert all(torch.equal(a, b) for a, b in zip(got, ref))
        for held in stats._TICKETS.values():
            assert not bool(held[-1].any())


def test_bn_pair_on_two_streams_at_once(cuda):
    """Two streams, each with its own tickets, reducing different inputs at
    the same time."""
    inputs = [_grad_inputs(cuda, 200704, 256, seed) for seed in (5, 6)]
    want = [(stats.channel_sums(x), stats.channel_grad_sums(dy, x, mean, rstd))
            for dy, x, mean, rstd in inputs]
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    torch.cuda.synchronize()
    got = [[], []]
    for _ in range(8):
        for i, (s, (dy, x, mean, rstd)) in enumerate(zip(streams, inputs)):
            with torch.cuda.stream(s):
                got[i].append((stats.channel_sums(x), stats.channel_grad_sums(dy, x, mean, rstd)))
    torch.cuda.synchronize()
    for i in range(2):
        for out in got[i]:
            for g, w in zip(out, want[i]):
                assert all(torch.equal(a, b) for a, b in zip(g, w))


def test_unaligned_rows_take_narrow_loads(cuda):
    """A view that starts 2 bytes into its storage cannot use 16-byte loads:
    channel_sums on it, and channel_grad_sums with it as x and as dy."""
    base = torch.randn(1 + 513 * 64, device=cuda).bfloat16()
    view = base[1:].view(513, 64)
    assert view.data_ptr() % 16 != 0
    dy, x, mean, rstd = _grad_inputs(cuda, 513, 64, 7)
    _check_pair(dy, view, mean, rstd)
    _check_pair(view, x, mean, rstd)


def _check_blur(images, taps, radius, plan=None):
    """The kernel (on its own plan, or on `plan`) against the f32 plain
    version; identity samples bit for bit; a second launch with the same
    bits. Returns the output."""
    got = blur._launch_blur(images, taps, radius, plan)
    ref = blur.gaussian_blur_batch_plain(images.float(), taps, radius)
    # f32: FMA contraction only; bf16: one rounding of the f32 result
    tol = 1e-5 if images.dtype == torch.float32 else 2.0 ** -7 * ref.abs() + 1e-5
    diff = (got.float() - ref).abs()
    assert bool((diff <= tol).all()), float(diff.max())
    ident = taps[:, radius] == 1.0
    assert torch.equal(got[ident], images[ident])
    assert torch.equal(got, blur._launch_blur(images, taps, radius, plan))
    return got


def _blur_inputs(cuda, b, h, w, radius, dtype, seed, offset=0):
    """Images [b, h, w, 3] starting `offset` elements into their storage, and
    taps with every other sample the identity."""
    gen = torch.Generator(device=cuda).manual_seed(seed)
    base = torch.randn(offset + b * h * w * 3, generator=gen, device=cuda).to(dtype)
    images = base[offset:].view(b, h, w, 3)
    sigma = torch.rand(b, generator=gen, device=cuda) * 1.9 + 0.1
    apply = torch.arange(b, device=cuda) % 2 == 0
    return images, blur.blur_taps(sigma, apply, radius)


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
    ident = taps[:, radius] == 1.0
    assert torch.equal(got[ident], images[ident].float())  # identity samples untouched
    assert torch.equal(got, blur.gaussian_blur_batch(images, taps, radius).float())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("variant", ["three_bands", "one_band", "generic_at_11", "row_bands"])
def test_blur_forced_plans(cuda, variant, dtype):
    """Other bandings than the plan's own, and the run-time-radius
    instantiation at R = 11, give the plain version's values."""
    b, h, w = 2, 64, 40
    images, taps = _blur_inputs(cuda, b, h, w, 11, dtype, seed=5)
    plan = blur.blur_plan(b, h, w, 11, images.element_size())
    forced = {"three_bands": dataclasses.replace(plan, bands=3, rows_per_band=24),
              "one_band": dataclasses.replace(plan, bands=1, rows_per_band=h),
              "generic_at_11": dataclasses.replace(plan, fixed=False),
              "row_bands": dataclasses.replace(plan, bands=8, rows_per_band=8)}[variant]
    _check_blur(images, taps, 11, forced)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("offset,w", [(1, 53), (3, 40), (1, 224), (0, 7)])
def test_blur_unaligned_rows_and_sample_base(cuda, offset, w, dtype):
    """Rows of an odd width, and batches that start 2, 4, 6 or 12 bytes
    into a granule, take the same granule copy; stores are packed only
    where the output rows allow it."""
    images, taps = _blur_inputs(cuda, 3, 21, w, 2, dtype, seed=w + offset, offset=offset)
    assert (images.data_ptr() % 16 != 0) == (offset != 0)
    _check_blur(images, taps, 2)


def test_blur_grid_past_65535_blocks(cuda):
    """70000 samples of 2x2 are 70000 blocks on the grid's x axis."""
    images, taps = _blur_inputs(cuda, 70000, 2, 2, 1, torch.bfloat16, seed=7)
    assert blur.blur_plan(70000, 2, 2, 1, 2).blocks == 70000
    _check_blur(images, taps, 1)


def test_blur_counts_both_radius_routes(cuda):
    """R = 11 launches blur_rows<T, 11>, any other radius blur_rows<T, 0>;
    each call counts one launch and its route."""
    before = (blur.gaussian_blur_batch.launches, dict(blur.gaussian_blur_batch.routes))
    for radius in (11, 3):
        images, taps = _blur_inputs(cuda, 2, 16, 16, radius, torch.bfloat16, seed=radius)
        blur.gaussian_blur_batch(images, taps, radius)
    assert blur.gaussian_blur_batch.launches == before[0] + 2
    assert blur.gaussian_blur_batch.routes == {"fixed": before[1]["fixed"] + 1,
                                               "generic": before[1]["generic"] + 1}


def test_blur_replays_in_a_cuda_graph(cuda):
    """Captured launches replay with the same bits as eager ones."""
    images, taps = _blur_inputs(cuda, 4, 48, 56, 11, torch.bfloat16, seed=11)
    want = blur.gaussian_blur_batch(images, taps, 11)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        blur.gaussian_blur_batch(images, taps, 11)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        got = blur.gaussian_blur_batch(images, taps, 11)
    for _ in range(2):
        got.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(got, want)


def test_blur_refuses_a_row_too_wide(cuda):
    images, taps = _blur_inputs(cuda, 1, 8, 2000, 11, torch.bfloat16, seed=1)
    before = blur.gaussian_blur_batch.launches
    with pytest.raises(ValueError, match="shared memory"):
        blur.gaussian_blur_batch(images, taps, 11)
    assert blur.gaussian_blur_batch.launches == before


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


# The fused BN->ReLU->conv kernels. Each is held against its plain version
# computed in f32 from the same operand-dtype z (out_dtype float32, not
# rounded): f32 sums of the same products in another order stay within
# 1e-5 of sum |z||w|, and a bf16 output adds one rounding, at most one bf16
# ulp (2^-7 of |ref|).
# FUSED_1X1 from the fifth: K and N past one tile and not multiples of it
# (the dW plan: five clusters of 2, four partials added to the first), a
# layer-4-like K = 512, N = 2048 at a small ragged M, an M whose dW plan
# adds 7 cluster partials, and K = 640, past the forward's resident panel
# (three streaming slots).
FUSED_1X1 = [(96, 24, 40), (1000, 64, 256), (300, 128, 72), (4097, 16, 8), (4097, 72, 200),
             (777, 512, 2048), (20000, 256, 512), (300, 640, 136)]
# FUSED_3X3 from the fifth: the bf16 dW's band ends mid-image (H = 29 in
# bands of 6 rows; the forward's M tiles end mid-row and mid-image), the
# layer-1 geometry at B = 2, K, N past one 64-wide tile and not multiples of
# it, and 7x7 images packed 2.6 to a 128 x 128 forward tile with a partial
# last tile. FUSED_S2 from the fourth: a forward M tile that ends
# mid-image, the layer-2 geometry at B = 2, K and N past one tile (N = 200:
# two 128-wide tiles), and layer 4's 14x14 -> 7x7 at B = 3 (images packed).
FUSED_3X3 = [(2, 7, 7, 8, 8), (2, 8, 8, 16, 24), (3, 14, 14, 64, 64), (1, 5, 6, 24, 40),
             (2, 29, 28, 24, 40), (2, 56, 56, 64, 64), (2, 9, 10, 72, 80), (6, 7, 7, 16, 72)]
FUSED_S2 = [(2, 8, 8, 16, 24), (2, 14, 14, 64, 32), (1, 4, 6, 24, 40), (2, 30, 28, 8, 16),
            (2, 56, 56, 128, 128), (1, 10, 12, 72, 200), (3, 14, 14, 512, 512)]


def _assert_fused_close(got, ref, scale, dtype):
    tol = 1e-5 * scale + 1e-6
    if dtype == torch.bfloat16:
        tol = tol + 2.0 ** -7 * ref.abs()
    assert got.shape == ref.shape
    bad = (got.float() - ref).abs() > tol
    assert not bool(bad.any()), (int(bad.sum()), float((got.float() - ref).abs().max()))


def _fused_inputs(cuda, seed, xshape, k, dtype):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    x = (torch.randn(xshape, generator=gen, device=cuda) * 1.5 + 0.2).to(dtype)
    a = torch.rand(k, generator=gen, device=cuda) + 0.5
    b = torch.randn(k, generator=gen, device=cuda) * 0.5
    return gen, x, a, b


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,k,n", FUSED_1X1)
def test_bn_relu_matmul_kernel(cuda, m, k, n, dtype):
    gen, x, a, b = _fused_inputs(cuda, m + n, (m, k), k, dtype)
    w = (torch.randn((k, n), generator=gen, device=cuda) * 0.1).to(dtype)
    got = fused_conv.bn_relu_matmul(x, a, b, w, out_dtype=dtype)
    ref = fused_conv.bn_relu_matmul_plain(x, a, b, w, torch.float32)
    scale = fused_conv.bn_relu_matmul_plain(x, a, b, w.abs(), torch.float32)
    _assert_fused_close(got, ref, scale, dtype)
    assert torch.equal(got, fused_conv.bn_relu_matmul(x, a, b, w, out_dtype=dtype))


def test_bn_relu_matmul_unaligned_rows_take_narrow_loads(cuda):
    """A view that starts 2 bytes into its storage cannot use 16-byte loads."""
    _gen, base, a, b = _fused_inputs(cuda, 5, (1 + 513 * 64,), 64, torch.bfloat16)
    x = base[1:].view(513, 64)
    assert x.data_ptr() % 16 != 0
    w = torch.randn((64, 32), device=cuda).bfloat16()
    got = fused_conv.bn_relu_matmul(x, a, b, w, out_dtype=torch.float32)
    ref = fused_conv.bn_relu_matmul_plain(x, a, b, w, torch.float32)
    scale = fused_conv.bn_relu_matmul_plain(x, a, b, w.abs(), torch.float32)
    _assert_fused_close(got, ref, scale, torch.float32)


def test_bn_relu_matmul_unaligned_x_takes_narrow_loads_bf16(cuda):
    """The bf16 panel kernel on an x view 2 bytes into its storage (2-byte
    loads), K and N past one tile; f32 and bf16 out from the same plan."""
    m, k, n = 517, 72, 200
    gen, base, a, b = _fused_inputs(cuda, 19, (1 + m * k,), k, torch.bfloat16)
    x = base[1:].view(m, k)
    assert x.data_ptr() % 16 != 0
    w = (torch.randn((k, n), generator=gen, device=cuda) * 0.1).bfloat16()
    ref = fused_conv.bn_relu_matmul_plain(x, a, b, w, torch.float32)
    scale = fused_conv.bn_relu_matmul_plain(x, a, b, w.abs(), torch.float32)
    for dtype in (torch.float32, torch.bfloat16):
        got = fused_conv.bn_relu_matmul(x, a, b, w, out_dtype=dtype)
        _assert_fused_close(got, ref, scale, dtype)
        assert torch.equal(got, fused_conv.bn_relu_matmul(x, a, b, w, out_dtype=dtype))


@pytest.mark.parametrize("slots,span", [(6, 128), (6, 256), (4, 128), (5, 384)])
def test_bn_relu_matmul_panel_plans(cuda, slots, span):
    """The panel kernel on forced plans at K = 328 (six chunks, the last 8
    deep) and N = 300 (three 128-wide tiles): a resident panel (6 slots)
    swept over spans of one and two N tiles, and four or five streaming
    slots (the plan streams in three)."""
    import dataclasses

    m, k, n = 1111, 328, 300
    gen, x, a, b = _fused_inputs(cuda, slots * span, (m, k), k, torch.bfloat16)
    w = (torch.randn((k, n), generator=gen, device=cuda) * 0.1).bfloat16()
    plan = dataclasses.replace(fused_conv.matmul_fwd_plan(m, k, n), span=span, slots=slots)
    assert plan.resident == (slots == 6)
    got = fused_conv._launch_matmul(x, a, b, w, torch.bfloat16, plan)
    _assert_fused_close(got, fused_conv.bn_relu_matmul_plain(x, a, b, w, torch.float32),
                        fused_conv.bn_relu_matmul_plain(x, a, b, w.abs(), torch.float32),
                        torch.bfloat16)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,k,n", FUSED_1X1)
def test_bn_relu_matmul_dw_kernel(cuda, m, k, n, dtype):
    gen, x, a, b = _fused_inputs(cuda, m * n, (m, k), k, dtype)
    dy = torch.randn((m, n), generator=gen, device=cuda).to(dtype)
    got = fused_conv.bn_relu_matmul_dw(x, a, b, dy)
    _assert_fused_close(got, fused_conv.bn_relu_matmul_dw_plain(x, a, b, dy),
                        fused_conv.bn_relu_matmul_dw_plain(x, a, b, dy.abs()), torch.float32)
    assert torch.equal(got, fused_conv.bn_relu_matmul_dw(x, a, b, dy))  # no atomics


@pytest.mark.parametrize("which", ["x", "dy"])
def test_bn_relu_matmul_dw_unaligned_takes_narrow_loads(cuda, which):
    """The bf16 row-walk kernel with x or dy 2 bytes into its storage."""
    m, k, n = 1000, 72, 200
    gen, x, a, b = _fused_inputs(cuda, 23, (m, k), k, torch.bfloat16)
    dy = torch.randn((m, n), generator=gen, device=cuda).bfloat16()
    if which == "x":
        x = torch.cat([x.new_zeros(1), x.flatten()])[1:].view(m, k)
    else:
        dy = torch.cat([dy.new_zeros(1), dy.flatten()])[1:].view(m, n)
    assert (x if which == "x" else dy).data_ptr() % 16 != 0
    got = fused_conv.bn_relu_matmul_dw(x, a, b, dy)
    _assert_fused_close(got, fused_conv.bn_relu_matmul_dw_plain(x, a, b, dy),
                        fused_conv.bn_relu_matmul_dw_plain(x, a, b, dy.abs()), torch.float32)
    assert torch.equal(got, fused_conv.bn_relu_matmul_dw(x, a, b, dy))


@pytest.mark.parametrize("bko,slabs,cluster", [(64, 1, 1), (64, 8, 8), (128, 6, 2), (128, 12, 4),
                                               (128, 7, 7)])
def test_bn_relu_matmul_dw_plans(cuda, bko, slabs, cluster):
    """The row-walk kernel on forced plans at K = 72 and N = 200: both
    tiles, one slab, one cluster of 7 or 8 (the sum on chip alone), and
    clusters of 2 and 4 with two partials added to the first's sum."""
    m, k, n = 3001, 72, 200
    gen, x, a, b = _fused_inputs(cuda, slabs * 10 + cluster, (m, k), k, torch.bfloat16)
    dy = torch.randn((m, n), generator=gen, device=cuda).bfloat16()
    plan = fused_conv.MatmulDwPlan(m, k, n, bko, slabs, cluster)
    got = fused_conv._launch_matmul_dw(x, a, b, dy, plan)
    _assert_fused_close(got, fused_conv.bn_relu_matmul_dw_plain(x, a, b, dy),
                        fused_conv.bn_relu_matmul_dw_plain(x, a, b, dy.abs()), torch.float32)
    assert torch.equal(got, fused_conv._launch_matmul_dw(x, a, b, dy, plan))


def test_matmul_pair_counts_both_routes(cuda):
    """bf16 launches the panel and row-walk kernels and f32 the implicit
    GEMM templates; each counts one launch per call."""
    fns = (fused_conv.bn_relu_matmul, fused_conv.bn_relu_matmul_dw)
    before = [f.launches for f in fns]
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.ones(40, 8, device=cuda, dtype=dtype)
        a, b = torch.ones(8, device=cuda), torch.zeros(8, device=cuda)
        y = fused_conv.bn_relu_matmul(x, a, b, torch.ones(8, 16, device=cuda, dtype=dtype),
                                      out_dtype=torch.float32)
        dw = fused_conv.bn_relu_matmul_dw(x, a, b, torch.ones(40, 16, device=cuda, dtype=dtype))
        assert bool((y == 8).all()) and bool((dw == 40).all())
    assert [f.launches for f in fns] == [c + 2 for c in before]


def test_matmul_pair_raises_on_a_failed_launch(cuda):
    """A plan the C entry point refuses (shared memory that does not match)
    raises; nothing falls back to the plain version."""
    import dataclasses

    x = torch.ones(64, 200, device=cuda, dtype=torch.bfloat16)
    a, b = torch.ones(200, device=cuda), torch.zeros(200, device=cuda)
    w = torch.ones(200, 16, device=cuda, dtype=torch.bfloat16)
    bad = dataclasses.replace(fused_conv.matmul_fwd_plan(64, 200, 16), slots=2)  # streams in 2
    with pytest.raises(RuntimeError):
        fused_conv._launch_matmul(x, a, b, w, torch.bfloat16, bad)
    bad_dw = fused_conv.MatmulDwPlan(64, 200, 16, 128, 3, 2)  # 3 slabs in clusters of 2
    with pytest.raises(RuntimeError):
        fused_conv._launch_matmul_dw(x, a, b, torch.ones_like(w[:64]), bad_dw)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bsz,h,wd,k,n", FUSED_3X3)
def test_bn_relu_conv3x3_kernel(cuda, bsz, h, wd, k, n, dtype):
    gen, x, a, b = _fused_inputs(cuda, h * k + n, (bsz, h, wd, k), k, dtype)
    w = (torch.randn((3, 3, k, n), generator=gen, device=cuda) * 0.1).to(dtype)
    got = fused_conv3x3.bn_relu_conv3x3(x, a, b, w, out_dtype=dtype)
    ref = fused_conv3x3.bn_relu_conv3x3_plain(x, a, b, w, torch.float32)
    scale = fused_conv3x3.bn_relu_conv3x3_plain(x, a, b, w.abs(), torch.float32)
    _assert_fused_close(got, ref, scale, dtype)
    assert torch.equal(got, fused_conv3x3.bn_relu_conv3x3(x, a, b, w, out_dtype=dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bsz,h,wd,k,n", FUSED_S2)
def test_bn_relu_conv3x3_s2_kernel(cuda, bsz, h, wd, k, n, dtype):
    gen, x, a, b = _fused_inputs(cuda, h * k + n + 1, (bsz, h, wd, k), k, dtype)
    w = (torch.randn((3, 3, k, n), generator=gen, device=cuda) * 0.1).to(dtype)
    got = fused_conv3x3.bn_relu_conv3x3_s2(x, a, b, w, out_dtype=dtype)
    ref = fused_conv3x3.bn_relu_conv3x3_s2_plain(x, a, b, w, torch.float32)
    scale = fused_conv3x3.bn_relu_conv3x3_s2_plain(x, a, b, w.abs(), torch.float32)
    _assert_fused_close(got, ref, scale, dtype)
    assert torch.equal(got, fused_conv3x3.bn_relu_conv3x3_s2(x, a, b, w, out_dtype=dtype))


@pytest.mark.parametrize("stride", [1, 2])
def test_conv3x3_forward_unaligned_x_takes_narrow_loads(cuda, stride):
    """An x view that starts 2 bytes into its storage cannot use 16-byte
    copies; the band kernel then loads 2 bytes at a time. The output is f32
    and bf16 from the same launch plan."""
    bsz, h, wd, k, n = 2, 10, 12, 24, 40
    gen, base, a, b = _fused_inputs(cuda, 13 + stride, (1 + bsz * h * wd * k,), k,
                                    torch.bfloat16)
    x = base[1:].view(bsz, h, wd, k)
    assert x.data_ptr() % 16 != 0
    w = (torch.randn((3, 3, k, n), generator=gen, device=cuda) * 0.1).bfloat16()
    fn, plain = (fused_conv3x3.bn_relu_conv3x3, fused_conv3x3.bn_relu_conv3x3_plain) \
        if stride == 1 else (fused_conv3x3.bn_relu_conv3x3_s2,
                             fused_conv3x3.bn_relu_conv3x3_s2_plain)
    ref, scale = plain(x, a, b, w, torch.float32), plain(x, a, b, w.abs(), torch.float32)
    for dtype in (torch.float32, torch.bfloat16):
        got = fn(x, a, b, w, out_dtype=dtype)
        _assert_fused_close(got, ref, scale, dtype)
        assert torch.equal(got, fn(x, a, b, w, out_dtype=dtype))


@pytest.mark.parametrize("bk", [64, 32])
@pytest.mark.parametrize("stride", [1, 2])
def test_conv3x3_forward_chunk_depths(cuda, stride, bk):
    """Both K-chunk depths of the band kernel, forced through the launch
    plan, at K = 72 (the last chunk 8 deep) and N = 200 (two N tiles)."""
    import dataclasses

    bsz, h, wd, k, n = 2, 10, 12, 72, 200
    gen, x, a, b = _fused_inputs(cuda, 17 + stride + bk, (bsz, h, wd, k), k, torch.bfloat16)
    w = (torch.randn((3, 3, k, n), generator=gen, device=cuda) * 0.1).bfloat16()
    plan = dataclasses.replace(fused_conv3x3.conv3x3_fwd_plan(bsz, h, wd, k, n, stride), bk=bk)
    got = fused_conv3x3._launch_conv("fwd", x, a, b, w, torch.bfloat16, stride, plan)
    plain = fused_conv3x3.bn_relu_conv3x3_plain if stride == 1 else \
        fused_conv3x3.bn_relu_conv3x3_s2_plain
    _assert_fused_close(got, plain(x, a, b, w, torch.float32),
                        plain(x, a, b, w.abs(), torch.float32), torch.bfloat16)


def test_conv3x3_forwards_count_both_routes(cuda):
    """bf16 launches the band kernel and f32 the implicit GEMM; each counts
    one launch per call."""
    fns = (fused_conv3x3.bn_relu_conv3x3, fused_conv3x3.bn_relu_conv3x3_s2)
    before = [f.launches for f in fns]
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.ones(2, 4, 4, 8, device=cuda, dtype=dtype)
        a, b = torch.ones(8, device=cuda), torch.zeros(8, device=cuda)
        w = torch.ones(3, 3, 8, 8, device=cuda, dtype=dtype)
        for f in fns:
            f(x, a, b, w)
    assert [f.launches for f in fns] == [c + 2 for c in before]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bsz,h,wd,k,n", FUSED_3X3)
def test_conv3x3_dw_kernel(cuda, bsz, h, wd, k, n, dtype):
    gen, x, a, b = _fused_inputs(cuda, h * n + k, (bsz, h, wd, k), k, dtype)
    dy = torch.randn((bsz, h, wd, n), generator=gen, device=cuda).to(dtype)
    got = fused_conv3x3.conv3x3_dw(x, a, b, dy)
    _assert_fused_close(got, fused_conv3x3.conv3x3_dw_plain(x, a, b, dy),
                        fused_conv3x3.conv3x3_dw_plain(x, a, b, dy.abs()), torch.float32)
    assert torch.equal(got, fused_conv3x3.conv3x3_dw(x, a, b, dy))  # no atomics


def test_conv3x3_dw_unaligned_dy_takes_narrow_loads(cuda):
    """A dy view that starts 2 bytes into its storage cannot use 16-byte
    copies; the band kernel then loads 2 bytes at a time."""
    bsz, h, wd, k, n = 2, 9, 10, 24, 40
    gen, x, a, b = _fused_inputs(cuda, 11, (bsz, h, wd, k), k, torch.bfloat16)
    base = torch.randn((1 + bsz * h * wd * n,), generator=gen, device=cuda).bfloat16()
    dy = base[1:].view(bsz, h, wd, n)
    assert dy.data_ptr() % 16 != 0
    got = fused_conv3x3.conv3x3_dw(x, a, b, dy)
    _assert_fused_close(got, fused_conv3x3.conv3x3_dw_plain(x, a, b, dy),
                        fused_conv3x3.conv3x3_dw_plain(x, a, b, dy.abs()), torch.float32)
    assert torch.equal(got, fused_conv3x3.conv3x3_dw(x, a, b, dy))  # no atomics


def test_fused_kernels_count_card_launches_only(cuda):
    fns = (fused_conv.bn_relu_matmul, fused_conv3x3.bn_relu_conv3x3, fused_conv3x3.conv3x3_dw)
    before = [f.launches for f in fns]
    for dev in ("cpu", cuda):
        x, a, b = torch.ones(2, 4, 4, 8, device=dev), torch.ones(8, device=dev), \
            torch.zeros(8, device=dev)
        fused_conv.bn_relu_matmul(x.view(-1, 8), a, b, torch.ones(8, 8, device=dev))
        fused_conv3x3.bn_relu_conv3x3(x, a, b, torch.ones(3, 3, 8, 8, device=dev))
        fused_conv3x3.conv3x3_dw(x, a, b, x)
    assert [f.launches for f in fns] == [c + 1 for c in before]


@pytest.mark.parametrize("arch", ["resnet_tiny", "bottleneck_tiny"])
def test_fused_resnets_on_card_match_cpu(cuda, arch):
    """The fused path end to end on the card (kernels) and on the CPU (plain
    versions), f32: the train-mode forward and the running statistics agree,
    and the backward gives finite gradients for every parameter."""
    from moco_tpu_torch.models import resnet

    def build():
        gen = torch.Generator().manual_seed(0)
        if arch == "resnet_tiny":  # BasicBlocks: conv2 fused at stride 1
            return resnet.build_resnet(arch, num_classes=16, cifar_stem=True, generator=gen,
                                       fused_bn_conv=True)
        return resnet.ResNet((1, 1), resnet.Bottleneck, width=8, num_classes=16,
                             mlp_head=True, generator=gen, fused_bn_conv=True)

    images = torch.randn((8, 16, 16, 3), generator=torch.Generator().manual_seed(1))
    outs = []
    for dev in ("cpu", cuda):
        model = build().to(dev).train()
        out = model(images.to(dev))
        out.square().sum().backward()
        assert all(bool(torch.isfinite(p.grad).all()) for p in model.parameters())
        outs.append([out.detach().cpu()] + [b.cpu() for b in model.buffers()])
    for a, b in zip(*outs):
        # f32 sums in another order through a few layers
        torch.testing.assert_close(b, a, rtol=1e-4, atol=1e-4)


class _StagedExtents:
    """Synthetic 192 px canvases whose content extents vary per sample (up
    to 150 x 120, half of them rot-staged), so a trimmed copy ships a
    [192, 128] prefix."""

    def __init__(self, n: int):
        from moco_tpu_torch.data.datasets import SyntheticDataset

        self.inner = SyntheticDataset(num_samples=n, image_size=192, num_classes=4)

    def __len__(self):
        return len(self.inner)

    def get_batch(self, indices):
        imgs, labels, extents = self.inner.get_batch(indices)
        extents[:, 0] = 100 + indices % 51
        extents[:, 1] = 80 + indices % 41
        extents[:, 2] = indices % 2
        return imgs, labels, extents


@pytest.mark.parametrize("workers, trim", [(1, False), (4, False), (4, True)])
def test_prefetcher_on_the_card_equals_the_cpu_loader(cuda, workers, trim):
    """Every batch of an epoch, held on the card while the pool's two pinned
    canvases are recycled a dozen times, equals the CPU loader's batch: no
    canvas went back to the pool before its copy completed."""
    from moco_tpu_torch.data import loader

    ds = _StagedExtents(24 * 32)

    def collect(device):
        it = loader.epoch_loader(ds, 0, 0, 32, device, workers=workers, depth=2,
                                 trim_h2d=trim)
        try:
            return list(it)
        finally:
            it.close_quietly()

    ref = collect("cpu")
    got = collect(cuda)
    torch.cuda.synchronize()
    assert len(got) == len(ref) == 24
    for r, g in zip(ref, got):
        assert all(t.is_cuda for t in g)
        assert all(torch.equal(a, b.cpu()) for a, b in zip(r, g))
    assert got[0][0].shape[1:3] == ((192, 128) if trim else (192, 192))


def test_prefetched_batch_outlives_its_copy_stream(cuda):
    """A batch staged on the copy stream and used on the default stream
    stays valid after the loader moved on (record_stream): a kernel that
    reads it long after gives the staged bytes."""
    from moco_tpu_torch.data import loader

    ds = _StagedExtents(8 * 32)
    it = loader.epoch_loader(ds, 0, 0, 32, cuda, workers=2, depth=2)
    try:
        batches = iter(it)
        first = next(batches)
        total = first[0].sum(dtype=torch.int64)
        rest = [b[0].float().mean() for b in batches]
    finally:
        it.close_quietly()
    order = loader.epoch_permutation(len(ds), 0, 0, 32)
    want = torch.from_numpy(ds.get_batch(order[:32])[0]).sum(dtype=torch.int64)
    assert int(total) == int(want) and len(rest) == 7


def test_full_state_round_trip_on_the_card(cuda, tmp_path):
    """A tiny pretrain state on the card after two steps (momentum buffers,
    the queue, both CUDA generators moved), saved and restored into a
    fresh state on the card: every tensor and both generator states bit
    for bit, and the next draws of both generators equal."""
    import numpy as np

    from moco_tpu_torch import checkpoint as ckpt
    from moco_tpu_torch.config import get_preset
    from moco_tpu_torch.train_state import create_train_state
    from moco_tpu_torch.train_step import build_encoder, build_train_step

    config = get_preset("imagenet-moco-v2").replace(
        arch="resnet_tiny", image_size=32, batch_size=8, num_negatives=32, embed_dim=16,
        compute_dtype="float32")

    def state(seed, steps):
        s = create_train_state(config, build_encoder(config), cuda, seed=seed)
        step = build_train_step(config, steps_per_epoch=4)
        rng = np.random.RandomState(seed)
        for _ in range(steps):
            im = torch.from_numpy(rng.randn(2, 8, 32, 32, 3).astype(np.float32)).to(cuda)
            step(s, im[0], im[1])
            torch.rand(3, generator=s.data_generator, device=cuda)
        return s

    saved = state(0, 2)
    mgr = ckpt.checkpoint_manager(str(tmp_path))
    ckpt.save_checkpoint(mgr, saved, saved.step, position=(0, 2))
    got = ckpt.restore_checkpoint(mgr, state(3, 0))
    for name in ("model_q", "model_k"):
        a, b = getattr(got, name).state_dict(), getattr(saved, name).state_dict()
        assert all(a[k].is_cuda and torch.equal(a[k], b[k]) for k in b)
    oa, ob = got.optimizer.state_dict()["state"], saved.optimizer.state_dict()["state"]
    assert oa.keys() == ob.keys() and all(
        oa[i]["momentum_buffer"].is_cuda
        and torch.equal(oa[i]["momentum_buffer"], ob[i]["momentum_buffer"]) for i in ob)
    assert got.queue.is_cuda and torch.equal(got.queue, saved.queue)
    assert (got.step, got.queue_ptr) == (saved.step, saved.queue_ptr) == (2, 16)
    for g in ("generator", "data_generator"):
        a, b = getattr(got, g), getattr(saved, g)
        assert a.device.type == "cuda" and torch.equal(a.get_state(), b.get_state())
        assert torch.equal(torch.rand(5, generator=a, device=cuda),
                           torch.rand(5, generator=b, device=cuda))


@pytest.mark.parametrize("chunk", [None, 1024])
def test_knn_accuracy_on_the_card_equals_the_cpu(cuda, chunk):
    """Unit features drawn so that no query has a near-tie at its k-th
    neighbour: the card's predictions and accuracy equal the CPU's on the
    same features, with the bank whole and streamed in chunks."""
    from moco_tpu_torch.ops import knn

    gen = torch.Generator().manual_seed(0)
    bank = torch.randn(4096, 64, generator=gen)
    feats = torch.randn(700, 64, generator=gen)
    bank_labels = torch.randint(0, 10, (4096,), generator=gen)
    labels = torch.randint(0, 10, (700,), generator=gen)
    sims = knn.l2_normalize(feats.double()) @ knn.l2_normalize(bank.double()).T
    top = sims.topk(201, dim=1).values
    assert float((top[:, 199] - top[:, 200]).min()) > 1e-6
    args = dict(num_classes=10, k=200, temperature=0.07, batch=256, bank_chunk=chunk)
    ref = knn.knn_accuracy(feats, labels, bank, bank_labels, **args)
    got = knn.knn_accuracy(feats.to(cuda), labels.to(cuda), bank.to(cuda),
                           bank_labels.to(cuda), **args)
    pred_cpu = knn.knn_predict(feats, bank, bank_labels, 10, bank_chunk=chunk)
    pred_gpu = knn.knn_predict(feats.to(cuda), bank.to(cuda), bank_labels.to(cuda), 10,
                               bank_chunk=chunk)
    assert torch.equal(pred_gpu.cpu(), pred_cpu) and got == ref


def test_one_rank_nccl_step_equals_the_one_card_step(cuda, tmp_path):
    """A tiny pretrain state stepped three times in a one-rank NCCL group
    (a FileStore rendezvous) and three times with no group, from the same
    state on the same images under deterministic cuDNN: losses, queue and
    both encoders equal bit for bit, and the group's step made its
    collectives."""
    import numpy as np
    import torch.distributed as dist

    from moco_tpu_torch.config import get_preset
    from moco_tpu_torch.parallel.mesh import init_distributed, process_group, \
        shutdown_distributed
    from moco_tpu_torch.train_state import create_train_state
    from moco_tpu_torch.train_step import build_encoder, build_train_step

    config = get_preset("imagenet-moco-v2").replace(
        arch="resnet_tiny", image_size=32, batch_size=8, num_negatives=32, embed_dim=16,
        compute_dtype="float32")
    rng = np.random.RandomState(0)
    images = [torch.from_numpy(rng.randn(2, 8, 32, 32, 3).astype(np.float32)).to(cuda)
              for _ in range(3)]

    def run(group):
        s = create_train_state(config, build_encoder(config), cuda, seed=0)
        step = build_train_step(config, steps_per_epoch=4, group=group)
        losses = [step(s, im[0], im[1])["loss"] for im in images]
        return torch.stack(losses), s

    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        alone_losses, alone = run(None)
        init_distributed(cuda, rank=0, world_size=1,
                         init_method=f"file://{tmp_path / 'store'}")
        calls = []
        reduce = dist.all_reduce
        dist.all_reduce = lambda *a, **kw: calls.append(1) or reduce(*a, **kw)
        try:
            group_losses, grouped = run(process_group())
            torch.cuda.synchronize()
        finally:
            dist.all_reduce = reduce
            shutdown_distributed()
    finally:
        torch.backends.cudnn.deterministic = deterministic
    assert len(calls) == 3 * 3  # gradients, BN statistics, metrics
    assert torch.equal(group_losses, alone_losses)
    assert torch.equal(grouped.queue, alone.queue)
    for name in ("model_q", "model_k"):
        a, b = getattr(grouped, name).state_dict(), getattr(alone, name).state_dict()
        assert all(torch.equal(a[k], b[k]) for k in b), name


@pytest.mark.parametrize("wire", ["int8", "bfloat16"])
def test_quantized_mean_and_demo_sync_on_the_card_equal_the_cpu(cuda, wire):
    """With no group (one process): `quantized_mean` on the card gives the
    CPU's means and errors bit for bit, and DeMo's `GradSync.finish` the
    CPU's merged gradient and residues (continuous draws: no top-k ties)."""
    from types import SimpleNamespace

    from moco_tpu_torch.config import PretrainConfig
    from moco_tpu_torch.parallel.collectives import quantized_mean
    from moco_tpu_torch.parallel.gradsync import GradSync

    gen = torch.Generator().manual_seed(3)
    segs = [torch.randn(n, generator=gen) * 10.0 ** e for n, e in ((1, 0), (4097, -3),
                                                                      (300000, -6))]
    cpu = quantized_mean(segs, None, wire)
    card = quantized_mean([s.to(cuda) for s in segs], None, wire)
    for a, b in zip(cpu, card):
        assert all(torch.equal(x, y.cpu()) for x, y in zip(a, b))

    def demo(device):
        module = torch.nn.Module()
        acc = {}
        for i, shape in enumerate(((64,), (256, 64, 3, 3), (2048, 128))):
            g = torch.Generator().manual_seed(10 + i)
            p = torch.nn.Parameter(torch.zeros(shape, device=device))
            p.grad = torch.randn(shape, generator=g).to(device)
            module.register_parameter(f"p{i}", p)
            acc[f"p{i}"] = torch.randn(shape, generator=g).to(device)
        state = SimpleNamespace(model_q=module, gradsync=acc, gradsync_mode="demo", step=0)
        GradSync(PretrainConfig(grad_sync="demo"), None).finish(state)
        return ({k: p.grad.cpu() for k, p in module.named_parameters()},
                {k: a.cpu() for k, a in state.gradsync.items()})

    for a, b in zip(demo("cpu"), demo(cuda)):
        assert all(torch.equal(a[k], b[k]) for k in a)


def test_one_rank_nccl_sync_modes(cuda, tmp_path):
    """A tiny pretrain in a one-rank NCCL group, 3 steps of each mode under
    deterministic cuDNN: `bucketed` (its reduces launched from the
    backward's hooks) and `zero_sharding` equal `fused` bit for bit; the
    quantized and DeMo runs give finite losses and nonzero accumulators."""
    import numpy as np

    from moco_tpu_torch.config import get_preset
    from moco_tpu_torch.parallel.gradsync import GradSync
    from moco_tpu_torch.parallel.mesh import init_distributed, process_group, \
        shutdown_distributed
    from moco_tpu_torch.train_state import create_train_state
    from moco_tpu_torch.train_step import build_encoder, build_train_step

    base = get_preset("imagenet-moco-v2").replace(
        arch="resnet_tiny", image_size=32, batch_size=8, num_negatives=32, embed_dim=16,
        compute_dtype="float32", grad_sync_bucket_mb=0.01)
    rng = np.random.RandomState(0)
    images = [torch.from_numpy(rng.randn(2, 8, 32, 32, 3).astype(np.float32)).to(cuda)
              for _ in range(3)]

    def run(group, **overrides):
        config = base.replace(**overrides)
        s = create_train_state(config, build_encoder(config), cuda, seed=0, group=group)
        GradSync(config, group).attach(s)
        step = build_train_step(config, steps_per_epoch=4, group=group)
        losses = torch.stack([step(s, im[0], im[1])["loss"] for im in images])
        return losses, s

    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    init_distributed(cuda, rank=0, world_size=1, init_method=f"file://{tmp_path / 'store'}")
    try:
        group = process_group()
        ref_losses, ref = run(group)
        for overrides in (dict(grad_sync="bucketed"), dict(zero_sharding=True)):
            losses, s = run(group, **overrides)
            assert torch.equal(losses, ref_losses), overrides
            assert torch.equal(s.queue, ref.queue), overrides
            for name in ("model_q", "model_k"):
                a, b = getattr(s, name).state_dict(), getattr(ref, name).state_dict()
                assert all(torch.equal(a[k], b[k]) for k in b), (overrides, name)
            sa, sb = s.optimizer.state_dict()["state"], ref.optimizer.state_dict()["state"]
            assert all(torch.equal(sa[i]["momentum_buffer"], sb[i]["momentum_buffer"])
                       for i in sb), overrides
        for overrides in (dict(grad_sync="quantized"),
                          dict(grad_sync="quantized", grad_sync_quant_dtype="bfloat16"),
                          dict(grad_sync="demo", grad_sync_cadence=2)):
            losses, s = run(group, **overrides)
            assert bool(torch.isfinite(losses).all()), overrides
            assert any(bool(a.any()) for a in s.gradsync.values()), overrides
    finally:
        shutdown_distributed()
        torch.backends.cudnn.deterministic = deterministic


def test_vit_and_heads_on_the_card_match_the_cpu(cuda):
    """ViT-S/16 in f32 (TF32 off) at 224 px, and the v3 heads (projector and
    predictor, batch 64), card vs CPU from the same weights: the forward and
    the parameter gradients of a fixed linear function of the output. Each
    tensor within 1e-4 of its largest entry, plus 4x what a 1e-6 nudge of
    the weights moves it on the CPU: gradients that are zero in exact
    arithmetic (the key biases) or cancel through the heads' BatchNorms are
    float noise on both devices."""
    from moco_tpu_torch.models.heads import V3Predictor, V3Projector
    from moco_tpu_torch.models.vit import build_vit

    gen = torch.Generator().manual_seed(0)
    x = torch.randn(4, 224, 224, 3, generator=gen)
    w = torch.randn(4, 384, generator=gen)
    z = torch.randn(64, 384, generator=gen)
    wz = torch.randn(64, 256, generator=gen)
    res = {}
    for dev, nudge in (("cpu", 0.0), ("nudged", 1e-6), ("cuda", 0.0)):
        vit = build_vit("vit_small", generator=torch.Generator().manual_seed(1))
        heads = torch.nn.Sequential(
            V3Projector(384, generator=torch.Generator().manual_seed(2)),
            V3Predictor(256, generator=torch.Generator().manual_seed(3)))
        noise = torch.Generator().manual_seed(9)
        with torch.no_grad():
            for p in [*vit.parameters(), *heads.parameters()]:
                p.mul_(1 + nudge * torch.randn(p.shape, generator=noise))
        on = cuda if dev == "cuda" else torch.device("cpu")
        vit, heads = vit.to(on), heads.to(on)
        out = vit(x.to(on))
        (out * w.to(on)).sum().backward()
        hout = heads(z.to(on))
        (hout * wz.to(on)).sum().backward()
        res[dev] = {"vit": out.detach().cpu(), "heads": hout.detach().cpu(), **{
            pre + n: p.grad.cpu() for m, pre in ((vit, "vit."), (heads, "heads."))
            for n, p in m.named_parameters() if p.grad is not None}}
    assert "vit.patch_embed.weight" not in res["cpu"]
    for k, ref in res["cpu"].items():
        floor = float((res["nudged"][k] - ref).abs().max())
        diff = float((res["cuda"][k] - ref).abs().max())
        assert diff <= 4 * floor + 1e-4 * float(ref.abs().max()), (k, diff, floor)


def test_v3_step_and_solarizing_view_on_the_card(cuda):
    """The v3 view pair on the card launches the blur kernel twice (view 2
    on the [0, 1] image before solarize) and agrees with the CPU's plain
    blur from the same draws; two v3 ViT steps (bf16, AdamW) on the card
    give finite losses and leave the frozen patch embedding as it was."""
    from moco_tpu_torch.config import get_preset
    from moco_tpu_torch.data import augment as aug
    from moco_tpu_torch.train_state import create_train_state
    from moco_tpu_torch.train_step import build_encoder, build_train_step

    u8 = torch.randint(0, 256, (8, 224, 224, 3), dtype=torch.uint8,
                       generator=torch.Generator().manual_seed(0))
    ext = torch.full((8,), 224.0)
    pair = aug.v3_aug_configs(224)
    gen = torch.Generator().manual_seed(1)
    draws = [aug.sample_view(ext, ext, c, gen) for c in pair]
    before = blur.gaussian_blur_batch.launches
    views = {}
    for dev in ("cpu", cuda):
        moved = [dataclasses.replace(p, **{f.name: None if getattr(p, f.name) is None
                                           else getattr(p, f.name).to(dev)
                                           for f in dataclasses.fields(p)}) for p in draws]
        views[str(dev)] = [aug.apply_view(u8.to(dev), p, c).cpu() for p, c in zip(moved, pair)]
    assert blur.gaussian_blur_batch.launches == before + 2
    for got, ref in zip(views["cuda"], views["cpu"]):
        # the crop's f32 source positions (see chip_smoke.py V3_VIEW_RTOL)
        assert float((got - ref).abs().max() / ref.abs().max()) <= 5e-4
    config = get_preset("imagenet-moco-v3-vits").replace(batch_size=8, image_size=224)
    state = create_train_state(config, build_encoder(config), cuda)
    patch = state.model_q.backbone.patch_embed.weight.detach().clone()
    step = build_train_step(config, steps_per_epoch=4)
    for _ in range(2):
        m = step(state, *(v.to(cuda) for v in views["cpu"]))
        assert torch.isfinite(m["loss"]).item()
    assert torch.equal(state.model_q.backbone.patch_embed.weight, patch)
