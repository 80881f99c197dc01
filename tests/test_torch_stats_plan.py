"""The launch plan of the BatchNorm reduction pair (`csrc/channel_stats.cu`
behind `channel_sums` / `channel_grad_sums`) and its block decomposition,
on the CPU.

The kernels cannot run here, so their index arithmetic is held through a
pure-torch emulation of what the blocks do under `stats_plan`: each row
lane sums its rows of the block's slab in row order (rows past the slab
add nothing), the row lanes of a warp fold by a shuffle butterfly, the
warps in warp order, and the last block of each channel tile sums the
tile's slab partials in lanes over the slabs, in slab order, then the
lanes in lane order. The emulation is held against
`channel_sums_plain` / `channel_grad_sums_plain` and against the JAX
package's Pallas kernels in interpret mode on the same numpy inputs.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moco_tpu.ops import pallas_stats
from moco_tpu_torch.ops import _build, stats
from moco_tpu_torch.ops.stats import (
    STATS_BLOCKS_PER_SM,
    STATS_LOADS,
    STATS_SEGMENT,
    STATS_SMS,
    STATS_THREADS,
    StatsPlan,
    stats_plan,
)

# [M, C] of the ResNet-50 BNs at batch 256, 224 px, and how many of each an
# encoder has
R50_BN_SHAPES = {
    "stem": ((3211264, 64), 1), "l1_64": ((802816, 64), 6), "l1_128": ((802816, 128), 1),
    "l1_256": ((802816, 256), 4), "l2_128": ((200704, 128), 7), "l2_256": ((200704, 256), 1),
    "l2_512": ((200704, 512), 5), "l3_256": ((50176, 256), 11), "l3_512": ((50176, 512), 1),
    "l3_1024": ((50176, 1024), 7), "l4_512": ((12544, 512), 5), "l4_2048": ((12544, 2048), 4),
}
# [M, C] of the ResNet-18 BNs with the CIFAR stem at batch 256, 32 px
# (`cifar10-moco-v1`), and how many of each an encoder has
R18_BN_SHAPES = {
    "s1_64": ((262144, 64), 5), "s2_128": ((65536, 128), 5), "s3_256": ((16384, 256), 5),
    "s4_512": ((4096, 512), 5),
}
RAGGED_M = (1, 7, 1000, 4097)
RAGGED_C = (1, 3, 24, 64, 2050)
OPERANDS = {"sums": 1, "grad": 2}


def _covers_once(plan: StatsPlan):
    rows = [r for s in range(plan.slabs) for r in plan.slab_rows(s)]
    assert rows == list(range(plan.m))               # every row once, in slab order
    chans = [ch for t in range(plan.tiles) for ch in plan.tile_channels(t)]
    assert chans == list(range(plan.c))              # every channel once
    assert all(len(plan.slab_rows(s)) for s in range(plan.slabs))  # no slab empty


def test_r50_encoder_has_53_bns():
    assert sum(n for _, n in R50_BN_SHAPES.values()) == 53


def test_r18_cifar_encoder_has_20_bns_at_these_shapes():
    """The port's ResNet-18 with the CIFAR stem feeds its BNs these [M, C]
    (a forward at batch 2, M scaled to batch 256)."""
    from collections import Counter

    from moco_tpu_torch.models.fast_bn import FastBatchNorm
    from moco_tpu_torch.models.resnet import build_resnet

    model = build_resnet("resnet18", cifar_stem=True, num_classes=128)
    seen = []
    for mod in model.modules():
        if isinstance(mod, FastBatchNorm):
            mod.register_forward_hook(lambda _m, a, _o: seen.append(
                (a[0].shape[0] * a[0].shape[2] * a[0].shape[3] * 128, a[0].shape[1])))
    model(torch.zeros(2, 32, 32, 3))  # NHWC images
    assert Counter(seen) == {shape: n for shape, n in R18_BN_SHAPES.values()}
    assert sum(n for _, n in R18_BN_SHAPES.values()) == 20


# (net, shape name, element bytes): ResNet-50 in bf16; ResNet-18@32
# (`cifar10-moco-v1`) in f32, its preset's dtype, and bf16, the horizon's
BN_PLANS = ([("r50", name, 2) for name in R50_BN_SHAPES]
            + [("r18", name, elem) for name in R18_BN_SHAPES for elem in (2, 4)])


@pytest.mark.parametrize("kind", list(OPERANDS))
@pytest.mark.parametrize("net, name, elem", BN_PLANS)
def test_plan_at_bn_shapes(net, name, elem, kind):
    """16-byte loads of 128-byte row segments, 8 loads in flight a thread,
    partials at most 2% of the input bytes, and a full wave (every SM busy,
    fewer than one tile's worth of its slots empty: 264 blocks where the
    tiles divide 264, 256 of 264 at 16 and 32 tiles) wherever M has the
    rows for it; where it has not (ResNet-18's [16384, 256] and
    [4096, 512] at 2 bytes), the wave is cut short only because each row
    lane holds a single batch of rows."""
    (m, c), _ = (R50_BN_SHAPES if net == "r50" else R18_BN_SHAPES)[name]
    plan = stats_plan(m, c, elem, OPERANDS[kind])
    _covers_once(plan)
    assert plan.vec * elem == 16 and plan.tile * elem == STATS_SEGMENT == 128
    assert plan.capacity == STATS_SMS * STATS_BLOCKS_PER_SM == 264
    assert plan.rows_per_slab >= plan.row_lanes * plan.batch
    assert plan.blocks <= plan.capacity
    if plan.blocks > plan.capacity - plan.tiles:  # a full wave
        assert plan.waves > 0.96 and plan.blocks >= plan.sms
        if plan.capacity % plan.tiles == 0:
            assert plan.waves == 1.0
    else:
        assert net == "r18" and elem == 2 and plan.rows_per_slab == plan.row_lanes * plan.batch
    assert plan.batch * OPERANDS[kind] == STATS_LOADS == 8  # loads in flight a thread
    assert 50 * plan.workspace_bytes <= OPERANDS[kind] * m * c * elem
    assert plan.fold_width == 4                      # the last block loads float4s
    assert plan.slabs * plan.tile <= 264 * 64        # partials a last block folds


@pytest.mark.parametrize("kind", list(OPERANDS))
@pytest.mark.parametrize("elem", [2, 4])
@pytest.mark.parametrize("c", RAGGED_C)
@pytest.mark.parametrize("m", RAGGED_M)
def test_plan_rules_at_ragged_shapes(m, c, elem, kind):
    plan = stats_plan(m, c, elem, OPERANDS[kind])
    _covers_once(plan)
    assert plan.vec * elem <= 16 and c % plan.vec == 0
    assert plan.lanes in (1, 2, 4, 8, 16, 32)
    assert plan.batch * OPERANDS[kind] == STATS_LOADS
    assert plan.slab_lanes * plan.tile == STATS_THREADS * plan.fold_width
    assert plan.lanes <= max(1, 2 * (c // plan.vec))  # no tile twice wider than C needs
    assert plan.blocks <= plan.capacity or plan.slabs == 1
    if plan.slabs < plan.capacity // plan.tiles:
        # short of a wave only where M has too few rows for another slab
        assert plan.rows_per_slab < 2 * plan.row_lanes * plan.batch


def test_plan_follows_alignment():
    assert [stats_plan(512, 64, 2, align=a).vec for a in (16, 8, 4, 2)] == [8, 4, 2, 1]
    assert [stats_plan(512, 64, 4, align=a).vec for a in (16, 8, 4)] == [4, 2, 1]
    assert stats_plan(512, 36, 2).vec == 4 and stats_plan(512, 2050, 2).vec == 2


def test_plan_fills_the_card_it_is_given():
    """An H100 PCIe (114 SMs) gets a wave of its own: no second, partial one."""
    plan = stats_plan(802816, 256, 2, sms=114)
    assert plan.blocks <= plan.capacity == 228 and plan.waves > 0.9
    _covers_once(plan)


def test_plan_rejects_empty_and_odd_elements():
    with pytest.raises(ValueError):
        stats_plan(0, 64, 2)
    with pytest.raises(ValueError):
        stats_plan(64, 64, 8)


def test_plans_are_frozen_records():
    with pytest.raises(dataclasses.FrozenInstanceError):
        stats_plan(4097, 64, 2).slabs = 3


def _emulate(plan: StatsPlan, ta: torch.Tensor, tb: torch.Tensor):
    """The kernel's order of additions for the per-element terms ta, tb
    [M, C] (x and x*x, or dy and dy*xhat), in f32."""
    m, c = ta.shape
    lanes_r, per_warp = plan.row_lanes, 32 // plan.lanes
    steps = -(-plan.rows_per_slab // lanes_r)
    slab_lanes = plan.slab_lanes
    out = []
    for t in (ta, tb):
        rows = torch.zeros(plan.slabs, steps * lanes_r, c)
        for s in range(plan.slabs):
            r = plan.slab_rows(s)
            rows[s, :len(r)] = t[r.start:r.stop]
        rows = rows.view(plan.slabs, steps, lanes_r, c)
        lane = torch.zeros(plan.slabs, lanes_r, c)
        for k in range(steps):                        # a lane's rows in row order
            lane = lane + rows[:, k]
        warp = lane.view(plan.slabs, STATS_THREADS // 32, per_warp, c)
        off = 1
        while off < per_warp:                         # the butterfly of shuffles
            warp = warp + warp[:, :, torch.arange(per_warp) ^ off]
            off *= 2
        part = torch.zeros(plan.slabs, c)
        for w in range(STATS_THREADS // 32):          # the warps in warp order
            part = part + warp[:, w, 0]
        fold = torch.zeros(slab_lanes, c)
        for s in range(plan.slabs):                   # lanes over the slabs, slab order
            fold[s % slab_lanes] += part[s]
        total = torch.zeros(c)
        for lane_s in range(slab_lanes):              # the lanes in lane order
            total = total + fold[lane_s]
        out.append(total)
    return out


def _inputs(m, c, seed):
    rng = np.random.RandomState(seed)
    x = (rng.randn(m, c) * 2 + 0.5).astype(np.float32)
    dy = rng.randn(m, c).astype(np.float32)
    mean = (0.3 * rng.randn(c)).astype(np.float32)
    rstd = (rng.rand(c) + 0.5).astype(np.float32)
    return x, dy, mean, rstd


def _assert_close(got, ref, scale):
    # f32 sums of the same terms in another order: 1e-5 of sum |term|
    for g, r, s in zip(got, ref, scale):
        g, r = torch.as_tensor(np.array(g)), torch.as_tensor(np.array(r))
        assert bool(((g - r).abs() <= 1e-5 * s).all()), float((g - r).abs().max())


@pytest.mark.parametrize("c", RAGGED_C)
@pytest.mark.parametrize("m", RAGGED_M)
def test_channel_sums_decomposition_matches_plain_and_pallas(m, c):
    x, _, _, _ = _inputs(m, c, m * 7 + c)
    xt = torch.from_numpy(x)
    got = _emulate(stats_plan(m, c, 4), xt, xt * xt)
    scale = (xt.abs().sum(0), (xt * xt).sum(0))
    _assert_close(got, stats.channel_sums_plain(xt), scale)
    _assert_close(got, pallas_stats.channel_sums(jnp.asarray(x), interpret=True), scale)


@pytest.mark.parametrize("c", RAGGED_C)
@pytest.mark.parametrize("m", RAGGED_M)
def test_channel_grad_sums_decomposition_matches_plain_and_pallas(m, c):
    x, dy, mean, rstd = _inputs(m, c, m * 11 + c)
    xt, dyt, mt, rt = map(torch.from_numpy, (x, dy, mean, rstd))
    term = dyt * ((xt - mt) * rt)
    got = _emulate(stats_plan(m, c, 4, 2), dyt, term)
    scale = (dyt.abs().sum(0), term.abs().sum(0))
    _assert_close(got, stats.channel_grad_sums_plain(dyt, xt, mt, rt), scale)
    _assert_close(got, pallas_stats.channel_grad_sums(*map(jnp.asarray, (dy, x, mean, rstd)),
                                                      interpret=True), scale)


@pytest.mark.parametrize("variant", ["lanes", "slabs", "one_slab"])
def test_forced_plans_decompose_the_same(variant):
    """Other tiles and slab counts than the plan's own give the same sums
    (the C entry point takes any plan that covers [M, C])."""
    m, c = 4097, 64
    x, _, _, _ = _inputs(m, c, 5)
    xt = torch.from_numpy(x)
    plan = stats_plan(m, c, 4)
    forced = {"lanes": dataclasses.replace(plan, lanes=1),
              "slabs": dataclasses.replace(plan, slabs=3),
              "one_slab": dataclasses.replace(plan, slabs=1)}[variant]
    _covers_once(forced)
    _assert_close(_emulate(forced, xt, xt * xt), stats.channel_sums_plain(xt),
                  (xt.abs().sum(0), (xt * xt).sum(0)))


def _refusing_library():
    raise AssertionError("the library was loaded: a launch was attempted")


@pytest.mark.parametrize("bad", ["rows", "channels", "pack", "batch", "slabs"])
@pytest.mark.parametrize("kind", list(OPERANDS))
def test_wrapper_refuses_a_plan_that_does_not_cover(monkeypatch, kind, bad):
    """A plan for other rows or channels, or with a pack, batch or slab
    count the kernel cannot take, raises before the kernel library is even
    loaded."""
    monkeypatch.setattr(_build, "load_library", _refusing_library)
    m, c = 1000, 64
    x = torch.zeros(m, c)
    plan = stats_plan(m, c, 4, OPERANDS[kind])
    wrong = {"rows": dataclasses.replace(plan, m=m - 1),
             "channels": dataclasses.replace(plan, c=c + 4),
             "pack": dataclasses.replace(plan, vec=8),
             "batch": dataclasses.replace(plan, batch=8 if kind == "grad" else 4),
             "slabs": dataclasses.replace(plan, slabs=70000)}[bad]
    before = (stats.channel_sums.launches, stats.channel_grad_sums.launches)
    with pytest.raises(ValueError, match="plan refused"):
        if kind == "sums":
            stats._launch_sums(x, wrong)
        else:
            stats._launch_grad_sums(x, x, torch.zeros(c), torch.ones(c), wrong)
    assert (stats.channel_sums.launches, stats.channel_grad_sums.launches) == before


def test_tickets_are_kept_per_stream_and_grow():
    dev = torch.device("cpu")
    first = stats.tickets(dev, 12345, 10)
    assert first.dtype == torch.int32 and first.numel() >= 10 and not bool(first.any())
    assert stats.tickets(dev, 12345, 20) is first       # the same counters, no new zeroing
    assert stats.tickets(dev, 54321, 10) is not first   # another stream, its own
    bigger = stats.tickets(dev, 12345, first.numel() + 1)
    assert bigger.numel() > first.numel()
    assert stats._TICKETS[(None, 12345)][0] is first     # the smaller set stays held
