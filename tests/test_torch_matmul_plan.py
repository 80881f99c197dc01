"""The launch plans of the bf16 1x1 pair (`csrc/matmul_fwd.cu` behind
`bn_relu_matmul`, `csrc/matmul_dw.cu` behind `bn_relu_matmul_dw`) and their
block decompositions, on the CPU.

The kernels cannot run here, so their index arithmetic is held through a
pure-torch emulation of what each block does. Forward: the plan's M tiles
and N spans, the x panel of 64-channel chunks in its slots (copied and
normalized once where resident, at every N tile where streaming; rows past
M and channels past K zero), and W tiles zero past K and N. dW: the row
chunks of each slab (rows past the slab zero in z and dy), each cluster's
on-chip sum in rank order over the ranks' shares of the tile, and the
global sum of the cluster partials in group order. The emulations are held
against `bn_relu_matmul_plain` / `bn_relu_matmul_dw_plain` and against the
JAX package's Pallas kernels in interpret mode on the same numpy inputs."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moco_tpu.ops import pallas_fused_conv
from moco_tpu_torch.ops import fused_conv
from moco_tpu_torch.ops.fused_conv import (
    MM_CHUNK,
    MM_MAX_CLUSTER,
    MM_PLAN_CLUSTER,
    MM_SM_SMEM,
    MM_SMEM_LIMIT,
    MM_SMS,
    MM_STAGING_BYTES,
    MM_STREAM_SLOTS,
    MM_W_STAGES,
    MatmulDwPlan,
    MatmulFwdPlan,
    matmul_dw_plan,
    matmul_fwd_plan,
)

# [M, K, N] of the four R50 batch-256 conv3s (and their dW)
R50_SHAPES = {"layer1": (256 * 56 * 56, 64, 256), "layer2": (256 * 28 * 28, 128, 512),
              "layer3": (256 * 14 * 14, 256, 1024), "layer4": (256 * 7 * 7, 512, 2048)}
RAGGED = {"k72_n200": (4097, 72, 200), "k24_n40": (96, 24, 40), "k16_n8": (4097, 16, 8),
          "k640_n136": (300, 640, 136), "k512_n2048_m777": (777, 512, 2048),
          "k1024_n300": (5000, 1024, 300)}
ALL_SHAPES = {**R50_SHAPES, **RAGGED}


@pytest.mark.parametrize("name", list(ALL_SHAPES))
def test_fwd_plan_rules(name):
    m, k, n = ALL_SHAPES[name]
    plan = matmul_fwd_plan(m, k, n)
    assert plan.smem_bytes <= MM_SMEM_LIMIT
    assert plan.bn == (64 if n <= 64 else 128)           # N tiles sized to N
    assert plan.bm * plan.bn == 128 * 128                # 64 f32 accumulators a thread
    assert plan.span % plan.bn == 0 and plan.span_tiles <= plan.tiles_n
    assert plan.slots >= plan.k_chunks or plan.slots >= MM_STREAM_SLOTS
    assert plan.smem_bytes == plan.slots * plan.bm * (MM_CHUNK + 8) * 2 + \
        MM_W_STAGES * MM_CHUNK * (plan.bn + 8) * 2 + MM_STAGING_BYTES
    assert plan.blocks_per_sm * (plan.smem_bytes + 1024) <= MM_SM_SMEM
    if plan.resident:
        # x is read, and normalized, at most ceil(N / span) times
        assert plan.normalizations == -(-n // plan.span)
    if name in R50_SHAPES:
        assert plan.resident
        assert plan.blocks >= MM_SMS                     # at least one full wave
        assert plan.normalizations <= 4
        if n >= 512:
            assert plan.span >= 512


def test_fwd_plan_r50_normalizations():
    """Layers 1-3 normalize x once, layer 4 four times (once per 128-wide N
    tile would be 16 times at layer 4)."""
    got = [matmul_fwd_plan(*R50_SHAPES[f"layer{i}"]).normalizations for i in range(1, 5)]
    assert got == [1, 1, 1, 4]


@pytest.mark.parametrize("name", list(ALL_SHAPES))
def test_dw_plan_rules(name):
    m, k, n = ALL_SHAPES[name]
    plan = matmul_dw_plan(m, k, n)
    assert plan.smem_bytes <= MM_SMEM_LIMIT
    assert plan.bko == (64 if k <= 64 else 128)          # no half-empty products at K = 64
    assert plan.bko * plan.bn == 128 * 128
    assert 1 <= plan.cluster <= MM_PLAN_CLUSTER <= MM_MAX_CLUSTER
    assert plan.slabs % plan.cluster == 0
    assert (plan.slabs - 1) * plan.rows_per_slab < m     # no slab is empty
    assert plan.slabs * plan.rows_per_slab >= m          # the slabs cover every row
    # the f32 tile overlays the ring
    assert plan.smem_bytes >= plan.bko * (plan.bn + 8) * 4
    # partials through HBM: at most 1/8 of the bytes of x and dy
    assert 8 * plan.partial_bytes <= (m * k + m * n) * 2
    if name in R50_SHAPES:
        assert plan.blocks >= MM_SMS


def test_dw_plan_r50_partials_shrink():
    """The partials through HBM stay under an eighth of x + dy at every
    layer; at layer 4 they are one 4.2 MB partial (the first cluster of a
    tile writes dW itself)."""
    for name, (m, k, n) in R50_SHAPES.items():
        plan = matmul_dw_plan(m, k, n)
        assert 8 * plan.partial_bytes <= (m * k + m * n) * 2, name
    assert matmul_dw_plan(*R50_SHAPES["layer4"]).partial_bytes == 512 * 2048 * 4


def _inputs(shape, seed, dtype=torch.float32):
    m, k, n = shape
    rng = np.random.RandomState(seed)
    x = rng.randn(m, k).astype(np.float32)
    a = (1.0 + 0.1 * rng.randn(k)).astype(np.float32)
    b = (0.1 * rng.randn(k)).astype(np.float32)
    w = (0.1 * rng.randn(k, n)).astype(np.float32)
    dy = rng.randn(m, n).astype(np.float32)
    return (x, a, b, w, dy), [torch.from_numpy(v) for v in (x, a, b, w, dy)]


def _emulate_fwd(plan: MatmulFwdPlan, x, a, b, w, dtype=torch.float32):
    """What the blocks of the panel kernel compute, in f32 from the operand
    dtype: per block, the panel slots filled chunk by chunk (zero past M and
    K) at the steps that copy them, each step multiplying its slot by W's
    [64, bn] tile (zero past K and N), the N tile stored after its last
    chunk."""
    m, k = x.shape
    n = w.shape[1]
    kpad, npad = plan.k_chunks * MM_CHUNK, plan.tiles_n * plan.bn
    wt = torch.zeros(kpad, npad)
    wt[:k, :n] = w.to(dtype).float()
    y = torch.full((plan.tiles_m * plan.bm, npad), float("nan"))
    for block in range(plan.blocks):
        mt, _ = plan.block_tiles(block)
        m0 = mt * plan.bm
        slots = [None] * plan.slots  # (chunk, [bm, 64] z)
        acc = torch.zeros(plan.bm, plan.bn)
        for t, c, slot, fresh in plan.steps(block):
            if fresh:
                z = torch.zeros(plan.bm, MM_CHUNK)
                rows = x[m0:m0 + plan.bm, c * MM_CHUNK:(c + 1) * MM_CHUNK]
                z[:rows.shape[0], :rows.shape[1]] = torch.relu(
                    rows.float() * a[c * MM_CHUNK:c * MM_CHUNK + rows.shape[1]] +
                    b[c * MM_CHUNK:c * MM_CHUNK + rows.shape[1]]).to(dtype).float()
                slots[slot] = (c, z)
            held, z = slots[slot]
            assert held == c  # the slot holds this step's chunk
            acc += z @ wt[c * MM_CHUNK:(c + 1) * MM_CHUNK, t * plan.bn:(t + 1) * plan.bn]
            if c == plan.k_chunks - 1:
                y[m0:m0 + plan.bm, t * plan.bn:(t + 1) * plan.bn] = acc
                acc = torch.zeros(plan.bm, plan.bn)
    return y[:m, :n]


def _fwd_plans(shape):
    """The plan's own choice, and forced variants: one N tile a span, and
    streaming slots (resident where K fits in them)."""
    plan = matmul_fwd_plan(*shape)
    return [plan, dataclasses.replace(plan, span=plan.bn),
            dataclasses.replace(plan, slots=MM_STREAM_SLOTS)]


FWD_EMULATED = [(96, 24, 40), (300, 328, 300), (257, 72, 200), (130, 136, 520), (64, 8, 16)]


@pytest.mark.parametrize("variant", [0, 1, 2])
@pytest.mark.parametrize("shape", FWD_EMULATED)
def test_fwd_decomposition_matches_plain_and_pallas(shape, variant):
    (x, a, b, w, _), (xt, at, bt, wt, _) = _inputs(shape, sum(shape) + variant)
    plan = _fwd_plans(shape)[variant]
    got = _emulate_fwd(plan, xt, at, bt, wt)
    plain = fused_conv.bn_relu_matmul_plain(xt, at, bt, wt, torch.float32)
    pallas = torch.from_numpy(np.array(pallas_fused_conv.bn_relu_matmul(
        *map(jnp.asarray, (x, a, b, w)), out_dtype=jnp.float32, interpret=True)))
    # f32 sums of the same products in another order: 1e-5 of sum |z||w|
    tol = 1e-5 * fused_conv.bn_relu_matmul_plain(xt, at, bt, wt.abs(), torch.float32) + 1e-6
    for ref in (plain, pallas):
        assert got.shape == ref.shape
        assert bool(((got - ref).abs() <= tol).all()), float((got - ref).abs().max())


@pytest.mark.parametrize("shape", [(300, 200, 300), (257, 72, 200)])
def test_fwd_decomposition_bf16_within_one_ulp(shape):
    """bf16 operands and a bf16 output: the emulation rounds its f32 sum
    once, within one bf16 ulp of the plain version's f32 result."""
    _, (xt, at, bt, wt, _) = _inputs(shape, 7)
    xb, wb = xt.bfloat16(), wt.bfloat16()
    got = _emulate_fwd(matmul_fwd_plan(*shape), xb, at, bt, wb, torch.bfloat16).bfloat16()
    ref = fused_conv.bn_relu_matmul_plain(xb, at, bt, wb, torch.float32)
    tol = 1e-5 * fused_conv.bn_relu_matmul_plain(xb, at, bt, wb.abs(), torch.float32) + \
        2.0 ** -7 * ref.abs() + 1e-6
    assert bool(((got.float() - ref).abs() <= tol).all())


def test_fwd_streaming_copies_every_n_tile():
    """Three streaming slots copy each chunk again for every N tile; a
    resident panel copies each chunk once per block."""
    plan = dataclasses.replace(matmul_fwd_plan(300, 328, 300), span=384)  # three N tiles
    assert plan.resident and plan.k_chunks == 6
    steps = plan.steps(0)
    assert [s[3] for s in steps] == [True] * 6 + [False] * (len(steps) - 6)
    stream = dataclasses.replace(plan, slots=MM_STREAM_SLOTS)
    assert not stream.resident and all(s[3] for s in stream.steps(0))
    assert [s[2] for s in stream.steps(0)][:8] == [0, 1, 2, 0, 1, 2, 0, 1]


def test_fwd_zero_rows_and_channels_not_relu_of_b():
    """x = 0 and b = 1 give z = 1 inside; rows past M and channels past K
    must hold 0 in the panel, so each output is K, not the padded width."""
    x, a, b, w = torch.zeros(70, 10), torch.ones(10), torch.ones(10), torch.ones(10, 20)
    got = _emulate_fwd(matmul_fwd_plan(70, 10, 20), x, a, b, w)
    torch.testing.assert_close(got, torch.full((70, 20), 10.0))


def _rank_shares(plan: MatmulDwPlan):
    """[lo, hi) of the tile's float4 elements that each rank of a cluster
    sums, as the kernel splits them."""
    total = plan.bko * plan.bn // 4
    return [(r * total // plan.cluster, (r + 1) * total // plan.cluster)
            for r in range(plan.cluster)]


def _emulate_dw(plan: MatmulDwPlan, x, a, b, dy, dtype=torch.float32):
    """What the blocks of the row-walk kernel compute, in f32 from the
    operand dtype, all K and N at once (the tiles only split the columns):
    per slab, its rows in chunks of 64 (zero past the slab in z and dy);
    per cluster, the ranks' shares summed over the ranks in rank order; the
    later clusters' partials added to the first cluster's sum in group
    order."""
    m, k = x.shape
    n = dy.shape[1]
    z = torch.relu(x.float() * a + b).to(dtype).float()
    dyf = dy.to(dtype).float()
    slab_parts = []
    for slab in range(plan.slabs):
        rows = plan.slab_rows(slab)
        acc = torch.zeros(k, n)
        for p0 in range(rows.start, rows.stop, MM_CHUNK):
            zc, dc = torch.zeros(MM_CHUNK, k), torch.zeros(MM_CHUNK, n)
            p1 = min(p0 + MM_CHUNK, rows.stop)
            zc[:p1 - p0], dc[:p1 - p0] = z[p0:p1], dyf[p0:p1]
            acc += zc.t() @ dc
        slab_parts.append(acc)
    partials = []
    for group in range(plan.groups):
        ranks = slab_parts[group * plan.cluster:(group + 1) * plan.cluster]
        total = ranks[0] * 0
        for part in ranks:  # every rank's share: the same order
            total = total + part
        partials.append(total)
    out = partials[0]
    for part in partials[1:]:
        out = out + part
    return out


def _dw_plans(shape):
    plan = matmul_dw_plan(*shape)
    m, k, n = shape
    bko = 64 if k <= 64 else 128
    return [plan, MatmulDwPlan(m, k, n, bko, 6, 2), MatmulDwPlan(m, k, n, bko, 8, 8),
            MatmulDwPlan(m, k, n, bko, 3, 3)]


DW_EMULATED = [(96, 24, 40), (3001, 72, 200), (4097, 16, 8), (1000, 136, 72)]


@pytest.mark.parametrize("variant", [0, 1, 2, 3])
@pytest.mark.parametrize("shape", DW_EMULATED)
def test_dw_decomposition_matches_plain_and_pallas(shape, variant):
    plan = _dw_plans(shape)[variant]
    if (plan.slabs - 1) * plan.rows_per_slab >= plan.m:
        plan = dataclasses.replace(plan, slabs=plan.cluster)   # keep every slab non-empty
    (x, a, b, _, dy), (xt, at, bt, _, dyt) = _inputs(shape, sum(shape) * 3 + variant)
    got = _emulate_dw(plan, xt, at, bt, dyt)
    plain = fused_conv.bn_relu_matmul_dw_plain(xt, at, bt, dyt)
    pallas = torch.from_numpy(np.array(pallas_fused_conv.bn_relu_matmul_dw(
        *map(jnp.asarray, (x, a, b, dy)), interpret=True)))
    # f32 sums of the same products in another order: 1e-5 of sum |z||dy|
    tol = 1e-5 * fused_conv.bn_relu_matmul_dw_plain(xt, at, bt, dyt.abs()) + 1e-6
    for ref in (plain, pallas):
        assert got.shape == ref.shape
        assert bool(((got - ref).abs() <= tol).all()), float((got - ref).abs().max())


@pytest.mark.parametrize("name", list(ALL_SHAPES))
def test_dw_rank_shares_tile_the_tile(name):
    """The ranks of a cluster split the tile into disjoint shares that cover
    it, each a run of whole float4s."""
    plan = matmul_dw_plan(*ALL_SHAPES[name])
    for cluster in range(1, MM_MAX_CLUSTER + 1):
        shares = _rank_shares(dataclasses.replace(plan, cluster=cluster, slabs=cluster))
        assert shares[0][0] == 0 and shares[-1][1] == plan.bko * plan.bn // 4
        assert all(lo <= hi and hi == nxt for (lo, hi), (nxt, _) in zip(shares, shares[1:]))


def test_dw_rows_past_the_slab_are_zero_in_z_and_dy():
    """x = 0 and b = 1 give z = 1 on every real row; padded rows of the last
    chunk must be 0 in z and dy, so dW counts the real rows only."""
    x, a, b, dy = torch.zeros(70, 8), torch.ones(8), torch.ones(8), torch.ones(70, 16)
    plan = MatmulDwPlan(70, 8, 16, 64, 2, 2)
    assert [len(plan.slab_rows(s)) for s in range(2)] == [35, 35]
    assert plan.chunks_per_slab == 1                      # 29 padded rows in each
    torch.testing.assert_close(_emulate_dw(plan, x, a, b, dy), torch.full((8, 16), 70.0))


def test_plans_are_frozen_records():
    """The plan functions cache their plans, so a plan must not change."""
    for plan in (matmul_fwd_plan(96, 24, 40), matmul_dw_plan(96, 24, 40)):
        with pytest.raises(dataclasses.FrozenInstanceError):
            plan.k = 1


def test_plans_reject_empty_shapes():
    with pytest.raises(ValueError):
        matmul_fwd_plan(0, 8, 8)
    with pytest.raises(ValueError):
        matmul_dw_plan(8, 0, 8)
