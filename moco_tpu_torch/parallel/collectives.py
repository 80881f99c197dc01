"""ShuffleBN, the gathers and the gradient reduces across processes (port of
`moco_tpu/parallel/collectives.py`: `all_gather_batch`, `batch_shuffle`,
`batch_unshuffle`, `ring_shuffle`, `chained_psum`, `quantized_psum_mean`,
`multihop_quantized_psum_mean`) on `torch.distributed`.

Every function takes the process group (`parallel/mesh.py`); `group=None`
is one process, where the "global batch" is the local one and nothing is
communicated.

- The reference draws the shuffle permutation on rank 0 and broadcasts
  it. Here, as in the JAX package, every process draws the SAME
  permutation from a generator that every process seeds and advances
  alike (`TrainState.generator`, kept apart from the augmentation's), so
  no broadcast is needed. A caller may hand the permutation in instead.
- `batch_unshuffle` returns the unshuffled GLOBAL batch, in rank order:
  the keys the step enqueues on every process (the JAX step gets them as
  the sharded output of its region); `local_rows` is this process's part.
- `all_reduce_buckets` stands in for `chained_psum`: the JAX package ties
  each bucket's psum to the one before it so that XLA issues them in a
  fixed order; here each bucket's all-reduce is launched, in order, as soon
  as it is called, and returns its work handle.
- `quantized_mean` is `quantized_psum_mean`: int8 with one shared scale per
  segment (an all-reduce MAX of the stacked absmaxes), summed on an int32
  carrier, or bf16 summed in bf16; it returns the means and each process's
  own quantization error, in the JAX package's order of operations.
- `multihop_quantized_mean` is `multihop_quantized_psum_mean`, the two-hop
  reduce of the fsdp_tp layout: an exact f32 sum over the inner (fsdp)
  group, then `quantized_mean` of those sums over the outer (data) group,
  the means and errors divided by the inner group's size.
- Why ShuffleBN exists: with per-process BatchNorm, a query and its
  positive key normalized in one group would share batch statistics and
  leak which sample is the positive. Shuffling the key batch across
  processes before the key encoder decorrelates the groups; unshuffling
  after it restores the q/k alignment.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from moco_tpu_torch.parallel.mesh import rank, world_size


def all_gather_batch(x: torch.Tensor, group, chunks: int = 1) -> torch.Tensor:
    """The local batches of every process along dim 0, in rank order.

    `chunks > 1` splits the local batch into `chunks` row slices, each
    gathered as its own collective, all in flight at once, so a chunk can
    be on the wire while the next is issued; the result is restitched
    rank-major and equals the one gather bit for bit. A chunk count that
    does not divide the local batch gathers in one piece (a hint, never a
    shape constraint)."""
    if group is None:
        return x
    n = world_size(group)
    if chunks <= 1 or x.shape[0] % chunks:
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts)
    rows = x.shape[0] // chunks
    outs, works = [], []
    for c in range(chunks):
        part = x[c * rows:(c + 1) * rows].contiguous()
        out = [torch.empty_like(part) for _ in range(n)]
        works.append(dist.all_gather(out, part, group=group, async_op=True))
        outs.append(out)
    for w in works:
        w.wait()
    return torch.cat([outs[c][d] for d in range(n) for c in range(chunks)])


def local_rows(x_global: torch.Tensor, group) -> torch.Tensor:
    """This process's contiguous slice of a global batch."""
    b = x_global.shape[0] // world_size(group)
    r = rank(group)
    return x_global[r * b:(r + 1) * b]


def batch_shuffle(x: torch.Tensor, generator: torch.Generator | None, group=None,
                  chunks: int = 1, perm: torch.Tensor | None = None
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Shuffle the global batch across processes: gather it, draw one
    permutation of it from `generator` (or take `perm`), and keep this
    process's slice `perm[r*b:(r+1)*b]`. Returns (that slice of the
    batch, perm)."""
    x_all = all_gather_batch(x, group, chunks)
    if perm is None:
        perm = torch.randperm(x_all.shape[0], generator=generator, device=x.device)
    else:
        perm = perm.to(x.device)
    return x_all[local_rows(perm, group)], perm


def batch_unshuffle(x: torch.Tensor, perm: torch.Tensor, group=None,
                    chunks: int = 1) -> torch.Tensor:
    """Undo `batch_shuffle`: gather the shuffled slices and index them with
    the inverse permutation. Returns the unshuffled GLOBAL batch."""
    return all_gather_batch(x, group, chunks)[torch.argsort(perm)]


def _exchange(sends: list[tuple[torch.Tensor, int]], group) -> list[torch.Tensor]:
    """Send each `(tensor, shift)` to rank `r + shift` and receive its
    counterpart from rank `r - shift` (mod n), all in one batch of
    point-to-point ops; a shift onto this rank is a copy."""
    n, r = world_size(group), rank(group)
    ops, outs = [], []
    for t, shift in sends:
        dst, src = (r + shift) % n, (r - shift) % n
        if dst == r:
            outs.append(t.clone())
            continue
        buf = torch.empty_like(t)
        ops += [dist.P2POp(dist.isend, t, dst, group), dist.P2POp(dist.irecv, buf, src, group)]
        outs.append(buf)
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    return outs


def ring_shuffle(x: torch.Tensor, group, inverse: bool = False) -> torch.Tensor:
    """The cheaper ShuffleBN: a half-shard ring roll. Process i's new group
    is `[tail half of shard i-2, head half of shard i-1]`, so every
    key-side BN group mixes samples of two query-side groups (moving whole
    shards would leave each group's membership, and so the leak, as it
    was). `inverse=True` undoes it. An odd local batch raises; one process
    is the identity."""
    if x.shape[0] % 2:
        raise ValueError("ring_shuffle requires an even local batch")
    h = x.shape[0] // 2
    if h == 0 or group is None or world_size(group) == 1:
        return x
    head, tail = x[:h].contiguous(), x[h:].contiguous()
    if not inverse:
        recv_tail, recv_head = _exchange([(tail, 2), (head, 1)], group)
        return torch.cat([recv_tail, recv_head])
    # process j's tail sits as part 0 on process j+2, its head as part 1 on j+1
    back_tail, back_head = _exchange([(head, -2), (tail, -1)], group)
    return torch.cat([back_head, back_tail])


def all_reduce_buckets(flats: list[torch.Tensor], group) -> list:
    """Launch one SUM all-reduce per flat bucket, in list order, each in
    place and without waiting; returns the work handles (None with no
    group). Every process must call it with the same buckets in the same
    order."""
    if group is None:
        return [None] * len(flats)
    return [dist.all_reduce(f, group=group, async_op=True) for f in flats]


def int8_scales(segments: list[torch.Tensor], group) -> torch.Tensor:
    """One f32 scale per segment, the same on every process: the largest
    |value| of the segment over all processes (one all-reduce MAX of the
    stacked absmaxes) over 127. A scale follows its segment, not the
    bucket: a bucket spans layers whose gradients differ by orders of
    magnitude, and one bucket-wide scale would round the small ones to 0."""
    absmax = torch.stack([s.abs().max() for s in segments])
    if group is not None:
        dist.all_reduce(absmax, op=dist.ReduceOp.MAX, group=group)
    return absmax.clamp(min=1e-30) / 127.0


class PendingMean:
    """A `quantized_mean` whose sum is on the wire; `wait()` returns its
    `(means, errors)`, each divided by `fan_in` too where it is not 1 (the
    two-hop reduce's inner group)."""

    def __init__(self, work, summed, segments, qs, scales, n: int, wire_dtype: str):
        self.work, self.summed, self.segments, self.qs = work, summed, segments, qs
        self.scales, self.n, self.wire_dtype = scales, n, wire_dtype
        self.fan_in = 1  # `multihop_quantized_mean` sets its inner group's size

    def wait(self) -> tuple[list[torch.Tensor], list[torch.Tensor]]:
        if self.work is not None:
            self.work.wait()
        summed = self.summed if self.wire_dtype == "int8" else self.summed.float()
        means, errs, off = [], [], 0
        for i, (s, q) in enumerate(zip(self.segments, self.qs)):
            seg = summed[off:off + s.numel()]
            off += s.numel()
            if self.wire_dtype == "int8":
                means.append(seg.float() * self.scales[i] / self.n)
                errs.append(s - q.float() * self.scales[i])
            else:
                means.append(seg / self.n)
                errs.append(s - q.float())
        if self.fan_in != 1:
            means = [m / self.fan_in for m in means]
            errs = [e / self.fan_in for e in errs]
        return means, errs


def quantized_mean(segments: list[torch.Tensor], group, wire_dtype: str,
                   async_op: bool = False):
    """The mean over `group`'s processes of flat f32 `segments` (one per
    gradient leaf), sent compressed; returns `(means, errors)`, or with
    `async_op` a `PendingMean` whose one all-reduce is in flight.

    `int8`: `q = clamp(round(s / scale), -127, 127)` with the shared
    per-segment scales of `int8_scales`; the whole bucket rides one SUM on
    an int32 carrier (a sum of n int8 values overflows int8), so the sum is
    exact and the carrier is 4x the int8 payload the byte accounting counts;
    `mean = sum * scale / n`. `bfloat16`: cast, one SUM in bf16, back to
    f32, `/ n`. `errors` are this process's residuals, input minus what it
    put on the wire: the error-feedback accumulator adds them to the next
    step's gradient. `torch.round` rounds half to even, as `jnp.round`
    does."""
    n = world_size(group)
    scales = None
    if wire_dtype == "int8":
        scales = int8_scales(segments, group)
        qs = [torch.clamp(torch.round(s / scales[i]), -127, 127).to(torch.int8)
              for i, s in enumerate(segments)]
        flat = torch.cat(qs).to(torch.int32)
    elif wire_dtype == "bfloat16":
        qs = [s.to(torch.bfloat16) for s in segments]
        flat = torch.cat(qs)
    else:
        raise ValueError(f"unknown quantized wire dtype {wire_dtype!r}")
    work, = all_reduce_buckets([flat], group)
    pending = PendingMean(work, flat, segments, qs, scales, n, wire_dtype)
    return pending if async_op else pending.wait()


def multihop_quantized_mean(segments: list[torch.Tensor], inter_group, intra_group,
                            wire_dtype: str, async_op: bool = False):
    """The two-hop mean over every rank of the fsdp_tp layout (the JAX
    package's DynamiQ-style `multihop_quantized_psum_mean`): hop 1 sums the
    f32 `segments` exactly over `intra_group` (the fast links inside a
    node), hop 2 is `quantized_mean` of those sums over `inter_group` (the
    slow links between nodes), with its shared scales and int32 carrier.
    Returns `(means, errors)` as `quantized_mean` does, or a `PendingMean`.

    The quantization acts on the intra SUM, which every member of an intra
    group shares, so the raw residual belongs to the group: each member
    keeps residual / n_intra, and the next step's exact hop 1 reassembles
    the whole residual once (each member carrying all of it would feed it
    back n_intra-fold). The means are the inter means / n_intra."""
    n_intra = world_size(intra_group)
    sizes = [s.numel() for s in segments]
    flat = torch.cat(segments)
    if intra_group is not None:
        dist.all_reduce(flat, group=intra_group)
    pending = quantized_mean(list(flat.split(sizes)), inter_group, wire_dtype, async_op=True)
    pending.fan_in = n_intra
    return pending if async_op else pending.wait()
