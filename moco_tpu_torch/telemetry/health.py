"""Learning-health diagnostics of the step, on tensors (port of
`moco_tpu/telemetry/health.py`).

Representation collapse (every input maps to one feature), a frozen key
encoder and a queue of degenerate negatives are silent: the loss keeps
moving. These cheap signals make them visible:

  per-dim embedding std      mean over dims of the per-dim std across the
                             (local) batch; ~0 under collapse
  participation ratio        tr(C)^2 / tr(C^2) of the embedding
                             covariance: the number of dimensions the
                             batch occupies (1 = rank-one collapse)
  logit margin               pos_sim - mean neg_sim (both x T), a
                             standard step metric (`neg_sim_mean`, kept in
                             `ops/losses.py`)
  queue feature-norm stats   rows are unit at enqueue; a drifting or ~0
                             norm marks degenerate entries
  ptr-derived queue age      steps since the oldest live queue row was
                             enqueued (K / B when the queue is warm)
  query-key parameter drift  ||theta_q - theta_k|| / ||theta_q|| over the
                             EMA-covered parameters
  grad norm by layer group   the global gradient L2 and the first / last
                             top-level parameter group's (sorted names)

The step calls these only on stride steps: `step % stride == 0` on the
host step counter, a plain `if` (eager torch needs no `lax.cond`). Off the
stride they return no keys, where the JAX package's cond returns zeros.
Every diagnostic reads the step's tensors and writes nothing, so the
trajectory with health on is the trajectory with it off, bit for bit.
Under a process group each rank computes `region_health` on its own
slice and the step averages it with its other metrics (the JAX `pmean`);
`queue_health` and `param_drift` read replicated state.

`crush_key_params` is the collapse drill's payload: it rewrites a key
encoder in place so that every input maps to one constant feature.
"""

from __future__ import annotations

from collections.abc import Mapping

import torch

from moco_tpu_torch.ops.losses import neg_sim_mean  # noqa: F401 (one copy, re-exported)

def _on_stride(step: int, stride: int) -> bool:
    return stride > 0 and int(step) % stride == 0


def embedding_stats(z: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(mean per-dim std, participation ratio) of a `[B, D]` embedding
    batch; the ratio needs only the covariance traces (one `[D, B] x
    [B, D]` product, no eigendecomposition)."""
    z = z.float()
    centered = z - z.mean(dim=0, keepdim=True)
    var = centered.square().mean(dim=0)                     # [D]
    mean_std = var.sqrt().mean()
    cov = centered.t() @ centered / z.shape[0]              # [D, D]
    tr = var.sum()
    tr_sq = cov.square().sum()
    pr = tr.square() / torch.clamp(tr_sq, min=1e-20)
    return mean_std, pr


def param_grads(model: torch.nn.Module) -> dict:
    """The model's gradients as a nested mapping of its (flax) parameter
    names, `a.b.weight` -> `{"a": {"b": {"weight": g}}}`; a parameter
    without a gradient (a frozen one) contributes zeros, as the JAX step's
    stopped gradients do."""
    tree: dict = {}
    for name, p in model.named_parameters():
        *mods, leaf = name.split(".")
        node = tree
        for m in mods:
            node = node.setdefault(m, {})
        node[leaf] = p.grad if p.grad is not None else torch.zeros((), device=p.device)
    return tree


def _leaves(tree):
    if isinstance(tree, Mapping):
        for key in sorted(tree):
            yield from _leaves(tree[key])
    else:
        yield tree


def _flat(tensors) -> torch.Tensor:
    """`tensors` as one flat f32 vector (one `cat`)."""
    return torch.cat([t.detach().float().reshape(-1) for t in tensors])


def _global_norm(tensors: list[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares over `tensors`, in f32, as one reduction
    over their concatenation: a handful of launches for hundreds of
    parameters, where a sum per tensor launches a few kernels each.
    (`torch._foreach_norm` would launch fewer still, but on the CPU it
    rounds a 4096 x 4096 gradient's norm 7e-4 off.)"""
    if not tensors:
        return torch.zeros(())
    return _flat(tensors).square().sum().sqrt()


def _norm(tree) -> torch.Tensor:
    return _global_norm(list(_leaves(tree)))


def grad_group_norms(grads: Mapping) -> dict[str, torch.Tensor]:
    """Global gradient L2 norm and the first / last top-level parameter
    group's (sorted names: deterministic for an arch). `grads` is a nested
    mapping of tensors (`param_grads`)."""
    out = {"h_gnorm": _norm(grads)}
    if grads:
        keys = sorted(grads)
        out["h_gnorm_first"] = _norm(grads[keys[0]])
        out["h_gnorm_last"] = _norm(grads[keys[-1]])
    return out


def region_health(q: torch.Tensor, k: torch.Tensor, grads: Mapping, step: int,
                  stride: int) -> dict[str, torch.Tensor]:
    """The per-rank diagnostics (this rank's batch slice and local
    gradients): embedding std and participation ratio of the query
    embedding, std of the key embedding, gradient norms by layer group.
    Empty off the stride."""
    if not _on_stride(step, stride):
        return {}
    std_q, pr_q = embedding_stats(q)
    std_k, _ = embedding_stats(k)
    out = {"h_emb_std_q": std_q, "h_emb_pr_q": pr_q, "h_emb_std_k": std_k}
    out.update(grad_group_norms(grads))
    return out


def queue_health(queue: torch.Tensor, step: int, global_batch: int,
                 stride: int) -> dict[str, torch.Tensor]:
    """Row-norm mean / min of the (replicated) queue, and the age in steps
    of its oldest live row: the enqueue advances the pointer by the global
    batch a step, so a warm queue is K / B steps deep; before that the age
    is the step count. Empty off the stride."""
    if not _on_stride(step, stride):
        return {}
    depth = max(queue.shape[0] // max(global_batch, 1), 1)
    norms = queue.float().square().sum(dim=-1).sqrt()
    return {"h_qnorm_mean": norms.mean(), "h_qnorm_min": norms.min(),
            "h_qage_steps": torch.tensor(float(min(int(step), depth)),
                                         device=queue.device)}


def param_drift(params_q, params_k, step: int, stride: int) -> dict[str, torch.Tensor]:
    """Relative query-key parameter drift ||theta_q - theta_k|| / ||theta_q||
    over matching parameter lists (the caller passes the EMA-covered ones:
    v3 leaves the predictor out). Empty off the stride."""
    if not _on_stride(step, stride):
        return {}
    pq = _flat(params_q)
    diff = (pq - _flat(params_k)).square().sum().sqrt()
    return {"h_pdrift": diff / torch.clamp(pq.square().sum().sqrt(), min=1e-12)}


@torch.no_grad()
def crush_key_params(model_k: torch.nn.Module, local=None) -> torch.nn.Module:
    """Rewrite `model_k`'s parameters in place so that its forward maps
    EVERY input to one constant feature: kernels (parameters of two or more
    dims) and normalization scales (the 1-D `weight`s, flax's `scale`)
    zeroed, the remaining 1-D parameters (biases) set to one, as the JAX
    package's `crush_key_params` does to a flax tree. BN running statistics
    are left alone. The drill re-applies it after every step: it models a
    persistently wedged momentum update. `local(p)` names the tensor that
    holds `p` (an fsdp process's shard of it)."""
    for name, p in model_k.named_parameters():
        held = p if local is None else local(p)
        if name.rsplit(".", 1)[-1] == "weight" and p.ndim == 1 or p.ndim != 1:
            held.zero_()
        else:
            held.fill_(1.0)
    return model_k
