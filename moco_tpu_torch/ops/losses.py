"""Contrastive loss pieces of the MoCo v1/v2 and v3 steps (port of
`moco_tpu/ops/losses.py` and `telemetry/health.neg_sim_mean`).

Logits and the cross entropy are computed in float32 whatever the encoder's
compute dtype, with the positive at column 0.
"""

from __future__ import annotations

import torch


def l2_normalize(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Row-wise L2 normalization; `eps` floors the SQUARED norm."""
    return x / torch.sqrt(torch.clamp((x * x).sum(dim=-1, keepdim=True), min=eps))


def infonce_logits(q: torch.Tensor, k: torch.Tensor, queue: torch.Tensor,
                   temperature: float) -> tuple[torch.Tensor, torch.Tensor]:
    """(K+1)-way logits `[q.k+, q.queue^T] / T` (f32) and zero labels.

    `q`, `k` are L2-normalized; `k` and `queue` carry no gradient (the key
    path runs under no_grad, the queue is a plain buffer)."""
    q = q.float()
    l_pos = (q * k.float()).sum(dim=1, keepdim=True)
    l_neg = q @ queue.float().t()
    logits = torch.cat([l_pos, l_neg], dim=1) / temperature
    labels = torch.zeros(q.shape[0], dtype=torch.int64, device=q.device)
    return logits, labels


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean cross entropy over the batch."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -logp.gather(1, labels[:, None]).mean()


def contrastive_accuracy(logits: torch.Tensor, labels: torch.Tensor,
                         topk: tuple[int, ...] = (1, 5)) -> tuple[torch.Tensor, ...]:
    """Top-k accuracy (%) by rank count: the label column is in the top k iff
    fewer than k columns score STRICTLY higher, so an exact tie credits the
    positive. A row whose label logit is not finite counts as a miss, and a
    label of -1 (padding) never counts."""
    valid = labels >= 0
    label_logit = logits.gather(1, labels.clamp(min=0)[:, None])
    valid = valid & torch.isfinite(label_logit[:, 0])
    n_better = (logits > label_logit).sum(dim=-1)
    return tuple(100.0 * ((n_better < k) & valid).float().mean() for k in topk)


def neg_sim_mean(logits: torch.Tensor, labels: torch.Tensor,
                 temperature: float) -> torch.Tensor:
    """Mean negative-pair similarity (x T) over the logits, excluding each
    row's positive column."""
    total = logits.float().sum()
    pos = logits.float().gather(1, labels[:, None]).sum()
    n, m = logits.shape
    return (total - pos) / (n * (m - 1)) * temperature


def v3_contrastive_loss(q: torch.Tensor, k_all: torch.Tensor, temperature: float,
                        offset: int = 0) -> torch.Tensor:
    """One direction of the MoCo-v3 queue-free loss: logits `q . k_all^T / T`
    in f32 against the keys of the whole global batch `k_all` (the other
    samples are the negatives), the positive of local row i at global row
    `offset + i` (`offset` = rank x local batch), the cross entropy scaled
    by 2T. `q`, `k_all` are L2-normalized; `k_all` carries no gradient."""
    logits = (q.float() @ k_all.float().t()) / temperature
    labels = torch.arange(q.shape[0], device=q.device) + offset
    return softmax_cross_entropy(logits, labels) * (2.0 * temperature)
