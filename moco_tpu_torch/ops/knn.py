"""Weighted kNN classification on frozen features (port of
`moco_tpu/ops/knn.py`; the InstDisc protocol of every MoCo kNN monitor).

Cosine similarity of each query against an L2-normalized feature bank, the
top `k` neighbours (200), votes weighted `exp(sim / T)` with T = 0.07, and
the class with the most weight. The similarity is one `[B, dim] x [N, dim]^T`
product; with `bank_chunk` the bank streams through in slices with a running
top-k merge, so at most `[B, bank_chunk]` similarities are live. The JAX
function is plain XLA (no Pallas kernel), so `torch.matmul` and
`torch.topk` are its counterparts here.
"""

from __future__ import annotations

import torch

from moco_tpu_torch.ops.losses import l2_normalize


def _knn_predict_prenormalized(feats: torch.Tensor, bank: torch.Tensor,
                               bank_labels: torch.Tensor, num_classes: int, k: int = 200,
                               temperature: float = 0.07,
                               bank_chunk: int | None = None) -> torch.Tensor:
    """Predicted class ids [B] of L2-normalized queries `feats` [B, dim]
    against an L2-normalized `bank` [N, dim] with labels [N].

    `bank_chunk` < N streams the bank: each chunk's top `min(k, chunk)`
    merged with the running top k loses nothing of the global top k (exact
    for any k <= N). The last chunk is padded with zero rows that an
    ADDITIVE -inf mask pushes below every real neighbour, so real
    similarities pass through unchanged."""
    n = bank.shape[0]
    k = min(k, n)
    if bank_chunk is None or bank_chunk >= n:
        sims = feats @ bank.t()
        top_sims, top_idx = torch.topk(sims, k, dim=1)
        neigh_labels = bank_labels[top_idx]
    else:
        chunk_k = min(k, bank_chunk)
        b = feats.shape[0]
        top_sims = torch.full((b, k), float("-inf"), device=feats.device)
        neigh_labels = torch.zeros((b, k), dtype=bank_labels.dtype, device=feats.device)
        for start in range(0, n, bank_chunk):
            cb = bank[start:start + bank_chunk]
            cl = bank_labels[start:start + bank_chunk]
            mask = torch.zeros(bank_chunk, device=feats.device)
            pad = bank_chunk - cb.shape[0]
            if pad:
                cb = torch.cat([cb, cb.new_zeros(pad, cb.shape[1])])
                cl = torch.cat([cl, cl.new_zeros(pad)])
                mask[bank_chunk - pad:] = float("-inf")
            sims = feats @ cb.t() + mask
            cs, ci = torch.topk(sims, chunk_k, dim=1)
            cand_s = torch.cat([top_sims, cs], dim=1)          # [B, k + chunk_k]
            cand_l = torch.cat([neigh_labels, cl[ci]], dim=1)
            top_sims, sel = torch.topk(cand_s, k, dim=1)
            neigh_labels = cand_l.gather(1, sel)
    weights = torch.exp(top_sims / temperature)
    votes = torch.zeros((feats.shape[0], num_classes), device=feats.device)
    votes.scatter_add_(1, neigh_labels.long(), weights)
    return votes.argmax(dim=1)


def knn_predict(features: torch.Tensor, bank: torch.Tensor, bank_labels: torch.Tensor,
                num_classes: int, k: int = 200, temperature: float = 0.07,
                bank_chunk: int | None = None) -> torch.Tensor:
    """Predicted class ids [B]; normalizes both sides (for repeated calls
    against one bank, `knn_accuracy` normalizes it once)."""
    return _knn_predict_prenormalized(
        l2_normalize(features.float()), l2_normalize(bank.float()), bank_labels,
        num_classes, k=k, temperature=temperature, bank_chunk=bank_chunk)


def knn_accuracy(features: torch.Tensor, labels: torch.Tensor, bank: torch.Tensor,
                 bank_labels: torch.Tensor, num_classes: int, k: int = 200,
                 temperature: float = 0.07, batch: int = 512,
                 bank_chunk: int | None = 65536) -> float:
    """Top-1 kNN accuracy of queries `features` [M, dim] with `labels` [M],
    in query batches of `batch` (the ragged last one padded to `batch`
    rows) against the bank streamed in `bank_chunk` slices; the bank is
    normalized once. Everything stays on the inputs' device until the one
    count read at the end."""
    feats = l2_normalize(features.float())
    bank = l2_normalize(bank.float())
    correct = torch.zeros((), dtype=torch.int64, device=feats.device)
    for start in range(0, feats.shape[0], batch):
        f = feats[start:start + batch]
        y = labels[start:start + batch]
        valid = f.shape[0]
        if valid < batch:
            f = torch.cat([f, f.new_zeros(batch - valid, f.shape[1])])
        pred = _knn_predict_prenormalized(f, bank, bank_labels, num_classes, k=k,
                                          temperature=temperature, bank_chunk=bank_chunk)
        correct += (pred[:valid] == y.to(pred.device)).sum()
    return int(correct) / feats.shape[0]
