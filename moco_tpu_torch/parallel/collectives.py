"""ShuffleBN's batch permutation for one process (port of `batch_shuffle` /
`batch_unshuffle` in `moco_tpu/parallel/collectives.py`).

With one card the "global batch" is the local one: the key batch is
permuted by a generator-drawn permutation before the key encoder and put
back in order after it. Per-device BN over the whole batch sees the same
samples either way; the NCCL form across cards comes with the multi-GPU
slice.
"""

from __future__ import annotations

import torch


def batch_shuffle(x: torch.Tensor, generator: torch.Generator
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """(x[perm], perm) for a random permutation of the batch."""
    perm = torch.randperm(x.shape[0], generator=generator, device=x.device)
    return x[perm], perm


def batch_unshuffle(x: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    """Undo `batch_shuffle`: index with the inverse permutation."""
    return x[torch.argsort(perm)]
