"""The port's kNN classifier (`moco_tpu_torch/ops/knn.py`) against the JAX
package's on the same numpy features: the full-bank and the streamed
branch, k above the chunk and above the bank, a bank that is not a whole
number of chunks, and a ragged last query batch. Predictions must be equal.

`torch.topk` and `lax.top_k` may order exact ties differently, and the two
products round differently in the last place, so the features are drawn
such that no query has a near-tie at its k-th neighbour or between its two
best classes (`_assert_no_ties` checks it in float64); then the predictions
are equal, not close.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moco_tpu.ops import knn as jknn
from moco_tpu_torch.ops import knn

DIM, CLASSES, T = 32, 7, 0.07


def _unit(x):
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)


def _data(n_bank, n_query, seed):
    rng = np.random.RandomState(seed)
    bank = rng.randn(n_bank, DIM).astype(np.float32)
    queries = rng.randn(n_query, DIM).astype(np.float32)
    return (queries, bank, rng.randint(0, CLASSES, n_bank).astype(np.int32),
            rng.randint(0, CLASSES, n_query).astype(np.int32))


def _assert_no_ties(feats, bank, labels, k, gap=1e-5):
    """The inputs are tie-free: the k-th and (k+1)-th similarities and the
    two best class votes of every query are more than `gap` apart (f32
    rounding moves a similarity of these 32-wide unit vectors by ~1e-7)."""
    sims = feats.astype(np.float64) @ bank.astype(np.float64).T
    order = np.sort(sims, axis=1)[:, ::-1]
    k = min(k, bank.shape[0])
    if k < bank.shape[0]:
        assert (order[:, k - 1] - order[:, k]).min() > gap
    top = np.argsort(-sims, axis=1)[:, :k]
    votes = np.zeros((feats.shape[0], CLASSES))
    for b in range(feats.shape[0]):
        np.add.at(votes[b], labels[top[b]], np.exp(sims[b, top[b]] / T))
    best2 = np.sort(votes, axis=1)[:, -2:]
    assert ((best2[:, 1] - best2[:, 0]) / best2[:, 1]).min() > gap


# (bank rows, k, bank_chunk): the full product, a chunk that does not
# divide the bank, k above the chunk, k above the bank (full and streamed)
CASES = {
    "unchunked": (300, 20, None),
    "chunk_does_not_divide_bank": (300, 20, 64),
    "k_above_chunk": (300, 40, 16),
    "k_above_bank": (30, 200, None),
    "k_above_bank_streamed": (30, 200, 8),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_predictions_equal_jax(name):
    n, k, chunk = CASES[name]
    queries, bank, bank_labels, _ = _data(n, 48, seed=n + k)
    feats, bank = _unit(queries), _unit(bank)
    _assert_no_ties(feats, bank, bank_labels, k)
    ref = jknn._knn_predict_prenormalized(jnp.asarray(feats), jnp.asarray(bank),
                                          jnp.asarray(bank_labels), CLASSES, k=k,
                                          temperature=T, bank_chunk=chunk)
    got = knn._knn_predict_prenormalized(torch.from_numpy(feats), torch.from_numpy(bank),
                                         torch.from_numpy(bank_labels), CLASSES, k=k,
                                         temperature=T, bank_chunk=chunk)
    assert got.dtype == torch.int64 and got.shape == (48,)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_streamed_equals_full_bank():
    """The chunked merge is exact: the same neighbours, so the same
    predictions, as one product over the whole bank."""
    queries, bank, bank_labels, _ = _data(300, 48, seed=3)
    args = (torch.from_numpy(_unit(queries)), torch.from_numpy(_unit(bank)),
            torch.from_numpy(bank_labels), CLASSES)
    full = knn._knn_predict_prenormalized(*args, k=25)
    for chunk in (7, 25, 64, 299):
        assert torch.equal(knn._knn_predict_prenormalized(*args, k=25, bank_chunk=chunk), full)


def test_knn_predict_normalizes_both_sides():
    queries, bank, bank_labels, _ = _data(200, 32, seed=5)
    _assert_no_ties(_unit(queries), _unit(bank), bank_labels, 20)
    ref = jknn.knn_predict(jnp.asarray(3 * queries), jnp.asarray(0.5 * bank),
                           jnp.asarray(bank_labels), CLASSES, k=20, bank_chunk=64)
    got = knn.knn_predict(torch.from_numpy(3 * queries), torch.from_numpy(0.5 * bank),
                          torch.from_numpy(bank_labels), CLASSES, k=20, bank_chunk=64)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("chunk", [None, 64])
def test_knn_accuracy_with_a_ragged_query_tail_equals_jax(chunk):
    """70 queries in batches of 32: the last batch holds 6 queries and is
    padded to 32 rows, whose predictions do not count."""
    queries, bank, bank_labels, labels = _data(300, 70, seed=11)
    # labels that the neighbours mostly agree with, so the accuracy is not 0
    labels[:35] = knn.knn_predict(torch.from_numpy(queries[:35]), torch.from_numpy(bank),
                                  torch.from_numpy(bank_labels), CLASSES, k=20).numpy()
    _assert_no_ties(_unit(queries), _unit(bank), bank_labels, 20)
    ref = jknn.knn_accuracy(jnp.asarray(queries), jnp.asarray(labels), jnp.asarray(bank),
                            jnp.asarray(bank_labels), CLASSES, k=20, temperature=T,
                            batch=32, bank_chunk=chunk)
    got = knn.knn_accuracy(torch.from_numpy(queries), torch.from_numpy(labels),
                           torch.from_numpy(bank), torch.from_numpy(bank_labels), CLASSES,
                           k=20, temperature=T, batch=32, bank_chunk=chunk)
    assert got == ref and 0.5 <= got < 1.0
