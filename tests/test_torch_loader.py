"""The port's input pipeline on `device="cpu"`: the cases of the JAX
package's `tests/test_input_pipeline.py`, and the port's batches against the
JAX package's loader on the same dataset, bit for bit.

Every test that starts staging threads runs under a timeout of its own
(`within`), so a hang fails that test instead of the run.
"""

import functools
import threading
import time

import numpy as np
import pytest
import torch
from PIL import Image

from moco_tpu.data import loader as jloader
from moco_tpu_torch.config import PretrainConfig
from moco_tpu_torch.data import datasets, loader
from moco_tpu_torch.data.canvas_cache import CachedDataset
from moco_tpu_torch.data.stats import InputPipelineStats


def within(seconds: float):
    """Run the test body in a thread and fail the test if it has not
    finished after `seconds`."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            outcome = {}

            def run():
                try:
                    fn(*args, **kwargs)
                except BaseException as e:  # handed to the test's own thread below
                    outcome["err"] = e

            t = threading.Thread(target=run, daemon=True, name=f"test-{fn.__name__}")
            t.start()
            t.join(seconds)
            if t.is_alive():
                pytest.fail(f"{fn.__name__} did not finish within {seconds} s")
            if "err" in outcome:
                raise outcome["err"]
        return wrapper
    return deco


def _collect(dataset, global_batch=16, epoch=0, **kw):
    it = loader.epoch_loader(dataset, epoch=epoch, seed=0, global_batch=global_batch,
                             device="cpu", **kw)
    try:
        return [tuple(t.numpy() for t in item) for item in it]
    finally:
        it.close_quietly()


def _assert_batches_equal(ref, got):
    assert len(ref) == len(got)
    for batch_ref, batch_got in zip(ref, got):
        assert len(batch_ref) == len(batch_got)
        for a, b in zip(batch_ref, batch_got):
            np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def jpeg_tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("pipe_imgs")
    rng = np.random.RandomState(7)
    for cls in ("a", "b"):
        d = root / cls
        d.mkdir()
        for i in range(24):
            h, w = rng.randint(40, 90), rng.randint(40, 90)
            img = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
            Image.fromarray(img).save(str(d / f"{i}.jpg"), quality=92)
    return str(root)


def test_epoch_permutation_and_host_shard_match_jax():
    for n, epoch, seed, gb in ((100, 0, 0, 16), (257, 3, 5, 32), (10, 1, 2, 4)):
        np.testing.assert_array_equal(loader.epoch_permutation(n, epoch, seed, gb),
                                      jloader.epoch_permutation(n, epoch, seed, gb))
    idx = np.arange(32)
    np.testing.assert_array_equal(loader.host_shard(idx, 16), jloader.host_shard(idx, 16))
    np.testing.assert_array_equal(loader.host_shard(idx, 16, 2, 1),
                                  np.r_[8:16, 24:32])
    with pytest.raises(ValueError, match="divisible"):
        loader.host_shard(idx, 16, 3, 0)


@within(120)
def test_batches_match_the_jax_loader(mesh8, jpeg_tree):
    """The port's Prefetcher, with 1 and 4 workers, against the JAX
    package's epoch_loader on the same dataset and epoch."""
    for ds in (datasets.SyntheticDataset(num_samples=80, image_size=16, num_classes=4),
               datasets.ImageFolder(jpeg_tree, stage_size=64)):
        jl = jloader.epoch_loader(ds, epoch=1, seed=0, global_batch=16, mesh=mesh8)
        try:
            ref = [tuple(np.asarray(a) for a in item) for item in jl]
        finally:
            jl.close_quietly()
        for workers in (1, 4):
            _assert_batches_equal(ref, _collect(ds, epoch=1, workers=workers))


@within(60)
def test_multiworker_bit_identical_to_single():
    ds = datasets.SyntheticDataset(num_samples=80, image_size=16, num_classes=4)
    ref = _collect(ds)
    assert len(ref) == 5
    for workers in (2, 3, 5, 8):
        _assert_batches_equal(ref, _collect(ds, workers=workers))


@within(60)
def test_multiworker_bit_identical_across_epochs_and_depth():
    ds = datasets.SyntheticDataset(num_samples=96, image_size=16, num_classes=4)
    for epoch in (0, 1):
        ref = _collect(ds, epoch=epoch)
        for depth in (1, 4):
            _assert_batches_equal(ref, _collect(ds, epoch=epoch, workers=4, depth=depth))


@within(120)
@pytest.mark.parametrize("backend", ["native", "pil"])
def test_multiworker_imagefolder(jpeg_tree, backend):
    """Decode straight into pooled canvas rows (the stager's threads, or
    PIL's) equals the single-call staging path."""
    ds = datasets.ImageFolder(jpeg_tree, stage_size=64, backend=backend)
    ref = _collect(ds)
    _assert_batches_equal(ref, _collect(ds, workers=4))
    assert ds.decode_failures == 0


@within(60)
def test_multiworker_requires_three_tuple_protocol():
    class TwoTuple:
        def __len__(self):
            return 64

        def get_batch(self, indices):
            return (np.zeros((len(indices), 8, 8, 3), np.uint8),
                    np.zeros((len(indices),), np.int32))

    it = loader.epoch_loader(TwoTuple(), epoch=0, seed=0, global_batch=16, device="cpu",
                             workers=4)
    try:
        with pytest.raises(TypeError, match="protocol"):
            list(it)
    finally:
        it.close_quietly()
    # one worker stages any tuple, batch by batch
    got = _collect(TwoTuple(), workers=1)
    assert len(got) == 4 and all(len(b) == 2 for b in got)


class _Flaky:
    """SyntheticDataset whose batch reads raise OSError on the calls listed."""

    def __init__(self, fail_calls, n=64):
        self.inner = datasets.SyntheticDataset(num_samples=n, image_size=16, num_classes=4)
        self.fail_calls = set(fail_calls)
        self.calls = 0
        self.lock = threading.Lock()

    def __len__(self):
        return len(self.inner)

    def get_batch(self, indices):
        with self.lock:
            self.calls += 1
            call = self.calls
        if call in self.fail_calls:
            raise OSError(f"transient read fault on call {call}")
        return self.inner.get_batch(indices)


@within(60)
@pytest.mark.parametrize("workers", [1, 4])
def test_transient_faults_retry_without_reorder_or_dup(workers):
    ref = _collect(_Flaky(()), workers=workers)
    got = _collect(_Flaky((2, 3, 6)), workers=workers, retries=3, backoff_secs=0.01)
    _assert_batches_equal(ref, got)


@within(60)
@pytest.mark.parametrize("workers", [1, 4])
def test_exhausted_retries_surface(workers):
    ds = _Flaky(range(3, 100))
    it = loader.epoch_loader(ds, epoch=0, seed=0, global_batch=16, device="cpu",
                             workers=workers, retries=2, backoff_secs=0.01)
    seen = 0
    try:
        with pytest.raises(OSError, match="transient read fault"):
            for _ in it:
                seen += 1
    finally:
        it.close_quietly()
    assert seen >= 1  # the batches staged before the fault drained first


@within(60)
@pytest.mark.parametrize("workers", [1, 4])
def test_worker_error_surfaces_at_iteration(workers):
    class Broken(_Flaky):
        def get_batch(self, indices):
            if self.calls >= 1:
                raise ValueError("corrupt file: a test failure")
            self.calls += 1
            return self.inner.get_batch(indices)

    it = loader.epoch_loader(Broken(()), epoch=0, seed=0, global_batch=16, device="cpu",
                             workers=workers)
    try:
        with pytest.raises(ValueError, match="corrupt file"):
            list(it)
    finally:
        it.close_quietly()


@within(60)
def test_close_raises_an_error_the_iterator_never_reached():
    class Broken(_Flaky):
        def get_batch(self, indices):
            raise ValueError("never consumed")

    it = loader.epoch_loader(Broken(()), epoch=0, seed=0, global_batch=16, device="cpu")
    deadline = time.time() + 10
    while it.qsize() == 0 and time.time() < deadline:
        time.sleep(0.01)
    with pytest.raises(ValueError, match="never consumed"):
        it.close()


@within(60)
def test_prefetch_depth_honored():
    ds = datasets.SyntheticDataset(num_samples=160, image_size=16, num_classes=4)
    it = loader.epoch_loader(ds, epoch=0, seed=0, global_batch=16, device="cpu", depth=3,
                             workers=2)
    try:
        assert it._q.maxsize == 3
        deadline = time.time() + 10
        while it.qsize() < 3 and time.time() < deadline:
            time.sleep(0.01)
        time.sleep(0.05)
        assert it.qsize() == 3  # staged ahead up to depth, then blocked
    finally:
        it.close_quietly()
    with pytest.raises(ValueError, match="depth"):
        loader.Prefetcher(ds, np.arange(16), 16, "cpu", depth=0)


def test_config_validates_pipeline_fields_at_build_time():
    for field, bad in (("prefetch_depth", 0), ("staging_workers", 0),
                       ("input_cache_mb", -1), ("print_freq", 0)):
        with pytest.raises(ValueError, match=field):
            PretrainConfig(**{field: bad})
        with pytest.raises(ValueError, match=field):
            PretrainConfig().replace(**{field: bad})


@within(120)
@pytest.mark.parametrize("workers", [1, 2])
def test_trim_h2d_ships_extent_prefix(jpeg_tree, workers):
    """Trimmed batches are the untrimmed canvas prefix (rounded up to 64)
    with the same labels and extents."""
    ds = datasets.ImageFolder(jpeg_tree, stage_size=128)
    ref = _collect(ds)
    trimmed = _collect(ds, workers=workers, trim_h2d=True)
    assert len(ref) == len(trimmed)
    saw_trim = False
    for (imgs, labels, extents), (t_imgs, t_labels, t_extents) in zip(ref, trimmed):
        th, tw = t_imgs.shape[1], t_imgs.shape[2]
        assert th % 64 == 0 or th == imgs.shape[1]
        assert tw % 64 == 0 or tw == imgs.shape[2]
        assert th >= extents[:, 0].max() and tw >= extents[:, 1].max()
        saw_trim |= (th, tw) != imgs.shape[1:3]
        np.testing.assert_array_equal(imgs[:, :th, :tw], t_imgs)
        np.testing.assert_array_equal(labels, t_labels)
        np.testing.assert_array_equal(extents, t_extents)
    assert saw_trim  # the 40-90 px tree underfills the 128x256 canvas


@within(60)
def test_trim_noop_for_full_extent_datasets():
    ds = datasets.SyntheticDataset(num_samples=32, image_size=16, num_classes=4)
    _assert_batches_equal(_collect(ds), _collect(ds, workers=2, trim_h2d=True))


@within(60)
def test_skip_batches_over_a_cache():
    """`skip_batches` drops whole batches at the index level; over a cache
    the yielded batches equal the uncached loader's at the same positions."""
    ds = datasets.SyntheticDataset(num_samples=96, image_size=16, num_classes=4)
    full = _collect(ds)
    ref = _collect(ds, skip_batches=2)
    _assert_batches_equal(full[2:], ref)
    cached = CachedDataset(ds, cache_mb=64)
    _collect(cached, workers=2)  # epoch 0 fills the cache
    _assert_batches_equal(ref, _collect(cached, workers=2, skip_batches=2))
    assert cached.hits > 0


@within(60)
def test_input_stats_populated():
    ds = datasets.SyntheticDataset(num_samples=64, image_size=16, num_classes=4)
    stats = InputPipelineStats()
    cached = CachedDataset(ds, cache_mb=16, stats=stats)
    _collect(cached, workers=3, stats=stats)
    snap = stats.snapshot()
    assert snap["staged_batches"] == 4
    assert snap["workers"] == 3
    assert snap["staged_batch_s_p50"] > 0
    assert snap["staged_batch_s_p95"] >= snap["staged_batch_s_p50"]
    assert snap["queue_depth_mean"] >= 0
    assert 0 < snap["worker_busy_frac"] <= 1
    assert snap["credit_stall_s"] >= 0
    assert snap["cache_misses"] > 0 and "cache_hit_rate" in snap
    assert stats.staged_bytes == 4 * (16 * 16 * 16 * 3 + 16 * 4 + 16 * 3 * 4)


@within(60)
def test_cpu_batches_do_not_alias_the_recycled_canvas():
    """On the CPU a batch is a copy: holding every batch of an epoch (more
    than the pool's two canvases) keeps each one's own bytes."""
    ds = datasets.SyntheticDataset(num_samples=128, image_size=16, num_classes=4)
    it = loader.epoch_loader(ds, epoch=0, seed=0, global_batch=16, device="cpu", workers=2)
    try:
        held = list(it)
    finally:
        it.close_quietly()
    order = loader.epoch_permutation(128, 0, 0, 16)
    for b, (imgs, labels, extents) in enumerate(held):
        assert isinstance(imgs, torch.Tensor) and imgs.dtype == torch.uint8
        want = ds.get_batch(order[b * 16:(b + 1) * 16])
        np.testing.assert_array_equal(imgs.numpy(), want[0])
        np.testing.assert_array_equal(extents.numpy(), want[2])


@within(60)
def test_close_joins_all_staging_threads():
    before = threading.active_count()
    ds = datasets.SyntheticDataset(num_samples=160, image_size=16, num_classes=4)
    it = loader.epoch_loader(ds, epoch=0, seed=0, global_batch=16, device="cpu", workers=4,
                             depth=2)
    try:
        next(iter(it))
    finally:
        it.close_quietly()
    assert not it._thread.is_alive()
    assert not any(t.is_alive() for t in it._wthreads)
    deadline = time.time() + 5.0
    while threading.active_count() > before and time.time() < deadline:
        time.sleep(0.01)
    assert threading.active_count() <= before


def test_prefetcher_refuses_other_devices():
    ds = datasets.SyntheticDataset(num_samples=16, image_size=8, num_classes=2)
    with pytest.raises(ValueError, match="unsupported device"):
        loader.Prefetcher(ds, np.arange(16), 16, "meta")
