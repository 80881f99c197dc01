"""The port's embedding service (`moco_tpu_torch/serve/`) against the JAX
package's (`moco_tpu/serve/`) on the CPU.

- Each scenario of the batcher, the cache, `decode_image`, the HTTP routes
  and their error bodies, hot reload and its generation consistency, the
  dual swap, `/admin/bank`, the chaos wedge and `ServeConfig` runs once
  for each package (`pkg`), through one deterministic numpy stub engine
  (`StubEngine`: any object with `warmup`, `embed`, `image_size` and
  `buckets`), so neither side pays for a model; where the two packages
  answer the same requests, the transcripts are compared whole.
- The port's engine against the JAX `EmbeddingEngine` on the same
  `resnet_tiny` export (`cifar_stem=True`, 32 px, the JAX tests'
  `tiny_setup`), weights carried by the export file, on the same seeded
  uint8 batch: within rtol 1e-4 / atol 1e-5 (f32 forwards of a 3-stage
  ResNet that sum in another order; stated before the first run).
- On the CPU the port's engine gives an image the same bits alone, padded
  in a larger bucket and among strangers (checked here; on the card the
  bits are held within a bucket and the cross-bucket difference is
  measured by `chip_smoke.py` phase 13).
- The serve CLI in a subprocess: serves, answers, drains on SIGTERM and
  exits 0; without `--device cpu` on a host without CUDA it exits 45.

No test waits more than a few seconds of wall clock; the subprocesses and
HTTP calls run under their own time limits.
"""

from __future__ import annotations

import base64
import dataclasses
import importlib
import importlib.util
import inspect
import json
import os
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGES = ["moco_tpu", "moco_tpu_torch"]
D = 6          # the stub's embedding width
S = 8          # the stub's image size
SIZE = 32      # the real engines' image size
BUCKETS = (1, 4, 16)
ENGINE_RTOL, ENGINE_ATOL = 1e-4, 1e-5


def _load_tool(name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, "tools",
                                                                      f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _Pkg:
    """One package's serve modules, by short name."""

    def __init__(self, name):
        self.name = name
        for mod in ("batcher", "cache", "service", "http", "bankbuild", "ann"):
            setattr(self, mod, importlib.import_module(f"{name}.serve.{mod}"))
        self.serve = importlib.import_module(f"{name}.serve")
        self.config = importlib.import_module(f"{name}.config")
        self.registry = importlib.import_module(f"{name}.telemetry.registry")
        self.chaos = importlib.import_module(f"{name}.resilience.chaos")


@pytest.fixture(params=PACKAGES)
def pkg(request):
    return _Pkg(request.param)


def _embed_stub(batch, scale=1.0):
    flat = np.asarray(batch, np.float32).reshape(len(batch), -1)
    return (flat[:, :D] / 255.0 * scale + 0.01).astype(np.float32)


class StubEngine:
    """A deterministic numpy engine: a scaled projection of the pixels
    (scale 1 and 2 are two distinguishable embedding spaces with cosine 1
    between them); `gate` holds its `embed` closed."""

    image_size = S

    def __init__(self, scale=1.0, buckets=(1, 4), gate=None):
        self.scale, self.buckets, self.gate = float(scale), tuple(buckets), gate
        self.calls = 0

    def warmup(self):
        return D

    def embed(self, images_u8):
        self.calls += 1
        if self.gate is not None and not self.gate.wait(timeout=10.0):
            raise RuntimeError("test gate never released")
        return _embed_stub(images_u8, self.scale)


class ConstEngine(StubEngine):
    """Every image embeds to one row: a collapsed checkpoint."""

    def embed(self, images_u8):
        return np.full((len(images_u8), D), self.scale, np.float32)


def _imgs(n, seed=0, size=S):
    return np.random.RandomState(seed).randint(0, 256, (n, size, size, 3)).astype(np.uint8)


def _post(url, body, timeout=10.0):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"}, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _get(url, timeout=10.0):
    try:
        with urllib.request.urlopen(url, timeout=timeout) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _b64(img, **extra):
    return {"image_b64": base64.b64encode(img.tobytes()).decode("ascii"),
            "shape": list(img.shape), **extra}


# ---------------------------------------------------------------------------
# the batcher
# ---------------------------------------------------------------------------


class _Gate:
    def __init__(self):
        self.release = threading.Event()

    def __call__(self, batch):
        if not self.release.wait(timeout=10.0):
            raise RuntimeError("test gate never released")
        return batch * 2.0


def test_bucket_rules(pkg):
    b = pkg.batcher
    assert [b.bucket_for(n, (1, 8, 32)) for n in (1, 2, 8, 9, 32)] == [1, 8, 8, 32, 32]
    with pytest.raises(ValueError, match="exceeds the largest bucket 32"):
        b.bucket_for(33, (1, 8, 32))
    assert b.validate_buckets([1, 8]) == (1, 8)
    for bad in ((), (0, 4), (8, 1), (4, 4)):
        with pytest.raises(ValueError, match="ascending unique positive"):
            b.validate_buckets(bad)
    with pytest.raises(ValueError, match=r"max_queue \(4\) must hold at least one full"):
        b.MicroBatcher(lambda x: x, buckets=(1, 8), max_queue=4)


def test_deadline_flush_is_fifo_and_full_bucket_flushes_early(pkg):
    seen = []

    def run(batch):
        seen.append(batch.copy())
        return batch * 2.0

    b = pkg.batcher.MicroBatcher(run, buckets=(1, 4, 8), flush_ms=40.0, max_queue=16)
    try:
        results = [p.wait(timeout=5.0) for p in
                   [b.submit(np.array([float(i)])) for i in range(3)]]
        assert [r[0] for r in results] == [0.0, 2.0, 4.0]
        assert len(seen) == 1 and seen[0].shape[0] == 3
        assert b.batches == 1 and b.occupancy_sum == pytest.approx(3 / 4)
    finally:
        b.close()
    b = pkg.batcher.MicroBatcher(lambda x: x * 2.0, buckets=(1, 4), flush_ms=10_000.0,
                                 max_queue=8)
    try:
        t0 = time.monotonic()
        for p in [b.submit(np.array([float(i)])) for i in range(4)]:
            p.wait(timeout=5.0)
        assert time.monotonic() - t0 < 5.0
        assert b.batches == 1 and b.occupancy_mean == pytest.approx(1.0)
    finally:
        b.close()


def test_overload_and_deadline_shed_with_structured_errors(pkg):
    bt = pkg.batcher
    gate = _Gate()
    b = bt.MicroBatcher(gate, buckets=(1, 2), flush_ms=1.0, max_queue=4,
                        default_deadline_ms=30_000.0)
    try:
        first = b.submit(np.array([0.0]))
        time.sleep(0.1)
        queued = [b.submit(np.array([float(i)])) for i in range(1, 5)]
        t0 = time.monotonic()
        with pytest.raises(bt.OverloadedError) as exc:
            b.submit(np.array([99.0]))
        assert time.monotonic() - t0 < 1.0
        assert str(exc.value) == "admission queue full (4, tier=interactive)"
        assert exc.value.fields == {"retry_after_ms": 3.0, "tier": "interactive"}
        assert (exc.value.code, exc.value.http_status) == ("overloaded", 503)
        assert b.shed_overload == 1
        gate.release.set()
        for p in [first] + queued:
            assert p.wait(timeout=10.0)[0] == 2.0 * p.payload[0]
    finally:
        b.close()
    gate = _Gate()
    b = bt.MicroBatcher(gate, buckets=(1,), flush_ms=1.0, max_queue=8)
    try:
        first = b.submit(np.array([0.0]), deadline_s=30.0)
        time.sleep(0.05)
        doomed = b.submit(np.array([1.0]), deadline_s=0.01)
        time.sleep(0.1)
        gate.release.set()
        assert first.wait(timeout=10.0)[0] == 0.0
        with pytest.raises(bt.DeadlineExceededError) as exc:
            doomed.wait(timeout=10.0)
        assert (exc.value.code, exc.value.http_status) == ("deadline_exceeded", 504)
        assert set(exc.value.fields) == {"queued_ms"}
        assert b.shed_deadline == 1 and b.shed_deadline_by_tier["interactive"] == 1
    finally:
        b.close()


def test_drain_completes_accepted_work_and_close_rejects_leftovers(pkg):
    bt = pkg.batcher
    gate = _Gate()
    b = bt.MicroBatcher(gate, buckets=(1, 4), flush_ms=5.0, max_queue=16,
                        default_deadline_ms=30_000.0)
    pendings = [b.submit(np.array([float(i)])) for i in range(6)]
    drained = []
    t = threading.Thread(target=lambda: drained.append(b.drain(timeout_s=20.0)))
    t.start()
    time.sleep(0.1)
    with pytest.raises(bt.DrainingError, match="service is draining; not accepting work"):
        b.submit(np.array([99.0]))
    gate.release.set()
    t.join(timeout=20.0)
    assert drained == [True]
    assert [p.wait(timeout=1.0)[0] for p in pendings] == [2.0 * i for i in range(6)]
    b.close()
    gate = _Gate()
    b = bt.MicroBatcher(gate, buckets=(1,), flush_ms=1.0, max_queue=8)
    first = b.submit(np.array([0.0]))
    time.sleep(0.05)
    leftover = b.submit(np.array([1.0]))
    gate.release.set()
    b.close(drain=False)
    first.wait(timeout=10.0)
    with pytest.raises(bt.DrainingError, match="batcher closed before execution"):
        leftover.wait(timeout=1.0)


def test_batch_error_reaches_every_rider(pkg):
    def boom(batch):
        raise RuntimeError("device on fire")

    b = pkg.batcher.MicroBatcher(boom, buckets=(1, 4), flush_ms=5.0, max_queue=8)
    try:
        for p in [b.submit(np.array([float(i)])) for i in range(3)]:
            with pytest.raises(RuntimeError, match="device on fire"):
                p.wait(timeout=5.0)
        assert b.batch_errors == 1
    finally:
        b.close()


def test_batch_tier_floods_never_shed_interactive_and_interactive_goes_first(pkg):
    bt = pkg.batcher
    gate = threading.Event()
    order = []

    def run(payloads):
        gate.wait(10.0)
        order.append(list(payloads))
        return list(payloads)

    b = bt.MicroBatcher(run, buckets=(1, 4), max_queue=8, batch_max_queue=4, flush_ms=5.0,
                        default_deadline_ms=5000.0)
    try:
        shed = 0
        for i in range(12):
            try:
                b.submit(i, tier="batch")
            except bt.OverloadedError:
                shed += 1
        assert shed > 0 and b.shed_overload_by_tier["batch"] == shed
        pending = [b.submit(100 + i) for i in range(4)]
        assert b.shed_overload_by_tier["interactive"] == 0
        with pytest.raises(ValueError, match="unknown tier"):
            b.submit(0, tier="bulk")
        gate.set()
        assert all(p.wait(10.0) >= 100 for p in pending)
    finally:
        gate.set()
        b.close()
    gate.clear()
    order.clear()
    b = bt.MicroBatcher(run, buckets=(1, 2), max_queue=8, flush_ms=2.0,
                        default_deadline_ms=5000.0)
    try:
        batch_p = [b.submit(("b", i), tier="batch") for i in range(2)]
        time.sleep(0.05)
        inter_p = [b.submit(("i", i)) for i in range(2)]
        time.sleep(0.05)
        gate.set()
        for p in batch_p + inter_p:
            p.wait(10.0)
        assert order[1][0][0] == "i", order
    finally:
        gate.set()
        b.close()


# ---------------------------------------------------------------------------
# the cache and decode_image
# ---------------------------------------------------------------------------


def test_cache_keys_equal_across_packages_and_lru_by_bytes(pkg):
    from moco_tpu.serve.cache import EmbeddingCache as JaxCache

    cache_cls = pkg.cache.EmbeddingCache
    a, b = _imgs(2, seed=7)
    assert cache_cls.key_for(a) == JaxCache.key_for(a) == cache_cls.key_for(a.copy())
    assert cache_cls.key_for(a) != cache_cls.key_for(a.reshape(S * S, 3))
    cache = cache_cls(1)
    ka = cache_cls.key_for(a)
    assert cache.get(ka) is None and cache.misses == 1
    cache.put(ka, np.arange(4, dtype=np.float32))
    assert np.array_equal(cache.get(ka), [0, 1, 2, 3]) and cache.hits == 1
    src = np.ones(4, np.float32)
    cache.put("b", src)
    src[:] = 99.0
    assert np.array_equal(cache.get("b"), np.ones(4))
    row = np.zeros(65536, np.float32)  # 256 KiB: four fit in 1 MiB
    for i in range(5):
        cache.put(f"k{i}", row)
    assert cache.entries == 4 and cache.get("k0") is None and cache.get("k4") is not None
    assert cache.cached_bytes <= 2**20
    cache.put("huge", np.zeros(2**19, np.float64))
    assert cache.get("huge") is None
    cache.clear()
    assert cache.entries == 0 and cache.hits == 3
    with pytest.raises(ValueError, match="cache_mb must be positive, got 0"):
        cache_cls(0)


def _decode_outcomes(decode):
    img = _imgs(1, seed=3)[0]
    out = []
    for req in (_b64(img), {"pixels": img.tolist()}, {"image_b64": "AAAA"},
                {"image_b64": "AAAA", "shape": [S, S, 3]}, {"image_b64": "!!", "shape": [1, 1, 3]},
                {"pixels": [[1, 2], [3]]}, {}):
        try:
            arr = decode(req)
            out.append(("ok", arr.shape, str(arr.dtype), arr.tobytes() == img.tobytes()))
        except ValueError as e:
            out.append(("error", str(e)))
    return out


def test_decode_image_equals_the_jax_packages(pkg):
    from moco_tpu.serve.http import decode_image as jax_decode

    got = _decode_outcomes(pkg.http.decode_image)
    assert got == _decode_outcomes(jax_decode)
    assert [o[0] for o in got] == ["ok", "ok", "error", "error", "error", "error", "error"]


# ---------------------------------------------------------------------------
# the service and the HTTP front end
# ---------------------------------------------------------------------------


def _service(pkg, engine=None, **kw):
    args = dict(flush_ms=2.0, max_queue=64, request_deadline_ms=10_000.0)
    args.update(kw)
    return pkg.service.EmbedService(engine or StubEngine(), **args)


def _knn_expect(pkg, emb, bank, labels, k):
    """The class the package's own `ops/knn.knn_predict` gives."""
    if pkg.name == "moco_tpu":
        from moco_tpu.ops.knn import knn_predict

        return int(np.asarray(knn_predict(emb[None], bank, labels.astype(np.int32), 4,
                                          k=k))[0])
    import torch

    from moco_tpu_torch.ops.knn import knn_predict

    return int(knn_predict(torch.from_numpy(emb[None]), torch.from_numpy(bank),
                           torch.from_numpy(labels), 4, k=k)[0])


def _http_transcript(pkg, tmp_path):
    """(status, body) of every route for one stub-engine service with a kNN
    bank, telemetry and the cache; bodies with timings reduced to keys."""
    bank = _embed_stub(_imgs(32, seed=5))
    labels = np.arange(32) % 4
    registry = pkg.registry.MetricsRegistry(str(tmp_path / f"{pkg.name}.jsonl"), flush_every=1)
    service = _service(pkg, cache_mb=4, registry=registry, snapshot_every=1,
                       knn_bank=bank, knn_labels=labels, knn_k=5)
    frontend = pkg.http.ServeFrontend(service, port=0)
    frontend.start()
    img, other = _imgs(2, seed=11)
    out = []
    try:
        for path, body in (("/v1/embed", _b64(img)), ("/v1/embed", _b64(img)),
                           ("/v1/knn", _b64(img, return_embedding=True)),
                           ("/v1/embed", _b64(other, tier="batch")),
                           ("/v1/embed", {"image_b64": "AAAA"}),
                           ("/v1/embed", _b64(np.zeros((4, 4, 3), np.uint8))),
                           ("/v1/embed", {"image_b64": "AAAA", "shape": [S, S, 3]}),
                           ("/v1/embed", _b64(img, tier="bulk")),
                           ("/v1/knn", {"candidates": True, "embedding": [0.1] * D}),
                           ("/v1/nope", {})):
            status, resp = _post(frontend.url + path, body)
            if "detail" in resp:  # each package names its own bank builder
                resp["detail"] = resp["detail"].replace(
                    "python -m moco_tpu_torch.bank_build", "tools/bank_build.py")
            out.append((path, status, resp))
        for path in ("/healthz", "/admin/bank", "/nope"):
            out.append((path,) + _get(frontend.url + path))
        status, stats = _get(frontend.url + "/stats")
        out.append(("/stats", status, sorted(stats), stats["requests"], stats["served"],
                    stats["cache"]["hits"], stats["tiers"]["submitted"]))
        status, body = _post(frontend.url + "/admin/reload", {})
        out.append(("/admin/reload", status, body))
        status, body = _post(frontend.url + "/admin/reload", {"pretrained": "x", "step": "a"})
        out.append(("/admin/reload", status, body["error"]))
        status, body = _post(frontend.url + "/admin/reload", {"pretrained": "x"})
        out.append(("/admin/reload", status, body["error"]))
    finally:
        service.drain(timeout_s=10.0)
        frontend.shutdown()
        registry.close()
    return out, (bank, labels, img)


def test_http_routes_and_error_bodies(pkg, tmp_path):
    out, (bank, labels, img) = _http_transcript(pkg, tmp_path)
    by = [(o[0], o[1]) for o in out]
    assert by == [("/v1/embed", 200), ("/v1/embed", 200), ("/v1/knn", 200), ("/v1/embed", 200),
                  ("/v1/embed", 400), ("/v1/embed", 400), ("/v1/embed", 400), ("/v1/embed", 400),
                  ("/v1/knn", 400), ("/v1/nope", 404), ("/healthz", 200), ("/admin/bank", 200),
                  ("/nope", 404), ("/stats", 200), ("/admin/reload", 400),
                  ("/admin/reload", 400), ("/admin/reload", 409)]
    first, second, knn = out[0][2], out[1][2], out[2][2]
    assert first["cached"] is False and second["cached"] is True
    emb = np.asarray(first["embedding"], np.float32)
    assert np.array_equal(emb, _embed_stub(img[None])[0])
    assert knn["class"] == _knn_expect(pkg, emb, bank, labels, 5)
    assert np.array_equal(np.asarray(knn["embedding"], np.float32), emb)
    assert out[4][2]["error"] == "bad_request"
    assert out[8][2] == {"error": "bad_request", "detail": out[8][2]["detail"]}
    assert "no ANN index configured" in out[8][2]["detail"]
    assert out[9][2] == {"error": "not_found", "path": "/v1/nope"}
    assert out[10][2] == {"status": "ok", "queue_depth": 0}
    assert out[11][2] == {"configured": True, "rows": 32, "feat_dim": D, "generation": 0,
                          "swaps": 0}
    assert out[13][3:] == (4, 4, 2, {"interactive": 1, "batch": 1})
    assert out[14][2] == {"error": "bad_request", "detail": 'body needs {"pretrained": <path>}'}
    assert out[16][2] == "reload_refused"  # no engine factory wired


def test_http_transcripts_equal_across_packages(tmp_path):
    """The same requests against either package's service answer with the
    same statuses and bodies (the reload refusal's text names each
    package's own tools)."""
    jax_out, _ = _http_transcript(_Pkg("moco_tpu"), tmp_path)
    port_out, _ = _http_transcript(_Pkg("moco_tpu_torch"), tmp_path)
    assert port_out == jax_out


def test_draining_service_rejects_over_http(pkg):
    service = _service(pkg)
    frontend = pkg.http.ServeFrontend(service, port=0)
    frontend.start()
    try:
        assert service.drain(timeout_s=5.0)
        status, body = _post(frontend.url + "/v1/embed", _b64(_imgs(1)[0]))
        assert status == 503 and body == {"error": "draining",
                                          "detail": "service is draining; not accepting work"}
        assert _get(frontend.url + "/healthz") == (503, {"status": "draining"})
        status, body = _post(frontend.url + "/admin/reload", {"pretrained": "x"})
        assert (status, body) == (503, {"error": "draining"})
    finally:
        frontend.shutdown()


def test_serve_snapshots_render_in_the_telemetry_report(pkg, tmp_path):
    report = _load_tool("telemetry_report")
    events = str(tmp_path / "events.jsonl")
    registry = pkg.registry.MetricsRegistry(events, flush_every=1)
    service = _service(pkg, registry=registry, snapshot_every=1, cache_mb=1)
    try:
        for i in range(4):
            service.embed(_imgs(1, seed=100 + i)[0])
    finally:
        service.drain(timeout_s=10.0)
        registry.close()
    records, skipped = report.load_events(events)
    assert skipped == 0
    summary = report.summarize(records)
    assert summary["serve"]["requests"] == 4 and summary["serve"]["batches"] >= 1
    assert "p95" in summary["serve"]["latency_ms"]
    rendered = report.render(summary)
    assert "serve:" in rendered and "occupancy mean" in rendered
    starts = [r for r in records if r.get("kind") == "serve_start"]
    assert starts and starts[0]["buckets"] == [1, 4] and starts[0]["feat_dim"] == D
    assert records[-1]["kind"] == "serve" and records[-1]["final"] is True


def test_classify_votes_like_knn_predict_with_the_jax_arguments(pkg):
    """`classify` against the package's `knn_predict`; the port's
    `knn_predict` takes the JAX function's arguments, in its order."""
    import moco_tpu.ops.knn as jknn
    import moco_tpu_torch.ops.knn as tknn

    assert (list(inspect.signature(tknn.knn_predict).parameters)
            == list(inspect.signature(jknn.knn_predict).parameters))
    assert ({k: v.default for k, v in inspect.signature(tknn.knn_predict).parameters.items()}
            == {k: v.default for k, v in inspect.signature(jknn.knn_predict).parameters.items()})
    bank = _embed_stub(_imgs(40, seed=9)) * np.linspace(0.5, 2.0, 40)[:, None]
    labels = np.arange(40) % 4
    service = _service(pkg, knn_bank=bank.astype(np.float32), knn_labels=labels, knn_k=7)
    try:
        for seed in range(6):
            img = _imgs(1, seed=200 + seed)[0]
            cls_id, emb, cached = service.classify(img)
            assert cls_id == _knn_expect(pkg, np.asarray(emb, np.float32),
                                         bank.astype(np.float32), labels, 7)
        with pytest.raises(ValueError, match="expected one"):
            service.embed(np.zeros((S, S, 3), np.float32))
    finally:
        service.drain(timeout_s=5.0)
    bare = _service(pkg)
    try:
        with pytest.raises(ValueError, match="no kNN feature bank configured"):
            bare.classify(_imgs(1)[0])
    finally:
        bare.drain(timeout_s=5.0)


# ---------------------------------------------------------------------------
# hot reload, the drift guard, the generation-tagged rows
# ---------------------------------------------------------------------------


def test_reload_swaps_clears_the_cache_and_guards(pkg):
    svc = pkg.service
    service = _service(pkg, StubEngine(1.0), cache_mb=4)
    try:
        with pytest.raises(ValueError, match="hot reload is not configured"):
            service.reload("whatever.npz")
        service.set_engine_factory(lambda path: StubEngine(2.0))
        img = _imgs(1, seed=7)[0]
        before, cached = service.embed(img)
        assert cached is False and service.embed(img)[1] is True
        entry = service.reload("b.npz", step=123)
        assert entry["step"] == 123 and entry["feat_dim"] == D
        assert set(entry) == {"step", "pretrained", "warm_s", "feat_dim", "probe_drift",
                              "probe_spread"}
        after, cached = service.embed(img)
        assert cached is False and np.array_equal(after, _embed_stub(img[None], 2.0)[0])
        assert getattr(after, "gen", None) == 1
        stats = service.stats()
        assert stats["reloads"] == 1 and stats["reload_history"][0]["step"] == 123

        def missing(path):
            raise FileNotFoundError(path)

        service.set_engine_factory(missing)
        with pytest.raises(ValueError, match="cannot load 'nope.npz'"):
            service.reload("nope.npz")
        service.set_engine_factory(lambda path: StubEngine(3.0, buckets=(1, 8)))
        with pytest.raises(svc.ReloadRefusedError, match="bucket ladder"):
            service.reload("c.npz")
        service.set_engine_factory(lambda path: ConstEngine(1.0))
        with pytest.raises(svc.CollapsedCheckpointError, match="degenerate"):
            service.reload("collapsed.npz")
        assert service.reloads == 1
        assert np.array_equal(service.embed(img)[0], after)
    finally:
        service.drain(timeout_s=10.0)
    engine = StubEngine(1.0)
    bank = engine.embed(_imgs(8, seed=1))
    service = _service(pkg, engine, knn_bank=bank, knn_labels=np.arange(8) % 2, knn_k=3)

    def exploding(path):
        raise AssertionError("factory must not run for a refused reload")

    service.set_engine_factory(exploding)
    try:
        with pytest.raises(ValueError, match="kNN bank") as e:
            service.reload("b.npz")
        assert "bank_build" in str(e.value) and e.value.bank_step is None
        assert service.classify(_imgs(1, seed=2)[0])[0] in (0, 1)
    finally:
        service.drain(timeout_s=10.0)


def test_inflight_old_rows_never_repopulate_the_cache(pkg):
    gate = threading.Event()
    service = _service(pkg, StubEngine(1.0, gate=gate), cache_mb=4, reload_probe=0)
    service.set_engine_factory(lambda path: StubEngine(2.0))
    try:
        img = np.zeros((S, S, 3), np.uint8)
        result = {}

        def request():
            result["row"], result["cached"] = service.embed(img)

        t = threading.Thread(target=request)
        t.start()
        time.sleep(0.2)
        reloader = threading.Thread(target=lambda: result.update(swap=service.reload("new")))
        reloader.start()
        time.sleep(0.2)
        gate.set()
        t.join(timeout=10.0)
        reloader.join(timeout=10.0)
        assert result["row"][0] == _embed_stub(img[None], 1.0)[0][0]
        assert getattr(result["row"], "gen", None) == 0
        row, cached = service.embed(img)
        assert cached is False and row[0] == _embed_stub(img[None], 2.0)[0][0]
    finally:
        gate.set()
        service.drain(timeout_s=10.0)


def test_wedge_chaos_hangs_every_route_and_kill_fires_once(pkg, tmp_path):
    plan = pkg.chaos.parse_chaos_spec("wedge_at_request=2")
    service = _service(pkg)
    frontend = pkg.http.ServeFrontend(service, port=0)
    frontend.start()
    pkg.chaos.install_chaos(plan)
    try:
        img = _imgs(1)[0]
        assert _post(frontend.url + "/v1/embed", _b64(img))[0] == 200
        assert _post(frontend.url + "/v1/embed", _b64(img))[0] == 200
        assert service.wedged
        with pytest.raises(OSError):  # a timeout: accepted, never answered
            _get(frontend.url + "/healthz", timeout=0.5)
        assert plan.maybe_wedge_request(2) is False  # fire-once
    finally:
        pkg.chaos.clear_chaos()
        service.wedged = False
        service.drain(timeout_s=5.0)
        frontend.shutdown()
    code = (f"from {pkg.name}.resilience.chaos import parse_chaos_spec\n"
            "p = parse_chaos_spec('kill_at_request=3')\n"
            "p.maybe_kill_request(2); print('alive', flush=True); p.maybe_kill_request(3)\n"
            "print('survived')\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          cwd=REPO, timeout=60, env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert proc.returncode == -signal.SIGKILL and "alive" in proc.stdout
    assert "survived" not in proc.stdout


# ---------------------------------------------------------------------------
# the dual swap with a verified paired bank
# ---------------------------------------------------------------------------


def _ckpt(root, step, payload):
    d = root / "export" / str(step)
    d.mkdir(parents=True, exist_ok=True)
    path = d / "encoder.npz"
    path.write_bytes(payload)
    return str(path)


def _stub_pair(pkg, root, step, scale, name):
    ck = _ckpt(root / name, step, name.encode() * 100)
    images = _imgs(8, seed=step)
    pkg.bankbuild.build_bank(str(root / name / "bank"), step, images, np.arange(8) % 3,
                             lambda b: _embed_stub(b, scale), checkpoint_path=ck,
                             image_size=S)
    return ck, str(root / name / "bank" / str(step) / "bank.npz")


def _bank_service(pkg, bank_path, scale=1.0):
    feats, labels, meta = pkg.bankbuild.load_bank(bank_path)
    service = _service(pkg, StubEngine(scale), flush_ms=1.0, request_deadline_ms=30_000.0,
                       knn_bank=feats, knn_labels=labels, knn_k=3, knn_bank_meta=meta)
    service.set_engine_factory(lambda path: StubEngine(2.0))
    return service


def test_dual_swap_http_contract_and_admin_bank(pkg, tmp_path):
    import shutil

    ck1, bank1 = _stub_pair(pkg, tmp_path, 1, 1.0, "one")
    ck2, bank2 = _stub_pair(pkg, tmp_path, 2, 2.0, "two")
    service = _bank_service(pkg, bank1)
    frontend = pkg.http.ServeFrontend(service, port=0)
    frontend.start()
    try:
        status, resp = _get(frontend.url + "/admin/bank")
        assert status == 200 and resp["bank_step"] == 1 and resp["rows"] == 8
        assert resp["generation"] == 0 and resp["swaps"] == 0
        status, resp = _post(frontend.url + "/admin/reload", {"pretrained": ck2})
        assert status == 409 and resp["error"] == "reload_refused"
        assert "bank_build" in resp["detail"] and resp["bank_step"] == 1
        inflight = tmp_path / "inflight" / "2"
        inflight.mkdir(parents=True)
        shutil.copy(bank2, inflight / "bank.npz")
        status, resp = _post(frontend.url + "/admin/reload",
                             {"pretrained": ck2, "bank": str(inflight / "bank.npz"),
                              "bank_step": 2})
        assert status == 503 and resp["error"] == "reload_failed" and "in flight" in resp["detail"]
        status, resp = _post(frontend.url + "/admin/reload",
                             {"pretrained": ck2, "bank": bank1, "bank_step": 1})
        assert status == 409 and resp["error"] == "reload_bank_mismatch"
        assert "not a pair" in resp["detail"]
        status, resp = _post(frontend.url + "/admin/reload",
                             {"pretrained": ck2, "step": 2, "bank": bank2, "bank_step": 2})
        assert status == 200 and resp["status"] == "reloaded"
        assert resp["bank_step"] == 2 and resp["bank_rows"] == 8
        assert resp["bank_agreement"] == pytest.approx(1.0)
        img = np.full((S, S, 3), 100, np.uint8)
        status, resp = _post(frontend.url + "/v1/embed", _b64(img))
        assert status == 200 and np.allclose(resp["embedding"], _embed_stub(img[None], 2.0)[0])
        status, resp = _post(frontend.url + "/v1/knn", _b64(img))
        assert status == 200 and resp["class"] in (0, 1, 2)
        status, resp = _get(frontend.url + "/admin/bank")
        assert resp["bank_step"] == 2 and resp["swaps"] == 1 and resp["generation"] == 1
        assert _get(frontend.url + "/stats")[1]["bank"]["bank_step"] == 2
    finally:
        service.drain(timeout_s=10.0)
        frontend.shutdown()


def test_dual_swap_under_load_keeps_every_row_in_its_generation(pkg, tmp_path):
    ck1, bank1 = _stub_pair(pkg, tmp_path, 1, 1.0, "one")
    ck2, bank2 = _stub_pair(pkg, tmp_path, 2, 2.0, "two")
    service = _bank_service(pkg, bank1)
    try:
        stop = threading.Event()
        results, errors = [], []
        imgs = _imgs(64, seed=0)

        def client(i):
            while not stop.is_set():
                img = imgs[i % len(imgs)]
                i += 1
                try:
                    row, _ = service.embed(img)
                except Exception as e:  # pragma: no cover - fails the test
                    errors.append(e)
                    return
                results.append((img, np.asarray(row, np.float32), getattr(row, "gen", 0)))

        threads = [threading.Thread(target=client, args=(s,)) for s in range(4)]
        for t in threads:
            t.start()
        time.sleep(0.2)
        entry = service.reload(ck2, step=2, bank=bank2, bank_step=2)
        time.sleep(0.2)
        stop.set()
        for t in threads:
            t.join(timeout=10.0)
        assert not errors and entry["bank_agreement"] == pytest.approx(1.0)
        by_gen = {0: 0, 1: 0}
        for img, row, gen in results:
            assert np.allclose(row, _embed_stub(img[None], {0: 1.0, 1: 2.0}[gen])[0])
            by_gen[gen] += 1
        assert by_gen[0] > 0 and by_gen[1] > 0
        assert service.classify(imgs[0])[0] in (0, 1, 2)
    finally:
        service.drain(timeout_s=10.0)


def test_doctored_manifest_refused_by_space_agreement(pkg, tmp_path):
    from moco_tpu_torch.resilience.integrity import manifest_path

    ck1, bank1 = _stub_pair(pkg, tmp_path, 1, 1.0, "one")
    ck2, bank2 = _stub_pair(pkg, tmp_path, 2, 2.0, "two")
    mpath = manifest_path(str(tmp_path / "two" / "bank"), 2)
    with open(mpath) as f:
        manifest = json.load(f)
    manifest["probe"]["features"] = [[-x for x in row] for row in manifest["probe"]["features"]]
    with open(mpath, "w") as f:
        json.dump(manifest, f)
    assert pkg.bankbuild.verify_bank(str(tmp_path / "two" / "bank"), 2) is None
    service = _bank_service(pkg, bank1)
    try:
        with pytest.raises(pkg.service.BankMismatchError, match="space-agreement"):
            service.reload(ck2, step=2, bank=bank2, bank_step=2)
        assert service.reloads == 0 and service.bank_info()["bank_step"] == 1
        service.set_engine_factory(
            lambda path: (_ for _ in ()).throw(AssertionError("no factory")))
        ck4, bank4 = _stub_pair(pkg, tmp_path, 4, 2.0, "four")
        with pytest.raises(pkg.service.BankMismatchError, match="recorded step"):
            service.reload(ck4, bank=bank4, bank_step=999)
    finally:
        service.drain(timeout_s=10.0)


# ---------------------------------------------------------------------------
# ServeConfig
# ---------------------------------------------------------------------------

BAD_CONFIGS = [dict(buckets=(8, 1)), dict(max_queue=4), dict(request_deadline_ms=0),
               dict(flush_ms=-1.0), dict(embed_cache_mb=-1), dict(reload_probe=-1),
               dict(bank_agreement_min=2.0), dict(trace_mode="loud"),
               dict(trace_capture_steps=0), dict(ann_cells=-1), dict(ann_shard=4, ann_shards=4),
               dict(ann_cells=16), dict(batch_max_queue=2), dict(batch_deadline_ms=0)]


def _config_error(cls, kw):
    try:
        cls(**kw)
    except ValueError as e:
        return str(e)
    return None


def test_serve_config_fields_defaults_and_messages_are_the_jax_packages():
    import moco_tpu.config as jcfg
    import moco_tpu_torch.config as tcfg

    def fields(cls):
        return [(f.name, f.default) for f in dataclasses.fields(cls)]

    assert fields(tcfg.ServeConfig) == fields(jcfg.ServeConfig)
    for kw in BAD_CONFIGS:
        msg = _config_error(tcfg.ServeConfig, kw)
        assert msg is not None and msg == _config_error(jcfg.ServeConfig, kw), kw


def test_serve_config_flags(pkg):
    import argparse

    parser = argparse.ArgumentParser()
    pkg.config.add_config_flags(parser, pkg.config.ServeConfig)
    args = parser.parse_args(["--buckets", "1", "4", "16", "--max-queue", "64",
                              "--flush-ms", "7.5", "--admission-tiers", "false",
                              "--knn-bank", "b.npz", "--ann-cells", "8"])
    config = pkg.config.ServeConfig().replace(
        **pkg.config.collect_overrides(args, pkg.config.ServeConfig))
    assert config.buckets == (1, 4, 16) and config.max_queue == 64
    assert config.flush_ms == 7.5 and config.admission_tiers is False
    assert config.ann_cells == 8 and config.knn_bank == "b.npz"


def test_serve_package_exports_the_jax_names_but_the_fleet():
    import moco_tpu.serve as jserve
    import moco_tpu_torch.serve as tserve

    # the fleet came with a later slice: every JAX name is now exported
    assert set(jserve.__all__) <= set(tserve.__all__)
    for name in tserve.__all__:
        owner = getattr(getattr(tserve, name), "__module__", None)  # None: DEFAULT_BUCKETS
        assert owner is None or owner.startswith("moco_tpu_torch.serve."), name
    assert tserve.DEFAULT_BUCKETS == jserve.DEFAULT_BUCKETS == (1, 8, 32, 128)
    assert tserve.FleetRouter.__module__ == "moco_tpu_torch.serve.fleet"
    with pytest.raises(AttributeError):
        tserve.not_a_name  # noqa: B018


# ---------------------------------------------------------------------------
# the real engine against the JAX one
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """The JAX `tiny_setup` (resnet_tiny, cifar stem, 32 px, key 0), its
    engine warmed, and its export in the reference's torchvision dialect;
    a second export (key 1) for the reloads."""
    import jax
    import jax.numpy as jnp

    from moco_tpu.checkpoint import _save_flat, resnet_to_torchvision
    from moco_tpu.models import build_backbone
    from moco_tpu.serve import EmbeddingEngine as JaxEngine

    model = build_backbone("resnet_tiny", cifar_stem=True)
    root = tmp_path_factory.mktemp("exports")
    paths, engine = [], None
    for seed in (0, 1):
        variables = model.init(jax.random.key(seed), jnp.zeros((1, SIZE, SIZE, 3)), train=False)
        params, stats = variables["params"], variables.get("batch_stats", {})
        flat = resnet_to_torchvision(jax.tree.map(np.asarray, params),
                                     jax.tree.map(np.asarray, stats),
                                     prefix="module.encoder_q.")
        paths.append(str(root / f"encoder_{seed}.npz"))
        _save_flat(flat, paths[-1])
        if seed == 0:  # one bucket: one XLA program to compile
            engine = JaxEngine(model, params, stats, image_size=SIZE, buckets=(16,))
            engine.warmup()
            trees = (jax.tree.map(np.asarray, params), jax.tree.map(np.asarray, stats))
    return engine, paths, trees


def _port_engine(path, buckets=BUCKETS):
    from moco_tpu_torch.serve import EmbeddingEngine

    engine = EmbeddingEngine.from_checkpoint(path, "resnet_tiny", image_size=SIZE,
                                             cifar_stem=True, buckets=buckets, device="cpu")
    engine.warmup()
    return engine


def test_engine_matches_the_jax_engine(tiny):
    """The export loaded through the checkpoint surgery, and the same flax
    weights carried by `weights.params_from_jax`, give the same bits; both
    agree with the JAX engine within the stated f32 tolerance."""
    from moco_tpu_torch.models import build_backbone
    from moco_tpu_torch.serve import EmbeddingEngine
    from moco_tpu_torch.weights import params_from_jax

    jax_engine, (path, _), (params, stats) = tiny
    engine = _port_engine(path)
    model = build_backbone("resnet_tiny", cifar_stem=True)
    model.load_state_dict(params_from_jax(params, stats), strict=True)
    direct = EmbeddingEngine(model, image_size=SIZE, buckets=BUCKETS)
    assert engine.feat_dim == jax_engine.feat_dim == direct.warmup()
    for n, seed in ((1, 0), (3, 1), (16, 2)):
        imgs = _imgs(n, seed=seed, size=SIZE)
        got, ref = engine.embed(imgs), jax_engine.embed(imgs)
        assert got.dtype == np.float32 and got.shape == ref.shape == (n, engine.feat_dim)
        np.testing.assert_allclose(got, ref, rtol=ENGINE_RTOL, atol=ENGINE_ATOL)
        assert np.array_equal(direct.embed(imgs), got)


def test_engine_fixed_program_set_and_batch_composition(tiny):
    _, (path, _), _ = tiny
    engine = _port_engine(path)
    assert engine.compiled_programs() == len(BUCKETS)
    imgs = _imgs(16, seed=42, size=SIZE)
    full = engine.embed(imgs)
    for n in (1, 3, 4, 5, 1):
        out = engine.embed(imgs[:n])
        assert out.shape == (n, engine.feat_dim)
        assert np.array_equal(out, full[:n]), n  # alone, padded, in any bucket
    assert np.array_equal(engine.embed(imgs[::-1].copy())[-1], full[0])
    assert engine.compiled_programs() == len(BUCKETS)
    with pytest.raises(ValueError, match="expected"):
        engine.embed(imgs[:1].astype(np.float32))
    with pytest.raises(ValueError, match="expected"):
        engine.embed(np.zeros((1, SIZE, SIZE + 1, 3), np.uint8))
    with pytest.raises(ValueError, match="exceeds the largest bucket"):
        engine.embed(_imgs(BUCKETS[-1] + 1, size=SIZE))
    with pytest.raises(ValueError, match="surgery mismatch"):
        _port_engine_arch(path, "vit_tiny")
    with pytest.raises(RuntimeError, match="CUDA was requested"):
        _cuda_engine_without_a_card(path)


def _port_engine_arch(path, arch):
    from moco_tpu_torch.serve import EmbeddingEngine

    return EmbeddingEngine.from_checkpoint(path, arch, image_size=SIZE, cifar_stem=True,
                                           device="cpu")


def _cuda_engine_without_a_card(path):
    import torch

    from moco_tpu_torch.serve import EmbeddingEngine

    if torch.cuda.is_available():  # pragma: no cover - the card's machine
        raise RuntimeError("CUDA was requested (a card is present here)")
    return EmbeddingEngine.from_checkpoint(path, "resnet_tiny", image_size=SIZE,
                                           cifar_stem=True)


def test_reload_of_real_engines_equals_a_cold_start(tiny):
    from moco_tpu_torch.serve import EmbedService

    _, (path_a, path_b), _ = tiny
    service = EmbedService(_port_engine(path_a), flush_ms=2.0, max_queue=32,
                           request_deadline_ms=10_000.0, cache_mb=4)
    service.set_engine_factory(lambda p: _port_engine(p))
    try:
        img = _imgs(1, seed=7, size=SIZE)[0]
        before, _ = service.embed(img)
        entry = service.reload(path_b, step=5)
        assert entry["probe_spread"] > service.reload_min_spread
        after, cached = service.embed(img)
        assert cached is False
        assert np.array_equal(after, _port_engine(path_b).embed(img[None])[0])
        assert not np.array_equal(after, before)
    finally:
        service.drain(timeout_s=10.0)


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------


def test_serve_cli_drains_on_sigterm(tiny, tmp_path):
    _, (path, _), _ = tiny
    env = {**os.environ, "PYTHONPATH": REPO}
    proc = subprocess.Popen(
        [sys.executable, "-u", "-m", "moco_tpu_torch.serve", "--pretrained", path,
         "--arch", "resnet_tiny", "--image-size", str(SIZE), "--cifar-stem", "true",
         "--port", "0", "--buckets", "1", "4", "--device", "cpu",
         "--telemetry-dir", str(tmp_path / "telemetry")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env, cwd=REPO)
    try:
        url = None
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            line = proc.stdout.readline()
            if not line:
                break
            if "serving" in line and "http://" in line:
                url = line.split("http://")[1].split()[0].rstrip("/")
                break
        assert url, "the server never announced its url"
        status, resp = _post(f"http://{url}/v1/embed", _b64(_imgs(1, seed=21, size=SIZE)[0]),
                             timeout=30.0)
        assert status == 200 and len(resp["embedding"]) > 0
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=30)
        assert proc.returncode == 0, out
        assert "drained cleanly" in out
        kinds = [json.loads(ln).get("kind") for ln in
                 (tmp_path / "telemetry" / "events.jsonl").read_text().splitlines()
                 if ln.strip()]
        assert "serve_start" in kinds and "serve" in kinds
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate(timeout=10)


def test_serve_cli_exit_codes(tiny, tmp_path, capsys):
    """45 without a card and without `--device cpu` (this host has none),
    for a missing checkpoint, a missing `--pretrained` and a bad config;
    47 for a port that is taken."""
    import socket

    import torch

    from moco_tpu_torch.serve.__main__ import main

    _, (path, _), _ = tiny
    base = ["--arch", "resnet_tiny", "--image-size", str(SIZE), "--cifar-stem", "true",
            "--buckets", "1", "4"]
    assert not torch.cuda.is_available()
    assert main(base + ["--pretrained", path]) == 45
    assert "CUDA was requested" in capsys.readouterr().out
    assert main(base + ["--pretrained", str(tmp_path / "nope.npz"), "--device", "cpu"]) == 45
    assert main(base + ["--device", "cpu"]) == 45
    assert main(base + ["--pretrained", path, "--max-queue", "2", "--device", "cpu"]) == 45
    out = capsys.readouterr().out
    assert "--pretrained <exported encoder> is required" in out and "max_queue (2)" in out
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        s.listen(1)
        port = s.getsockname()[1]
        assert main(base + ["--pretrained", path, "--device", "cpu", "--port", str(port)]) == 47
