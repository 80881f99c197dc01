"""The port's run telemetry (`moco_tpu_torch/telemetry/`, `utils/logging.py`,
`utils/meters.py`) against the JAX package's, on the CPU.

- The stdlib copies (registry, heartbeat, tracer, pod aggregator) driven by
  the same calls as the JAX classes write the same JSONL records, equal
  except for timestamps, ids and process ids.
- The analytic FLOPs equal the JAX values exactly for every preset of the
  port; the peak table names the H100s and every device the JAX table does.
- The phase timer's stride fencing, the meters and the event sinks: the JAX
  package's own cases, run against the port.
- A tiny pretrain through the port's driver with telemetry on (the JAX
  suite's `telemetry_run` configuration, with span recording at `steps`)
  writes the JAX driver's record kinds with the same keys; the repo's
  `tools/telemetry_report.py` and `tools/trace_report.py` read it; the
  trajectory with telemetry (and health) on equals it off, bit for bit.
- Two gloo ranks: only rank 0 writes, and the `pod` record folds both.
"""

from __future__ import annotations

import importlib
import json
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from moco_tpu.config import get_preset as jax_get_preset
from moco_tpu_torch.config import PretrainConfig, get_preset, preset_names

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPORT = os.path.join(REPO, "tools", "telemetry_report.py")
TRACE_REPORT = os.path.join(REPO, "tools", "trace_report.py")

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_dist_worker import spawn  # noqa: E402


def _both(module: str):
    """(JAX package module, port module) of `telemetry/<module>`."""
    return (importlib.import_module(f"moco_tpu.telemetry.{module}"),
            importlib.import_module(f"moco_tpu_torch.telemetry.{module}"))


def _lines(path) -> list[dict]:
    with open(path, encoding="utf-8") as f:
        return [json.loads(line) for line in f if line.strip()]


# ---------------------------------------------------------------------------
# the stdlib copies write the same records
# ---------------------------------------------------------------------------

_RECORDS = [
    ("run_start", dict(name="moco", arch="resnet50", batch_size=256, peak_flops_per_chip=None)),
    ("step", dict(step=1, step_s=0.25, data_s=0.001, loss=float("nan"),
                  health={"emb_std_q": 0.1, "pdrift": float("inf")})),
    ("step", dict(step=2, step_s=np.float32(0.5), hbm_peak_bytes=np.int64(1 << 33),
                  input={"workers": 4, "queue_depth": 2})),
    ("event", dict(event="grad_sync", mode="fused", sync_bytes_per_step=94037504,
                   sharding="dp")),
    ("pod", dict(step=16, hosts=2, step_s_max=0.3, imgs_per_sec_sum=1900.5)),
    ("run_end", dict(steps=2, incidents=0, scalar_drops=0, last_step=2, preempted=False)),
]


@pytest.mark.parametrize("flush_every", [1, 3, 50])
def test_registry_writes_the_jax_records(tmp_path, flush_every):
    """The same emits through both registries: the same lines but `t`, the
    same flush answers, instruments and counts."""
    out = {}
    for tag, mod in zip(("jax", "port"), _both("registry")):
        path = tmp_path / tag / mod.EVENTS_FILENAME
        reg = mod.MetricsRegistry(str(path), flush_every=flush_every,
                                  stamp={"run_id": "r", "trace_id": "t"})
        flushed = [reg.emit(kind, **fields) for kind, fields in _RECORDS]
        h = reg.histogram("step_s")
        for v in (0.3, 0.1, 0.2, 0.5, 0.4):
            h.observe(v)
        g = reg.gauge("hbm")
        g.set(7)
        g.set(3)
        reg.counter("incidents").inc(2)
        reg.close()
        out[tag] = dict(lines=[{k: v for k, v in r.items() if k != "t"} for r in _lines(path)],
                        flushed=flushed, written=reg.records_written,
                        pct=h.percentiles_ms(), mean=h.mean, hw=g.high_water,
                        count=reg.counter("incidents").value)
    assert out["port"] == out["jax"]
    assert out["port"]["lines"][1]["loss"] == "nan"  # RFC-8259-safe, as in JAX


def test_registry_repairs_a_torn_tail_as_jax_does(tmp_path):
    out = {}
    for tag, mod in zip(("jax", "port"), _both("registry")):
        path = tmp_path / f"{tag}.jsonl"
        path.write_text('{"v": 1, "kind": "step", "step": 1}\n{"v": 1, "kind": "st')
        reg = mod.MetricsRegistry(str(path), flush_every=1)
        reg.emit("run_start", name="resumed")
        reg.close()
        out[tag] = path.read_text().splitlines()
    assert [line for line in out["port"] if '"t"' not in line] == \
        [line for line in out["jax"] if '"t"' not in line]
    assert json.loads(out["port"][-1])["name"] == "resumed"


def test_null_sink_registry_writes_nothing(tmp_path):
    _, port = _both("registry")
    reg = port.MetricsRegistry(None, flush_every=1)
    assert reg.emit("step", step=1) is False
    reg.close()
    assert list(tmp_path.iterdir()) == []


def test_heartbeat_payload_matches_jax(tmp_path):
    out = {}
    for tag, mod in zip(("jax", "port"), _both("registry")):
        hb = mod.Heartbeat(str(tmp_path / tag / mod.HEARTBEAT_FILENAME), min_interval_secs=60)
        hb.beat(0, phase="run_start")
        wrote = [hb.maybe_beat(s, phase="step", last_step_ms=12.5) for s in (1, 2)]
        with open(hb.path) as f:
            payload = json.load(f)
        assert payload["pid"] == os.getpid()
        out[tag] = (wrote, {k: v for k, v in payload.items() if k not in ("t", "mono_s")})
    assert out["port"] == out["jax"]
    assert out["port"][0] == [False, False]  # time-gated: inside 60 s of the last beat


def test_percentiles_ms_match_jax():
    jax_reg, port_reg = _both("registry")
    values = [0.001 * ((i * 37) % 101 + 1) for i in range(100)]
    assert port_reg.percentiles_ms(values) == jax_reg.percentiles_ms(values)
    assert port_reg.SCHEMA_VERSION == jax_reg.SCHEMA_VERSION
    assert (port_reg.EVENTS_FILENAME, port_reg.HEARTBEAT_FILENAME) == \
        (jax_reg.EVENTS_FILENAME, jax_reg.HEARTBEAT_FILENAME)


def _normalize_spans(spans: list[dict]) -> list[dict]:
    """Spans without timestamps, durations, pids and thread ids; span ids
    as the index of the span that carries them."""
    index = {s["span"]: i for i, s in enumerate(spans)}
    out = []
    for s in spans:
        r = {k: v for k, v in s.items()
             if k not in ("t", "dur", "run", "trace", "span", "parent", "pid", "tid")}
        r["parent"] = index.get(s.get("parent"), s.get("parent") and "outside")
        out.append(r)
    return out


def _drive_tracer(mod, d, mode):
    t = mod.Tracer(str(d), mode, proc="driver", capture_steps=2, capture_budget=1,
                   trigger_poll_secs=0.0)
    events = []
    with t.span("outer", cat="test", k=1) as outer:
        with t.span("inner", detail=True):
            pass
        t.instant("mark", cat="capture", why="x")
        ctx = outer.context()
    with t.span("worker", parent=ctx, detail=True, lo=0, hi=8):
        pass
    t.record_step(1, {"step_s": 0.3, "data_s": 0.01, "host_s": 0.2, "telemetry_s": 0.001,
                      "device_s": 0.25})
    (d / mod.TRIGGER_FILENAME).write_text("")
    for step in range(2, 7):
        events.append(t.tick(step))
        with t.span("during", detail=True, step=step):
            pass
    t.request_capture("manual")
    events.append(t.tick(7))
    events.append(t.capture_state())
    t.close()
    return events, _normalize_spans(_lines(d / mod.SPANS_FILENAME))


@pytest.mark.parametrize("mode", ["off", "steps", "full"])
def test_tracer_writes_the_jax_spans_and_capture_events(tmp_path, mode):
    """Spans (nesting, explicit parents, detail filtering, the step's phase
    children, instants) and the capture window's transitions from the
    trigger file, with its budget: the same records from both tracers."""
    jax_trace, port_trace = _both("trace")
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    got = _drive_tracer(port_trace, tmp_path / "port", mode)
    want = _drive_tracer(jax_trace, tmp_path / "jax", mode)
    assert got == want
    actions = [e["action"] for e in got[0] if e and "action" in e]
    assert actions == ["start", "end", "denied"]
    assert port_trace.TRACE_MODES == jax_trace.TRACE_MODES
    assert (port_trace.SPANS_FILENAME, port_trace.TRIGGER_FILENAME,
            port_trace.TRACES_DIRNAME, port_trace.ENV_RUN_ID, port_trace.ENV_TRACE_PARENT) == \
        (jax_trace.SPANS_FILENAME, jax_trace.TRIGGER_FILENAME, jax_trace.TRACES_DIRNAME,
         jax_trace.ENV_RUN_ID, jax_trace.ENV_TRACE_PARENT)


def test_tracer_sigusr1_and_null_tracer(tmp_path):
    _, port_trace = _both("trace")
    t = port_trace.Tracer(str(tmp_path), "off")
    prev = signal.getsignal(signal.SIGUSR1)
    assert t.install_signal()
    try:
        signal.raise_signal(signal.SIGUSR1)
        assert t.tick(1)["reason"] == "sigusr1"
    finally:
        t.close()
    assert signal.getsignal(signal.SIGUSR1) is prev
    null = port_trace.null_tracer()
    with null.span("x") as sp:
        assert sp.context() is None
    assert null.tick(1) is None and null.current_context() is None


@pytest.mark.parametrize("samples", [
    [0.1] * 4 + [0.2, 1.0, 0.005],
    [5.0, 3.0] + [0.02] * 4 + [1.0],
    [0.01 * (i % 7 + 1) for i in range(40)] + [0.9, 0.05],
])
def test_slow_sample_detector_fires_where_jax_does(samples):
    jax_trace, port_trace = _both("trace")
    kw = dict(k=3.0, min_samples=4, floor_s=0.01, skip=2)
    a, b = jax_trace.SlowSampleDetector(**kw), port_trace.SlowSampleDetector(**kw)
    assert [b.observe(x) for x in samples] == [a.observe(x) for x in samples]
    assert b.p95() == a.p95()


def test_pod_aggregator_folds_as_jax_does(tmp_path):
    gathered = np.asarray([[0.30, 900.0, 0.01, 2e10, 3e9, 1],
                           [0.35, 850.0, 0.04, 2.5e10, 4e9, 2]], np.float64)
    out = {}
    for tag, (reg_mod, pod_mod) in zip(("jax", "port"), zip(_both("registry"), _both("pod"))):
        path = tmp_path / f"{tag}.jsonl"
        reg = reg_mod.MetricsRegistry(str(path), flush_every=1)
        pod = pod_mod.PodAggregator(reg, 2, 0)
        pod.update(step_s=0.3, hbm_peak_bytes=12, unknown=1.0)
        vec = pod.local_vector()
        pod.record(16, gathered)
        pod_mod.PodAggregator(reg, 2, 1).record(16, gathered)  # rank 1 writes nothing
        reg.close()
        out[tag] = (vec.tolist(), [{k: v for k, v in r.items() if k != "t"}
                                   for r in _lines(path)])
    assert out["port"] == out["jax"]
    assert len(out["port"][1]) == 1 and out["port"][1][0]["hosts"] == 2


# ---------------------------------------------------------------------------
# MFU: the analytic FLOPs and the peak table
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("preset", preset_names(PretrainConfig))
def test_train_step_flops_equal_jax_for_every_preset(preset):
    from moco_tpu.telemetry import mfu as jax_mfu
    from moco_tpu_torch.telemetry import mfu

    assert mfu.train_step_flops(get_preset(preset)) == \
        jax_mfu.train_step_flops(jax_get_preset(preset))


@pytest.mark.parametrize("arch", ["resnet18", "resnet34", "resnet50", "resnet101", "resnet152",
                                  "resnet_tiny", "vit_small", "vit_base", "vit_large",
                                  "vit_huge", "vit_tiny"])
def test_model_fwd_flops_equal_jax(arch):
    from moco_tpu.telemetry import mfu as jax_mfu
    from moco_tpu_torch.telemetry import mfu

    for size, stem, dim, mlp in ((224, False, 128, True), (32, True, 256, False)):
        assert mfu.model_fwd_flops(arch, size, cifar_stem=stem, embed_dim=dim,
                                   mlp_head=mlp) == \
            jax_mfu.model_fwd_flops(arch, size, cifar_stem=stem, embed_dim=dim, mlp_head=mlp)


def test_detect_peak_flops_names_the_h100_and_the_jax_devices():
    from moco_tpu.telemetry import mfu as jax_mfu
    from moco_tpu_torch.telemetry import mfu

    assert mfu.detect_peak_flops("NVIDIA H100 80GB HBM3") == 989.4e12
    assert mfu.detect_peak_flops("NVIDIA H100 PCIe") == 756e12
    assert mfu.detect_peak_flops("cpu") is None
    assert mfu.detect_peak_flops("NVIDIA A100-SXM4-80GB") is None  # no other card
    assert mfu.detect_peak_flops("") is None
    for kind, _ in jax_mfu.PEAK_FLOPS_BF16:
        assert mfu.detect_peak_flops(f"TPU {kind}") == jax_mfu.detect_peak_flops(f"TPU {kind}")
    est = mfu.MFUEstimator.for_config(get_preset("imagenet-moco-v2"), 1, "NVIDIA H100 80GB HBM3")
    assert est.peak_flops_per_chip == 989.4e12
    assert est.mfu(0.261) == pytest.approx(8.38e12 / 0.261 / 989.4e12, rel=1e-3)
    # never a made-up denominator; the config's override wins
    assert mfu.MFUEstimator.for_config(get_preset("imagenet-moco-v2"), 1, "cpu").mfu(1.0) is None
    cfg = get_preset("imagenet-moco-v2").replace(peak_flops_per_chip=2e12)
    assert mfu.MFUEstimator.for_config(cfg, 4, "NVIDIA H100 80GB HBM3").peak_flops_per_chip \
        == 2e12


def test_mfu_estimator_arithmetic_matches_jax():
    from moco_tpu.telemetry import mfu as jax_mfu
    from moco_tpu_torch.telemetry import mfu

    for args in ((4e12, 8, 1e12), (1e9, 1, None), (3e13, 1, 989.4e12)):
        for step_s in (1.0, 0.0, 0.37):
            assert mfu.MFUEstimator(*args).mfu(step_s) == jax_mfu.MFUEstimator(*args).mfu(step_s)


# ---------------------------------------------------------------------------
# the phase timer (the JAX suite's cases)
# ---------------------------------------------------------------------------


def test_phase_timer_monotonic_and_stride_fencing():
    from moco_tpu_torch.telemetry.timing import StepPhaseTimer

    timer = StepPhaseTimer(stride=3)
    sync = torch.ones(())
    records = []
    timer.epoch_start()
    for step in range(1, 10):
        timer.mark_data()
        timer.mark_dispatch()
        fenced = timer.maybe_fence(step, sync)
        records.append((step, fenced, timer.finish_step()))
    assert [s for s, fenced, _ in records if fenced is not None] == [3, 6, 9]
    assert timer.fences == 3
    for _, fenced, p in records:
        assert p["data_s"] >= 0.0 and p["host_s"] >= 0.0 and p["step_s"] > 0.0
        assert p["data_s"] + p["host_s"] <= p["step_s"] + 1e-9
        assert ("device_s" in p) == (fenced is not None)
        assert "comm_s" not in p
        if fenced is not None:
            assert p["device_s"] == fenced >= 0.0


def test_phase_timer_stride_zero_never_fences():
    from moco_tpu_torch.telemetry.timing import StepPhaseTimer

    timer = StepPhaseTimer(stride=0)
    timer.epoch_start()
    timer.mark_data()
    timer.mark_dispatch()
    assert timer.maybe_fence(1, object()) is None  # never touched
    assert timer.fences == 0
    assert "device_s" not in timer.finish_step()


def test_phase_timer_comm_only_on_fenced_steps():
    from moco_tpu_torch.telemetry.timing import StepPhaseTimer, comm_seconds

    timer = StepPhaseTimer(stride=2)
    timer.epoch_start()
    seen = []
    for step in (1, 2, 3, 4):
        timer.mark_data()
        timer.mark_dispatch()
        timer.maybe_fence(step, torch.tensor(1.0), comm_pre=10.0, comm_post=10.25)
        seen.append(timer.finish_step().get("comm_s"))
    assert seen == [None, 0.25, None, 0.25]
    assert comm_seconds(5.0, 4.0) == 0.0  # clamped


def test_timer_books_telemetry_subphase_out_of_data():
    from moco_tpu_torch.telemetry.timing import StepPhaseTimer

    timer = StepPhaseTimer(stride=0)
    timer.epoch_start()
    time.sleep(0.03)
    timer.note_telemetry(0.01)
    timer.mark_data()
    timer.mark_dispatch()
    phases = timer.finish_step()
    assert phases["telemetry_s"] == pytest.approx(0.01)
    assert phases["data_s"] >= 0.015
    assert phases["data_s"] + phases["telemetry_s"] <= phases["step_s"] + 1e-6
    timer.mark_data()
    timer.mark_dispatch()
    assert "telemetry_s" not in timer.finish_step()
    timer.epoch_start()
    timer.note_telemetry(10.0)  # clamped to the real window
    timer.mark_data()
    timer.mark_dispatch()
    phases = timer.finish_step()
    assert phases["data_s"] == 0.0 and phases["telemetry_s"] <= phases["step_s"]


# ---------------------------------------------------------------------------
# meters, event sinks, the scalar writer, the device monitor
# ---------------------------------------------------------------------------


def test_throughput_rolling_window_sheds_the_stall(monkeypatch):
    from moco_tpu_torch.utils import meters

    clock = {"t": 100.0}
    monkeypatch.setattr(meters.time, "perf_counter", lambda: clock["t"])
    tp = meters.Throughput(num_chips=1, window=4)
    clock["t"] += 10.0
    tp.update(32)
    for _ in range(8):
        clock["t"] += 0.1
        tp.update(32)
    assert tp.imgs_per_sec == pytest.approx(9 * 32 / 10.8)
    assert tp.rolling_imgs_per_sec == pytest.approx(32 / 0.1)
    tp0 = meters.Throughput(num_chips=2, window=0)
    clock["t"] += 1.0
    tp0.update(10)
    assert tp0.rolling_imgs_per_sec == tp0.imgs_per_sec == 2 * tp0.imgs_per_sec_per_chip
    rate = meters.RateMeter("DecFail")
    rate.update(3, 200)
    assert str(rate) == "DecFail 3 (1.50%)" and meters.RateMeter("x").rate == 0.0


def test_log_event_sinks_as_in_jax(capsys):
    from moco_tpu_torch.utils import logging as mlog

    seen = []

    def sink(kind, msg, fields):
        seen.append((kind, msg, fields))

    def bad(kind, msg, fields):
        raise RuntimeError("sink broke")

    mlog.add_event_sink(sink)
    mlog.add_event_sink(bad)
    try:
        mlog.log_event("rollback", "restoring", step=12, rollback=1)
    finally:
        mlog.remove_event_sink(sink)
        mlog.remove_event_sink(bad)
    out = capsys.readouterr().out
    assert seen == [("rollback", "restoring", {"step": 12, "rollback": 1})]
    assert "[rollback] restoring" in out and "event sink failed" in out
    mlog.log_event("after", "removed")
    assert len(seen) == 1


def test_scalar_writer_counts_drops_and_is_a_noop_without_tensorboardx(capsys):
    from moco_tpu_torch.utils import logging as mlog

    class FakeWriter:
        def __init__(self):
            self.scalars = []

        def add_scalar(self, name, value, step):
            self.scalars.append((name, value, step))

    w = mlog.ScalarWriter("")
    w._writer = FakeWriter()
    w.write(3, {"loss": 1.5, "bad": "text", "worse": object()})
    assert w.dropped == 2 and w._writer.scalars == [("loss", 1.5, 3)]
    assert capsys.readouterr().out.count("[scalar_writer]") == 1
    noop = mlog.ScalarWriter("")
    noop.write(1, {"loss": 1.0})
    noop.flush()
    noop.close()
    assert mlog._is_main_process()  # no process group: rank 0


def test_device_monitor_on_the_cpu_reports_host_memory_only():
    from moco_tpu_torch.telemetry.device import DeviceMonitor

    sample = DeviceMonitor("cpu").sample()
    assert set(sample) == {"host_rss_bytes"} and sample["host_rss_bytes"] > 0


def test_profiler_window_writes_a_chrome_trace(tmp_path):
    from moco_tpu_torch.utils.logging import ProfilerWindow

    window = ProfilerWindow(str(tmp_path), 2, 4)
    for step in range(6):
        window.maybe_toggle(step)
        torch.ones(8, 8) @ torch.ones(8, 8)
    window.close()
    (trace,) = tmp_path.glob("trace_*.json")
    assert "traceEvents" in json.loads(trace.read_text())
    ProfilerWindow("", 0, 1).maybe_toggle(0)  # inactive without a directory


# ---------------------------------------------------------------------------
# a tiny pretrain through the driver: the JAX driver's records
# ---------------------------------------------------------------------------

# tests/test_telemetry.py's `telemetry_run`, with span recording on
TELEMETRY_RUN = dict(
    arch="resnet_tiny", dataset="synthetic", image_size=16, batch_size=16,
    num_negatives=64, embed_dim=32, lr=0.1, epochs=2, steps_per_epoch=15,
    ckpt_dir="", tb_dir="", print_freq=5, num_classes=10, knn_monitor=False,
    telemetry_flush_steps=8, telemetry_stride=5, peak_flops_per_chip=1e12,
    staging_workers=2, input_cache_mb=64, trace_mode="steps")


def _keysets(records: list[dict]) -> dict[str, set]:
    """Keys per record kind (an event per its `event` name), and of the
    step records' `input` snapshots."""
    out: dict[str, set] = {}
    for r in records:
        kind = r["kind"] if r["kind"] != "event" else f"event:{r['event']}"
        out.setdefault(kind, set()).update(r)
        if "input" in r:
            out.setdefault(f"{kind}.input", set()).update(r["input"])
    return out


def _port_run(tmp_path, name, **overrides):
    from moco_tpu_torch import train

    config = get_preset("cifar10-moco-v1").replace(**{**TELEMETRY_RUN, **overrides})
    if config.telemetry_dir:
        config = config.replace(telemetry_dir=str(tmp_path / name))
    state, history = train.train(config, device="cpu", on_step=lambda *a: None)
    return config, state, history


@pytest.fixture(scope="module")
def runs(tmp_path_factory, mesh8):
    """The JAX driver's run of the configuration, and the port's with
    telemetry on, with telemetry and health on, and with both off."""
    tmp = tmp_path_factory.mktemp("telemetry")
    from moco_tpu.train import train as jax_train

    jax_cfg = jax_get_preset("cifar10-moco-v1").replace(
        **TELEMETRY_RUN, telemetry_dir=str(tmp / "jax"))
    jax_train(jax_cfg, mesh8)
    # the three port runs on two intra-op threads: each is compared only with
    # the others (bit for bit) and by its records' keys, and on a host whose
    # cores the other test processes share, more threads only spin
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    try:
        return dict(jax=jax_cfg,
                    on=_port_run(tmp, "on", telemetry_dir="x"),
                    health=_port_run(tmp, "health", telemetry_dir="x", health_stride=2),
                    off=_port_run(tmp, "off", telemetry_dir=""))
    finally:
        torch.set_num_threads(threads)


def _events(config) -> list[dict]:
    return _lines(os.path.join(config.telemetry_dir, "events.jsonl"))


def test_port_run_writes_the_jax_record_kinds_and_keys(runs):
    """The same kinds (events by name) with the same key sets, but comm_s:
    the JAX step always carries its sync's probe scalars, the port has no
    sync and no comm_s without a process group."""
    want = _keysets(_events(runs["jax"]))
    got = _keysets(_events(runs["on"][0]))
    want["step"].discard("comm_s")
    assert got == want


def test_port_run_records(runs):
    config, state, _ = runs["on"]
    records = _events(config)
    assert state.step == 30
    assert all(r["v"] == 1 for r in records)
    (start,) = [r for r in records if r["kind"] == "run_start"]
    assert start["device_kind"] == "cpu" and start["peak_flops_per_chip"] == 1e12
    from moco_tpu_torch.telemetry.mfu import train_step_flops

    assert start["flops_per_step"] == train_step_flops(config)
    steps = [r for r in records if r["kind"] == "step"]
    assert [r["step"] for r in steps] == list(range(1, 31))
    assert [r["step"] for r in steps if "device_s" in r] == [5, 10, 15, 20, 25, 30]
    for r in steps:
        assert r["step_s"] > 0 and r["data_s"] >= 0 and r["host_s"] >= 0
        assert 0 < r["mfu"] < 1 and "comm_s" not in r and "health" not in r
        assert ("host_rss_bytes" in r) == (r["step"] % 5 == 0)
        assert not any(k.startswith("hbm_") for k in r)  # the CPU cannot report
    assert [r["step"] for r in steps if "loss" in r] == [1, 6, 11, 16, 21, 26]
    (end,) = [r for r in records if r["kind"] == "run_end"]
    assert end["steps"] == 30 and end["last_step"] == 30 and end["scalar_drops"] == 0
    with open(os.path.join(config.telemetry_dir, "heartbeat.json")) as f:
        beat = json.load(f)
    assert beat["phase"] == "run_end" and beat["step"] == 30 and beat["pid"] == os.getpid()


def test_health_block_on_stride_steps(runs):
    config, _, _ = runs["health"]
    steps = [r for r in _events(config) if r["kind"] == "step"]
    blocks = {r["step"]: r["health"] for r in steps if "health" in r}
    # the diagnostics of the step that took state.step 0, 2, 4, ...
    assert sorted(blocks) == list(range(1, 31, 2))
    for block in blocks.values():
        assert set(block) == {"emb_std_q", "emb_pr_q", "emb_std_k", "gnorm", "gnorm_first",
                              "gnorm_last", "qnorm_mean", "qnorm_min", "qage_steps",
                              "pdrift", "logit_margin", "neg_sim", "pos_sim", "acc1"}
        assert all(np.isfinite(v) for v in block.values())
    assert blocks[1]["qage_steps"] == 0 and blocks[29]["qage_steps"] == 4  # K/B = 4


def test_telemetry_and_health_leave_the_trajectory_bit_for_bit(runs):
    _, off, off_hist = runs["off"]
    for name in ("on", "health"):
        _, state, hist = runs[name]
        assert [h["loss"] for h in hist] == [h["loss"] for h in off_hist]
        for a, b in ((state.model_q, off.model_q), (state.model_k, off.model_k)):
            for (n, x), (_, y) in zip(a.state_dict().items(), b.state_dict().items()):
                assert torch.equal(x, y), (name, n)
        assert torch.equal(state.queue, off.queue) and state.queue_ptr == off.queue_ptr
        for sa, sb in zip(state.optimizer.state.values(), off.optimizer.state.values()):
            assert torch.equal(sa["momentum_buffer"], sb["momentum_buffer"])


def test_telemetry_report_renders_a_port_run(runs):
    path = os.path.join(runs["health"][0].telemetry_dir, "events.jsonl")
    proc = subprocess.run([sys.executable, REPORT, path], capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "MFU: mean" in proc.stdout and "health:" in proc.stdout
    summary = json.loads(subprocess.run([sys.executable, REPORT, path, "--json"],
                                        capture_output=True, text=True, timeout=120).stdout)
    assert summary["steps"] == 30 and summary["mfu"]["mean"] > 0
    assert summary["step_time_ms"]["p95"] >= summary["step_time_ms"]["p50"] > 0
    assert summary["input"]["staged_batches"] > 0


def test_trace_report_merges_the_port_spans(runs, tmp_path):
    config = runs["on"][0]
    spans = _lines(os.path.join(config.telemetry_dir, "spans.jsonl"))
    names = {s["name"] for s in spans}
    assert {"step", "stage_batch"} <= names
    assert "decode_slice" not in names  # a detail span: trace_mode="full" only
    out = tmp_path / "trace.json"
    proc = subprocess.run([sys.executable, TRACE_REPORT, config.telemetry_dir, "-o", str(out)],
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    chrome = json.loads(out.read_text())
    events = chrome["traceEvents"] if isinstance(chrome, dict) else chrome
    assert {"step", "stage_batch"} <= {e.get("name") for e in events}


def test_full_trace_mode_records_the_staging_detail_spans(tmp_path):
    config, _, _ = _port_run(tmp_path, "full", telemetry_dir="x", trace_mode="full",
                             epochs=1, steps_per_epoch=3, input_cache_mb=0)
    spans = _lines(os.path.join(config.telemetry_dir, "spans.jsonl"))
    by_id = {s["span"]: s for s in spans}
    decode = [s for s in spans if s["name"] == "decode_slice"]
    h2d = [s for s in spans if s["name"] == "h2d_shard"]
    assert decode and h2d and all(s["cat"] == "input" for s in decode + h2d)
    assert {by_id[s["parent"]]["name"] for s in decode + h2d} == {"stage_batch"}
    assert {"data", "host"} <= {s["name"] for s in spans if s["cat"] == "phase"}


def test_trigger_file_with_a_device_profile_writes_a_trace(tmp_path):
    """A capture window armed by `trace.trigger` with `trace_device_profile`:
    a `trace_capture` event and a torch.profiler trace under traces/."""
    tel = tmp_path / "cap"
    tel.mkdir()
    (tel / "trace.trigger").write_text("")
    config, _, _ = _port_run(tmp_path, "cap", telemetry_dir="x", trace_device_profile=True,
                             trace_capture_steps=2, epochs=1, steps_per_epoch=4,
                             input_cache_mb=0)
    actions = [r["action"] for r in _events(config) if r.get("event") == "trace_capture"]
    assert actions == ["start", "end"]
    traces = list((tel / "traces").rglob("trace_*.json"))
    assert len(traces) == 1 and "traceEvents" in json.loads(traces[0].read_text())


# ---------------------------------------------------------------------------
# two gloo ranks
# ---------------------------------------------------------------------------


def test_two_ranks_write_once_and_fold_a_pod_record(tmp_path):
    tel = tmp_path / "tel"
    config = dict(variant="v2", arch="resnet_tiny", image_size=16, batch_size=8,
                  num_negatives=32, embed_dim=16, mlp_head=True, epochs=1, lr=0.1,
                  compute_dtype="float32", print_freq=1, staging_workers=1,
                  telemetry_dir=str(tel), telemetry_stride=2, telemetry_flush_steps=1,
                  resilience_sync_steps=2, health_stride=2, trace_mode="steps")
    spawn("run_train", 2, (config, str(tmp_path), "tel", 4, 32), timeout=180)
    assert sorted(p.name for p in tel.iterdir()) == ["events.jsonl", "heartbeat.json",
                                                    "spans.jsonl"]
    records = _lines(tel / "events.jsonl")
    (start,) = [r for r in records if r["kind"] == "run_start"]
    assert start["n_procs"] == 2 and start["n_chips"] == 2
    steps = [r for r in records if r["kind"] == "step"]
    assert [r["step"] for r in steps] == [1, 2, 3, 4]  # rank 0's only
    assert [r["step"] for r in steps if "comm_s" in r] == [2, 4]
    assert all(r["comm_s"] >= 0 for r in steps if "comm_s" in r)
    assert [r["step"] for r in steps if "health" in r] == [1, 3]
    pods = [r for r in records if r["kind"] == "pod"]
    assert [p["step"] for p in pods] == [2, 4]
    for p in pods:
        assert p["hosts"] == 2 and p["step_s_max"] >= p["step_s_min"] > 0
        assert p["imgs_per_sec_sum"] > 0
    # memory joins the vector at the sampling stride, after that step's
    # gather (the JAX driver's order): the second pod record carries it
    assert pods[0]["host_rss_bytes_max"] == 0 < pods[1]["host_rss_bytes_max"]
    assert len([r for r in records if r["kind"] == "run_end"]) == 1
    assert len({s["pid"] for s in _lines(tel / "spans.jsonl")}) == 1  # rank 0's tracer
