"""obsd of the port (`moco_tpu_torch/telemetry/aggregate.py`, `python -m
moco_tpu_torch.obsd`) against the JAX package's
(`moco_tpu/telemetry/aggregate.py`, `tools/obsd.py`) on the CPU.

Both modules are the standard library alone. Every unit scenario runs once
for each package (`pkg`) on the same inputs and asserts what
`tests/test_obsd.py` asserts: the percentile window, the stream tailer,
stream discovery, the run window's objectives (router deltas, events,
banks, health), every SLO rule file of `tools/slo_rules/` and the default
set, the burn-rate engine under a pinned `now`, the aggregator (its slo
lines, the endpoint-only mode, a restart over history, late replica dirs,
retirement) and the HTTP endpoints.

`test_aggregators_equal_on_recorded_streams` holds the two `Aggregator`s
equal on the same recorded streams: a tiny port CPU pretrain's
`events.jsonl` and a telemetry directory of a port fleet of two real
`--device cpu` replicas, recorded once for this file. With both modules'
clocks pinned, the `/metrics` text and the `/slo` and `/runs` JSON are
equal whole, and so are the slo lines each wrote back. No JAX driver runs
here.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
import random
import re
import shutil
import subprocess
import sys
import time
import urllib.error
import urllib.request

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGES = ["moco_tpu", "moco_tpu_torch"]
RULE_FILES = sorted(os.listdir(os.path.join(REPO, "tools", "slo_rules")))


@pytest.fixture(params=PACKAGES)
def agg(request):
    """The package's aggregate module."""
    return importlib.import_module(f"{request.param}.telemetry.aggregate")


def _mod(name):
    return importlib.import_module(f"{name}.telemetry.aggregate")


def _step(step, step_s, data_s=0.0, mfu=None, run="r1"):
    rec = {"v": 1, "t": 1000.0 + step, "kind": "step", "run_id": run, "step": step,
           "step_s": step_s, "data_s": data_s}
    if mfu is not None:
        rec["mfu"] = mfu
    return rec


# ---------------------------------------------------------------------------
# the percentile window, the tailer, stream discovery
# ---------------------------------------------------------------------------


def test_percentile_window_nearest_rank_and_ring(agg):
    w = agg.PercentileWindow(size=4)
    assert w.percentile(95) == 0.0  # empty: 0, never raises
    for v in (0.010, 0.020, 0.030, 0.040):
        w.observe(v)
    assert w.percentile(50) == pytest.approx(0.030)
    assert w.percentile(99) == pytest.approx(0.040)
    w.observe(0.050)  # a 5th observation evicts the oldest
    assert w.count == 4
    assert w.percentile(0) == pytest.approx(0.020)
    pct = w.percentiles_ms()
    assert set(pct) == {"p50", "p95", "p99"}
    assert pct["p50"] <= pct["p95"] <= pct["p99"] == 50.0


def test_percentile_window_rejects_bad_size(agg):
    with pytest.raises(ValueError):
        agg.PercentileWindow(size=0)


def test_percentiles_equal_across_packages():
    rng = random.Random(7)
    values = [rng.uniform(0.0, 2.0) for _ in range(997)]
    windows = {}
    for name in PACKAGES:
        w = _mod(name).PercentileWindow(size=256)
        for v in values:
            w.observe(v)
        windows[name] = w
    for q in (0, 1, 37.5, 50, 90, 95, 99, 99.9, 100):
        assert _mod("moco_tpu_torch").percentile(values, q) == \
            _mod("moco_tpu").percentile(values, q)
        assert windows["moco_tpu_torch"].percentile(q) == windows["moco_tpu"].percentile(q)
    assert windows["moco_tpu_torch"].percentiles_ms() == windows["moco_tpu"].percentiles_ms()


def test_tailer_partial_line_and_truncation(agg, tmp_path):
    path = str(tmp_path / "events.jsonl")
    t = agg.StreamTailer(path)
    assert t.poll() == []  # a missing file: "not yet", never an error
    with open(path, "w") as f:
        f.write('{"kind": "step", "step": 1}\n{"kind": "st')
    assert [r["step"] for r in t.poll()] == [1]  # the torn tail stays buffered
    with open(path, "a") as f:
        f.write('ep", "step": 2}\n')
    assert [r["step"] for r in t.poll()] == [2]
    with open(path, "w") as f:  # truncation resets and re-reads from the top
        f.write('{"kind": "step", "step": 9}\nnot json at all\n[1, 2]\n')
    assert [r["step"] for r in t.poll()] == [9]
    assert t.skipped == 2 and t.records_read == 3
    # content that exists when the tailer is made is catch-up history
    t2 = agg.StreamTailer(path)
    assert t2.preexisting > 0 and [r["step"] for r in t2.poll()] == [9]
    assert t2.polled_catchup is True
    t3 = agg.StreamTailer(path, from_start=False)
    assert t3.poll() == []


def test_discover_streams_fleet_and_staging_layouts(agg, tmp_path):
    fleet = tmp_path / "fleet"
    for d in ("replica0", "replica1", "staging_server0", "not_a_replica", "replica2"):
        (fleet / d).mkdir(parents=True)
    for f in ("events.jsonl", "replica0/events.jsonl", "replica1/events.jsonl",
              "staging_server0/events.jsonl", "not_a_replica/events.jsonl"):
        (fleet / f).write_text("")
    lone = tmp_path / "train.jsonl"
    lone.write_text("")
    streams = agg.discover_streams([str(fleet), str(lone), str(tmp_path / "later.jsonl")])
    labels = sorted(os.path.basename(k.rstrip("/")) for k in streams)
    assert labels == ["fleet", "later.jsonl", "replica0", "replica1", "staging_server0",
                      "train.jsonl"]
    assert agg.TELEMETRY_SUBDIR_PREFIXES == ("replica", "staging_server")


# ---------------------------------------------------------------------------
# the run window's objectives
# ---------------------------------------------------------------------------


def test_run_window_step_metrics_and_min_step(agg):
    w = agg.RunWindow("r1")
    w.ingest(_step(1, 5.0), "src", "p", now=100.0)  # the compile step
    for i in range(2, 12):
        w.ingest(_step(i, 0.1, data_s=0.05, mfu=0.2), "src", "p", now=100.0 + i)
    assert w.metric("step_time_ms_max", 1000.0, 120.0) == 5000.0
    assert w.metric("step_time_ms_max", 1000.0, 120.0, 3) == pytest.approx(100.0)
    assert w.metric("step_time_ms_p50", 1000.0, 120.0, 3) == pytest.approx(100.0)
    assert w.metric("data_share", 1000.0, 120.0, 3) == pytest.approx(0.5)
    assert w.metric("mfu_mean", 1000.0, 120.0, 3) == pytest.approx(0.2)
    assert w.metric("step_time_ms_max", 3.0, 112.0) == pytest.approx(100.0)
    assert w.metric("step_time_ms_p95", 1.0, 500.0) is None  # silence is not healthy
    with pytest.raises(ValueError):
        w.metric("no_such_objective", 10.0, 0.0)


def test_run_window_shed_rate_from_router_deltas(agg):
    w = agg.RunWindow("r1")

    def router(now, requests, sheds, fanout=0, partial=0):
        w.ingest({"kind": "fleet", "event": "router_stats", "requests": requests,
                  "shed_no_backend": sheds, "outstanding": 3, "knn_fanout": fanout,
                  "knn_partial": partial,
                  "latency_ms": {"p50": 1.0, "p95": 2.0, "p99": 3.0}}, "fleet", "p", now)

    assert w.metric("shed_rate", 60.0, 100.0) is None  # fewer than 2 snapshots
    router(100.0, 100, 0)
    assert w.metric("shed_rate", 60.0, 100.0) is None
    router(110.0, 300, 10, fanout=40, partial=4)
    assert w.metric("shed_rate", 60.0, 115.0) == pytest.approx(0.05)
    assert w.metric("knn_partial_rate", 60.0, 115.0) == pytest.approx(0.1)
    assert w.metric("outstanding", 60.0, 115.0) == 3.0
    assert w.metric("router_latency_ms_p95", 60.0, 115.0) == 2.0
    assert w.metric("shed_rate", 4.0, 115.0) is None


def test_run_window_event_counts_and_slo_feedback_guard(agg):
    w = agg.RunWindow("r1")
    w.ingest({"kind": "event", "event": "rollback"}, "s", "p", 10.0)
    w.ingest({"kind": "event", "event": "sentinel"}, "s", "p", 11.0)
    w.ingest({"kind": "fleet", "event": "reload_quarantine"}, "s", "p", 12.0)
    w.ingest({"kind": "supervisor", "event": "resize_relaunch"}, "s", "p", 13.0)
    w.ingest({"kind": "fleet", "event": "autoscale_up"}, "s", "p", 13.5)
    w.ingest({"kind": "input_server", "event": "stats"}, "s", "p", 13.6)
    w.ingest({"kind": "input_server", "event": "worker_exit"}, "s", "p", 13.7)
    assert w.metric("rollback_events", 60.0, 20.0) == 2.0
    assert w.metric("reload_failures", 60.0, 20.0) == 1.0
    assert w.metric("resize_relaunches", 60.0, 20.0) == 1.0
    assert w.metric("event:resize_relaunch", 60.0, 20.0) == 1.0
    assert w.metric("autoscale_events", 60.0, 20.0) == 1.0
    assert w.incidents.get("worker_exit") == 1 and "stats" not in w.incidents
    assert w.metric("rollback_events", 5.0, 1000.0) == 0.0
    w.ingest({"kind": "slo", "action": "alert", "rule": "x"}, "s", "p", 14.0)
    assert w.slo_events == 1 and "slo" not in w.kinds


def test_run_window_serve_input_and_health_objectives(agg):
    w = agg.RunWindow("r1")
    w.ingest({"kind": "serve", "requests": 10, "shed_overload": 0, "shed_deadline": 0,
              "latency_ms": {"p95": 4.0}, "ann": {"recall_probe": 0.9}}, "s", "p", 10.0)
    w.ingest({"kind": "serve", "requests": 110, "shed_overload": 5, "shed_deadline": 5,
              "latency_ms": {"p95": 6.0}, "ann": {"recall_probe": 0.95}}, "s", "p", 11.0)
    assert w.metric("serve_shed_rate", 60.0, 12.0) == pytest.approx(0.1)
    assert w.metric("serve_latency_ms_p95", 60.0, 12.0) == 6.0
    assert w.metric("ann_recall_probe", 60.0, 12.0) == 0.95
    for i, (stall, wall, margin) in enumerate(((0.0, 1.0, 0.5), (2.0, 5.0, 0.1))):
        rec = _step(10 + i, 0.1)
        rec["input"] = {"credit_stall_s": stall, "wall_s": wall}
        rec["health"] = {"logit_margin": margin, "emb_std_q": 0.01}
        w.ingest(rec, "s", "p", 12.0 + i)
    assert w.metric("input_credit_stall_rate", 60.0, 14.0) == pytest.approx(0.5)
    assert w.metric("health:logit_margin", 60.0, 14.0) == pytest.approx(0.3)
    assert w.metric("health_min:logit_margin", 60.0, 14.0) == pytest.approx(0.1)
    assert w.metric("health_max:logit_margin", 60.0, 14.0) == pytest.approx(0.5)
    assert w.metric("health:absent_key", 60.0, 14.0) is None
    assert w.snapshot(14.0)["health"] == {"logit_margin": 0.1, "emb_std_q": 0.01}


def _bank_rec(event, **fields):
    return dict({"v": 1, "kind": "bank", "event": event}, **fields)


def test_run_window_bank_events_and_age(agg):
    w = agg.RunWindow("r1")
    w.ingest(_bank_rec("build_start", step=7), "s", "p", 10.0)
    w.ingest(_bank_rec("shard_done", step=7, shard=0), "s", "p", 10.5)
    w.ingest(_bank_rec("swap", step=7, bank_step=5, rows=8, generation=1, agreement=0.995),
             "s", "p", 11.0)
    assert w.incidents.get("bank_build_start") == 1 and w.incidents.get("bank_swap") == 1
    assert "bank_shard_done" not in w.incidents
    assert w.metric("event:bank_swap", 60.0, 12.0) == 1.0
    assert w.metric("bank_age_steps", 60.0, 12.0) == 2.0
    w.ingest(_bank_rec("bank_waiting", step=9, age_steps=4), "s", "p", 12.0)
    assert w.metric("bank_age_steps", 60.0, 13.0) == 4.0
    w.ingest(_bank_rec("quarantine", step=9), "s", "p", 13.0)
    w.ingest(_bank_rec("rollback", replica=0, from_step=9, to_step=5), "s", "p", 14.0)
    assert w.metric("event:bank_quarantine", 60.0, 15.0) == 1.0
    assert w.metric("event:bank_rollback", 60.0, 15.0) == 1.0
    assert w.metric("reload_failures", 60.0, 15.0) == 1.0
    snap = w.snapshot(15.0)
    assert snap["bank"]["event"] == "bank_waiting" and snap["bank"]["age_steps"] == 4
    assert agg.RunWindow("r2").metric("bank_age_steps", 60.0, 15.0) is None


def _mixed_records(n=400, seed=11):
    """A seeded mix of every record kind the run window folds."""
    rng = random.Random(seed)
    out, req, shed = [], 0, 0
    for i in range(n):
        kind = rng.choice(["step", "step", "event", "fleet", "router", "serve", "bank",
                           "input_server", "supervisor", "slo", "run_start"])
        run = rng.choice(["ra", "rb"])
        if kind == "step":
            rec = _step(i, rng.uniform(0.01, 3.0), rng.uniform(0, 0.5),
                        rng.choice([None, rng.uniform(0, 0.6)]), run=run)
            if rng.random() < 0.3:
                rec["health"] = {"logit_margin": rng.uniform(0, 1), "qnorm_min": rng.random()}
            if rng.random() < 0.3:
                rec["input"] = {"credit_stall_s": i * 0.1, "wall_s": i * 0.5}
        elif kind == "router":
            req += rng.randint(0, 50)
            shed += rng.randint(0, 3)
            rec = {"kind": "fleet", "event": "router_stats", "run_id": run, "requests": req,
                   "shed_no_backend": shed, "outstanding": rng.randint(0, 9),
                   "knn_fanout": req // 2, "knn_partial": shed // 2,
                   "latency_ms": {"p50": 1.0, "p95": rng.uniform(1, 9), "p99": 10.0}}
        elif kind == "serve":
            rec = {"kind": "serve", "run_id": run, "requests": req, "shed_overload": shed,
                   "latency_ms": {"p50": 2.0, "p95": rng.uniform(2, 20)}}
        elif kind == "bank":
            rec = _bank_rec(rng.choice(["swap", "bank_waiting", "quarantine", "shard_done"]),
                            run_id=run, step=i, bank_step=i - 3, age_steps=rng.randint(0, 9))
        elif kind == "slo":
            rec = {"kind": "slo", "run_id": run, "action": "alert", "rule": "x"}
        elif kind == "run_start":
            rec = {"kind": "run_start", "run_id": run, "name": "n", "arch": "a"}
        else:
            rec = {"kind": "event" if kind == "event" else kind, "run_id": run,
                   "event": rng.choice(["rollback", "reload_failed", "resize_relaunch",
                                        "autoscale_down", "stats", "health", "launch"])}
        out.append((rec, 100.0 + i * 0.25))
    return out


def test_run_windows_equal_across_packages_on_a_mixed_stream():
    """Every objective over the same seeded stream, at several times and
    windows: the same values (None included) and the same snapshots."""
    recs = _mixed_records()
    objectives = ["step_time_ms_p50", "step_time_ms_p95", "step_time_ms_p99",
                  "step_time_ms_max", "data_share", "mfu_mean", "shed_rate",
                  "serve_shed_rate", "outstanding", "router_latency_ms_p95",
                  "serve_latency_ms_p95", "input_credit_stall_rate", "reload_failures",
                  "rollback_events", "bank_age_steps", "resize_relaunches",
                  "ann_recall_probe", "knn_partial_rate", "autoscale_events", "stale_s",
                  "event:launch", "collapse_events", "health:logit_margin",
                  "health_min:qnorm_min", "health_max:logit_margin"]
    out = {}
    for name in PACKAGES:
        windows = {r: _mod(name).RunWindow(r, ring=64) for r in ("ra", "rb")}
        vals = []
        for i, (rec, now) in enumerate(recs):
            windows[rec["run_id"]].ingest(rec, "src", "p", now, historical=i < 40)
            if i % 50 == 49:
                for w in windows.values():
                    for obj in objectives:
                        for win in (5.0, 30.0, 600.0):
                            vals.append(w.metric(obj, win, now, min_step=3))
                    vals.append(w.snapshot(now))
        out[name] = vals
    assert out["moco_tpu_torch"] == out["moco_tpu"]


# ---------------------------------------------------------------------------
# SLO rules and the burn-rate engine
# ---------------------------------------------------------------------------


def test_slo_rule_validation(agg):
    with pytest.raises(ValueError):
        agg.SLORule({"name": "x", "objective": "step_time_ms_p95"})  # no threshold
    with pytest.raises(ValueError):
        agg.SLORule({"name": "x", "objective": "o", "threshold": 1, "op": "!="})
    with pytest.raises(ValueError):
        agg.SLORule({"name": "x", "objective": "o", "threshold": 1, "fast_window_s": 60,
                     "slow_window_s": 30})
    r = agg.SLORule({"name": "x", "objective": "step_time_ms_p95", "threshold": 100})
    assert r.op == ">" and r.slow_window_s == 5 * r.fast_window_s
    assert r.min_step == 3 and r.clear_s == 2.0


def _rule_fields(rule):
    return {k: getattr(rule, k) for k in ("name", "objective", "op", "threshold",
                                          "fast_window_s", "slow_window_s",
                                          "fast_threshold", "slow_threshold", "for_s",
                                          "clear_s", "min_step", "severity")}


def test_load_rules_default_set_and_file(agg, tmp_path):
    names = {r.name for r in agg.load_rules(None)}
    assert names == {"step_time_p95", "data_stall_share", "shed_rate", "input_credit_stall",
                     "reload_failure", "nonfinite_loss", "resize_loop"}
    path = tmp_path / "rules.json"
    path.write_text(json.dumps({"rules": [
        {"name": "a", "objective": "step_time_ms_p95", "threshold": 5}]}))
    assert [r.name for r in agg.load_rules(str(path))] == ["a"]
    path.write_text(json.dumps([{"name": "a", "objective": "o", "threshold": 1},
                                {"name": "a", "objective": "o", "threshold": 2}]))
    with pytest.raises(ValueError, match="duplicate"):
        agg.load_rules(str(path))
    path.write_text("{}")
    with pytest.raises(ValueError):
        agg.load_rules(str(path))


@pytest.mark.parametrize("rule_file", [None] + RULE_FILES)
def test_rule_files_load_equal_across_packages(rule_file):
    """The default set and each shipped rule file of `tools/slo_rules/`
    load to the same rules in both packages."""
    path = None if rule_file is None else os.path.join(REPO, "tools", "slo_rules", rule_file)
    jax_rules = [_rule_fields(r) for r in _mod("moco_tpu").load_rules(path)]
    port_rules = [_rule_fields(r) for r in _mod("moco_tpu_torch").load_rules(path)]
    assert port_rules == jax_rules and port_rules
    assert _mod("moco_tpu_torch").DEFAULT_RULES == _mod("moco_tpu").DEFAULT_RULES


def test_shipped_bank_slo_rules_fire(agg):
    rules = agg.load_rules(os.path.join(REPO, "tools", "slo_rules", "bank_lifecycle.json"))
    assert [r.name for r in rules] == ["bank_age", "bank_pair_quarantine", "bank_rollback"]
    w = agg.RunWindow("r1")
    w.ingest(_bank_rec("bank_waiting", step=9000, age_steps=3000), "s", "p", 100.0)
    w.ingest(_bank_rec("quarantine", step=9000), "s", "p", 100.5)
    w.ingest(_bank_rec("rollback", replica=1, from_step=9000, to_step=5), "s", "p", 101.0)
    fired = {t["rule"] for t in agg.SLOEngine(rules).evaluate({"r1": w}, 102.0)}
    assert fired == {"bank_age", "bank_pair_quarantine", "bank_rollback"}


def _engine_with_steps(agg, step_s_by_time, rule_kw):
    w = agg.RunWindow("r1")
    for i, (now, step_s) in enumerate(step_s_by_time):
        w.ingest(_step(i + 10, step_s), "src", "p", now)
    rule = agg.SLORule({"name": "st", "objective": "step_time_ms_max", "op": ">",
                        "threshold": 1000.0, **rule_kw})
    return agg.SLOEngine([rule]), {"r1": w}


def test_default_clear_s_suppresses_tick_flap(agg):
    engine, windows = _engine_with_steps(agg, [(100.0, 2.0)],
                                         {"fast_window_s": 3, "slow_window_s": 6})
    assert [t["action"] for t in engine.evaluate(windows, 101.0)] == ["alert"]
    assert engine.evaluate(windows, 103.5) == []
    assert [t["action"] for t in engine.evaluate(windows, 106.0)] == ["recover"]


def test_burn_rate_needs_both_windows(agg):
    engine, windows = _engine_with_steps(
        agg, [(100.0 + i, 0.1) for i in range(10)] + [(111.0, 2.0)],
        {"fast_window_s": 5, "slow_window_s": 50, "slow_threshold": 5000.0})
    assert engine.evaluate(windows, 112.0) == []
    st = engine.state_for("st", "r1")
    assert not st.alerting and st.last_fast == pytest.approx(2000.0)


def test_burn_rate_alert_for_s_and_recovery_hysteresis(agg):
    engine, windows = _engine_with_steps(
        agg, [(100.0, 2.0)], {"fast_window_s": 10, "slow_window_s": 20, "for_s": 3.0,
                              "clear_s": 4.0})
    assert engine.evaluate(windows, 101.0) == []
    assert engine.evaluate(windows, 102.0) == []
    out = engine.evaluate(windows, 104.5)
    assert [t["action"] for t in out] == ["alert"]
    assert out[0]["rule"] == "st" and out[0]["run_id"] == "r1"
    assert out[0]["value_fast"] == pytest.approx(2000.0)
    assert engine.evaluate(windows, 106.0) == []
    assert engine.evaluate(windows, 111.0) == []
    assert engine.evaluate(windows, 113.0) == []
    assert [t["action"] for t in engine.evaluate(windows, 115.5)] == ["recover"]
    assert engine.evaluate(windows, 200.0) == []
    st = engine.state_for("st", "r1")
    assert st.alerts == 1 and st.recoveries == 1


def test_burn_rate_flap_within_for_s_rearms(agg):
    engine, windows = _engine_with_steps(agg, [(100.0, 2.0)],
                                         {"fast_window_s": 2, "slow_window_s": 4, "for_s": 5.0})
    assert engine.evaluate(windows, 101.0) == []
    assert engine.evaluate(windows, 107.0) == []
    assert engine.evaluate(windows, 200.0) == []
    assert engine.state_for("st", "r1").alerts == 0


def test_engine_snapshot_shape(agg):
    engine, windows = _engine_with_steps(agg, [(100.0, 2.0)],
                                         {"fast_window_s": 10, "slow_window_s": 20})
    engine.evaluate(windows, 101.0)
    (rule,) = engine.snapshot(windows)["rules"]
    assert rule["name"] == "st"
    assert rule["runs"]["r1"]["state"] == "alert" and rule["runs"]["r1"]["alerts"] == 1
    assert "since" in rule["runs"]["r1"]


class _Clock:
    """A stand-in for a module's `time`: both clocks pinned."""

    def __init__(self, mono=5000.0, wall=1.7e9):
        self.mono, self.wall = mono, wall

    def monotonic(self):
        return self.mono

    def time(self):
        return self.wall


def test_slo_engines_equal_across_packages_under_a_pinned_now(monkeypatch):
    """Every shipped rule plus the default set over the same seeded stream,
    ticked at the same pinned times: the same transitions and snapshots."""
    rules = []
    for f in [None] + RULE_FILES:
        rules += _mod("moco_tpu").load_rules(
            None if f is None else os.path.join(REPO, "tools", "slo_rules", f))
    specs = [dict(_rule_fields(r), name=f"{i}_{r.name}") for i, r in enumerate(rules)]
    specs.append({"name": "fast_st", "objective": "step_time_ms_max", "threshold": 1500.0,
                  "fast_window_s": 2.0, "slow_window_s": 8.0, "for_s": 0.5, "clear_s": 1.0})
    recs = _mixed_records(600, seed=3)
    out = {}
    for name in PACKAGES:
        mod = _mod(name)
        monkeypatch.setattr(mod, "time", _Clock())
        engine = mod.SLOEngine([mod.SLORule(s) for s in specs])
        windows = {r: mod.RunWindow(r) for r in ("ra", "rb")}
        trace = []
        for i, (rec, now) in enumerate(recs):
            windows[rec["run_id"]].ingest(rec, "src", "p", now)
            if i % 10 == 9:
                trace.append(engine.evaluate(windows, now))
        trace.append(engine.snapshot(windows))
        out[name] = trace
    assert out["moco_tpu_torch"] == out["moco_tpu"]
    assert sum(len(t) for t in out["moco_tpu"][:-1]) > 0  # transitions did happen


# ---------------------------------------------------------------------------
# the aggregator
# ---------------------------------------------------------------------------


def _write_lines(path, records):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "a") as f:
        for rec in records:
            f.write(json.dumps(rec) + "\n")


def _st_rule(agg):
    return [agg.SLORule({"name": "st", "objective": "step_time_ms_max", "threshold": 1000.0,
                         "fast_window_s": 5, "slow_window_s": 10})]


def test_aggregator_emits_slo_into_producing_stream(agg, tmp_path):
    ev = str(tmp_path / "train" / "events.jsonl")
    _write_lines(ev, [_step(i, 0.05) for i in range(4, 10)])
    a = agg.Aggregator([str(tmp_path / "train")], rules=_st_rule(agg))
    assert a.poll_once() == []
    _write_lines(ev, [_step(11, 2.0)])
    (transition,) = a.poll_once()
    assert transition["action"] == "alert"
    slo_lines = [json.loads(line) for line in open(ev) if '"slo"' in line]
    assert len(slo_lines) == 1
    assert slo_lines[0]["kind"] == "slo" and slo_lines[0]["run_id"] == "r1"
    assert slo_lines[0]["rule"] == "st"
    assert a.poll_once() == []
    assert a.windows["r1"].slo_events == 1


def test_aggregator_no_emit_mode(agg, tmp_path):
    ev = str(tmp_path / "train" / "events.jsonl")
    os.makedirs(os.path.dirname(ev))
    a = agg.Aggregator([str(tmp_path / "train")], rules=_st_rule(agg), emit_slo=False)
    a.poll_once()
    _write_lines(ev, [_step(11, 2.0)])
    (transition,) = a.poll_once()
    assert transition["action"] == "alert"
    assert not [line for line in open(ev) if '"slo"' in line]
    assert a.windows["r1"].slo_events == 1


def test_aggregator_restart_does_not_replay_history(agg, tmp_path):
    ev = str(tmp_path / "train" / "events.jsonl")
    _write_lines(ev, [_step(i, 0.05) for i in range(4, 10)] + [_step(10, 2.0)]
                 + [{"kind": "slo", "action": "alert", "rule": "st", "run_id": "r1"},
                    {"kind": "slo", "action": "recover", "rule": "st", "run_id": "r1"}])
    a = agg.Aggregator([str(tmp_path / "train")], rules=_st_rule(agg))
    assert a.poll_once() == [] and a.poll_once() == []
    window = a.windows["r1"]
    assert window.steps_total == 7 and window.slo_events == 2
    assert window.metric("step_time_ms_max", 1e9, time.monotonic()) is None
    assert len([line for line in open(ev) if '"slo"' in line]) == 2
    _write_lines(ev, [_step(20, 2.0)])
    (transition,) = a.poll_once()
    assert transition["action"] == "alert"


def test_aggregator_discovers_late_replica_dirs(agg, tmp_path):
    fleet = tmp_path / "fleet"
    _write_lines(str(fleet / "events.jsonl"), [{"kind": "fleet", "event": "fleet_start",
                                                "run_id": "f1", "replicas": 2}])
    a = agg.Aggregator([str(fleet)], rules=[])
    a.poll_once()
    assert a.runs_snapshot()["streams"] == 1
    _write_lines(str(fleet / "replica0" / "events.jsonl"),
                 [{"kind": "serve", "run_id": "f1", "requests": 5, "served": 5,
                   "latency_ms": {"p95": 3.0}}])
    a.poll_once()
    snap = a.runs_snapshot()
    assert snap["streams"] == 2
    (run,) = snap["runs"]
    assert run["kinds"] == {"fleet": 1, "serve": 1}


def test_aggregator_retires_dead_runs(agg, tmp_path):
    ev = str(tmp_path / "train" / "events.jsonl")
    os.makedirs(os.path.dirname(ev))
    a = agg.Aggregator([str(tmp_path / "train")], rules=_st_rule(agg), retire_after_s=100.0)
    now = time.monotonic()
    a.poll_once(now)
    _write_lines(ev, [_step(5, 0.05), {"kind": "run_end", "run_id": "r1", "steps": 5}])
    a.poll_once(now + 1.0)
    assert "r1" in a.windows
    a.poll_once(now + 70.0)
    assert "r1" not in a.windows and a.retired == 1 and not a.engine._state
    _write_lines(ev, [_step(6, 0.05, run="r2")])
    a.poll_once(now + 71.0)
    assert "r2" in a.windows
    a.poll_once(now + 180.0)
    assert "r2" not in a.windows
    _write_lines(ev, [_step(7, 2.0, run="r3")])
    a.poll_once(now + 181.0)
    assert a.engine.state_for("st", "r3").alerting
    a.poll_once(now + 400.0)
    assert "r3" in a.windows  # held until its recovery lands


# ---------------------------------------------------------------------------
# the HTTP endpoints and the CLI
# ---------------------------------------------------------------------------

_PROM_SAMPLE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*(\{[a-zA-Z0-9_]+=\"[^\"]*\""
                          r"(,[a-zA-Z0-9_]+=\"[^\"]*\")*\})? -?[0-9.e+-]+$")


def _get(url, timeout=5.0):
    with urllib.request.urlopen(url, timeout=timeout) as resp:
        return resp.status, dict(resp.headers), resp.read().decode("utf-8")


def validate_prometheus(text: str) -> dict:
    """Assert `text` is well-formed exposition; return {metric: samples}."""
    metrics: dict[str, int] = {}
    typed: set[str] = set()
    for line in text.splitlines():
        if not line:
            continue
        if line.startswith("# HELP ") or line.startswith("# TYPE "):
            parts = line.split(None, 3)
            assert len(parts) >= 4, line
            if parts[1] == "TYPE":
                assert parts[3] in ("gauge", "counter"), line
                typed.add(parts[2])
            continue
        assert _PROM_SAMPLE.match(line), f"bad exposition line: {line!r}"
        name = line.split("{", 1)[0].split(" ", 1)[0]
        assert name in typed, f"sample before TYPE: {line!r}"
        metrics[name] = metrics.get(name, 0) + 1
    assert text.endswith("\n")
    return metrics


@pytest.fixture()
def obs_http(agg, tmp_path):
    train = tmp_path / "train"
    train.mkdir()
    a = agg.Aggregator([str(train)], rules=_st_rule(agg))
    a.poll_once()
    _write_lines(str(train / "events.jsonl"),
                 [{"v": 1, "t": time.time(), "kind": "run_start", "run_id": "r1",
                   "name": "smoke", "arch": "tiny"}]
                 + [_step(i, 0.05, data_s=0.01, mfu=0.3) for i in range(4, 10)]
                 + [{"kind": "event", "event": "rollback", "run_id": "r1"},
                    {"kind": "fleet", "event": "router_stats", "run_id": "r1", "requests": 10,
                     "ok": 9, "shed_no_backend": 1, "outstanding": 2,
                     "latency_ms": {"p50": 1.0, "p95": 2.0, "p99": 3.0}}])
    a.poll_once()
    server = agg.ObsServer(a)
    server.start()
    try:
        yield server, a
    finally:
        server.shutdown()


def test_metrics_endpoint_valid_exposition(obs_http):
    server, _ = obs_http
    status, headers, body = _get(server.url + "/metrics")
    assert status == 200
    assert headers["Content-Type"].startswith("text/plain; version=0.0.4")
    metrics = validate_prometheus(body)
    assert metrics["moco_tpu_steps_total"] == 1
    assert metrics["moco_tpu_step_time_ms"] == 3
    assert metrics["moco_tpu_events_total"] >= 1
    assert metrics["moco_tpu_router_outstanding"] == 1
    assert metrics["moco_tpu_router_requests_total"] == 1
    assert metrics["moco_tpu_router_latency_ms"] == 3
    assert metrics["moco_tpu_obsd_streams"] == 1
    assert 'run_id="r1"' in body


def test_slo_and_runs_endpoints_json(obs_http):
    server, _ = obs_http
    status, headers, body = _get(server.url + "/slo")
    assert status == 200 and headers["Content-Type"] == "application/json"
    slo = json.loads(body)
    assert slo["v"] == 1
    (rule,) = slo["rules"]
    assert rule["name"] == "st" and rule["runs"]["r1"]["state"] == "ok"
    _, _, body = _get(server.url + "/runs")
    runs = json.loads(body)
    assert runs["records"] == 9
    (run,) = runs["runs"]
    assert run["run_id"] == "r1" and run["run"]["name"] == "smoke" and run["steps"] == 6
    assert "stale_s" in run
    assert _get(server.url + "/healthz")[0] == 200
    with pytest.raises(urllib.error.HTTPError) as exc:
        _get(server.url + "/nope")
    assert exc.value.code == 404


def _obsd_main(name):
    if name == "moco_tpu":
        spec = importlib.util.spec_from_file_location("_tool_obsd",
                                                      os.path.join(REPO, "tools", "obsd.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod
    return importlib.import_module("moco_tpu_torch.obsd")


@pytest.mark.parametrize("name", PACKAGES)
def test_obsd_cli_once_mode_and_exit_codes(name, tmp_path, capsys):
    """`--once` prints the /runs snapshot; a bad rule file or tick is 45."""
    events = tmp_path / "t" / "events.jsonl"
    events.parent.mkdir()
    events.write_text(json.dumps({"v": 1, "t": 0.0, "kind": "step", "run_id": "r", "step": 5,
                                  "step_s": 0.05}) + "\n")
    main = _obsd_main(name).main
    assert main([str(tmp_path / "t"), "--once"]) == 0
    snap = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert snap["records"] == 1
    bad = tmp_path / "rules.json"
    bad.write_text("{}")
    assert main([str(tmp_path / "t"), "--once", "--rules", str(bad)]) == 45
    assert main([str(tmp_path / "t"), "--once", "--rules", str(tmp_path / "none.json")]) == 45
    assert main([str(tmp_path / "t"), "--once", "--tick-secs", "0"]) == 45


def test_obsd_cli_flags_and_defaults_equal_the_tool():
    def flags(p):
        return {a.dest: (sorted(a.option_strings), a.default, a.type, a.nargs)
                for a in p._actions if a.dest != "help"}

    assert flags(_obsd_main("moco_tpu_torch").build_parser()) == \
        flags(_obsd_main("moco_tpu").build_parser())


def test_obsd_daemon_serves_and_exits_0_on_sigterm(tmp_path):
    """`python -m moco_tpu_torch.obsd` as a daemon: the endpoints answer,
    SIGTERM drains, the exit is 0."""
    import signal

    from moco_tpu_torch.serve.fleet import pick_free_port

    events = tmp_path / "t" / "events.jsonl"
    events.parent.mkdir()
    events.write_text(json.dumps(_step(5, 0.05)) + "\n")
    port = pick_free_port()
    proc = subprocess.Popen([sys.executable, "-m", "moco_tpu_torch.obsd", str(tmp_path / "t"),
                             "--port", str(port), "--tick-secs", "0.1"],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                            cwd=REPO, env={**os.environ, "PYTHONPATH": REPO})
    try:
        deadline = time.monotonic() + 60.0
        while True:
            try:
                status, _, body = _get(f"http://127.0.0.1:{port}/metrics")
                break
            except OSError:
                assert time.monotonic() < deadline and proc.poll() is None, "obsd never served"
                time.sleep(0.05)
        assert status == 200
        validate_prometheus(body)
        assert "moco_tpu_steps_total" in body
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=60)
        assert proc.returncode == 0, out
        assert "obsd drained cleanly" in out
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate(timeout=10)


# ---------------------------------------------------------------------------
# the two Aggregators on the same recorded streams
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def recorded(tmp_path_factory):
    """A tiny port CPU pretrain's telemetry and a port fleet's telemetry
    directory (two real `--device cpu` replicas of a `resnet_tiny` export,
    a few embeds, a torn step quarantined, a stop), recorded once."""
    import base64

    import numpy as np
    import torch

    from moco_tpu_torch import train
    from moco_tpu_torch.checkpoint import _save_flat, resnet_to_torchvision
    from moco_tpu_torch.config import get_preset
    from moco_tpu_torch.models import build_backbone
    from moco_tpu_torch.resilience.chaos import truncate_checkpoint
    from moco_tpu_torch.resilience.integrity import manifest_path, write_manifest
    from moco_tpu_torch.serve.fleet import FleetPolicy, FleetSupervisor

    root = tmp_path_factory.mktemp("recorded")
    torch.manual_seed(0)
    export = str(root / "encoder.npz")
    _save_flat(resnet_to_torchvision(build_backbone("resnet_tiny", cifar_stem=True)
                                     .state_dict(), prefix="module.encoder_q."), export)
    watch = root / "watch"
    watch.mkdir()

    def child_argv(index, port, tdir, pretrained):
        return [sys.executable, "-u", "-m", "moco_tpu_torch.serve", "--pretrained",
                pretrained or export, "--arch", "resnet_tiny", "--image-size", "32",
                "--cifar-stem", "true", "--buckets", "1", "4", "--embed-cache-mb", "0",
                "--snapshot-every", "1", "--device", "cpu", "--port", str(port),
                "--telemetry-dir", tdir]

    fleet = FleetSupervisor(
        child_argv, replicas=2, telemetry_dir=str(root / "fleet"), watch_dir=str(watch),
        env={**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1"},
        policy=FleetPolicy(probe_secs=0.2, probe_timeout_s=5.0, health_stale_secs=30.0,
                           startup_grace_secs=60.0, watch_poll_secs=0.2,
                           stats_every_secs=0.5), seed=0)
    fleet.start()
    try:
        config = get_preset("cifar10-moco-v1").replace(
            arch="resnet_tiny", dataset="synthetic", image_size=16, batch_size=16,
            num_negatives=64, embed_dim=32, lr=0.1, epochs=1, steps_per_epoch=6, ckpt_dir="",
            tb_dir="", print_freq=4, num_classes=10, knn_monitor=False,
            telemetry_dir=str(root / "train"), telemetry_flush_steps=2, telemetry_stride=2,
            health_stride=2, peak_flops_per_chip=1e12, staging_workers=1)
        threads = torch.get_num_threads()
        torch.set_num_threads(1)  # the replicas run on one thread each beside it
        try:
            train.train(config, device="cpu", on_step=lambda *a: None)  # while they start
        finally:
            torch.set_num_threads(threads)
        deadline = time.monotonic() + 60.0
        while fleet.healthy_count() < 2:
            assert time.monotonic() < deadline, "replicas never healthy"
            time.sleep(0.05)
        img = np.random.RandomState(1).randint(0, 256, (32, 32, 3)).astype(np.uint8)
        body = json.dumps({"image_b64": base64.b64encode(img.tobytes()).decode("ascii"),
                           "shape": [32, 32, 3]}).encode()
        for _ in range(6):
            assert fleet.router_proxy("/v1/embed", body)[0] == 200
        stage = root / "stage"  # torn before it is moved in, its manifest last
        (stage / "3").mkdir(parents=True)
        shutil.copy(export, stage / "3" / "encoder.npz")
        write_manifest(str(stage), 3)
        truncate_checkpoint(str(stage), 3)
        os.rename(stage / "3", watch / "3")
        os.makedirs(os.path.dirname(manifest_path(str(watch), 3)), exist_ok=True)
        os.rename(manifest_path(str(stage), 3), manifest_path(str(watch), 3))
        while not any(e["event"] == "reload_quarantine" for e in fleet.incidents):
            assert time.monotonic() < deadline + 30.0, "the torn step was never quarantined"
            time.sleep(0.05)
    finally:
        fleet.stop()
    return root


def _replay(name, recorded, dest):
    """Both streams replayed LIVE into `dest` (the aggregator tails empty
    files first) under pinned clocks; returns every endpoint's payload and
    the slo lines it appended, with `dest` written as ROOT."""
    mod = _mod(name)
    clock = _Clock()
    mod_time = mod.time
    mod.time = clock
    try:
        files = {}
        for sub in ("train", "fleet"):
            for dirpath, _dirs, names in os.walk(recorded / sub):
                for n in names:
                    if n == "events.jsonl":
                        rel = os.path.relpath(os.path.join(dirpath, n), recorded)
                        os.makedirs(os.path.dirname(dest / rel), exist_ok=True)
                        (dest / rel).write_text("")
                        files[rel] = (recorded / rel).read_text()
        rules = mod.load_rules(None) + [
            mod.SLORule({"name": "any_step", "objective": "step_time_ms_max", "threshold": 0.0,
                         "min_step": 0, "fast_window_s": 30.0}),
            mod.SLORule({"name": "quarantines", "objective": "event:reload_quarantine",
                         "op": ">=", "threshold": 1.0, "fast_window_s": 30.0})]
        agg = mod.Aggregator([str(dest / "train"), str(dest / "fleet")], rules=rules)
        out = [agg.poll_once()]
        for rel in sorted(files):  # one stream at a time, one tick each
            clock.mono += 1.0
            with open(dest / rel, "a") as f:
                f.write(files[rel])
            out.append(agg.poll_once())
        clock.mono += 1.0
        out.append(agg.poll_once())
        payloads = [out, agg.prometheus(), agg.slo_snapshot(), agg.runs_snapshot()]
        slo_lines = {rel: [ln for ln in (dest / rel).read_text().splitlines()
                           if '"kind": "slo"' in ln] for rel in sorted(files)}
    finally:
        mod.time = mod_time
    text = json.dumps([payloads, slo_lines], sort_keys=True)
    return json.loads(text.replace(str(dest), "ROOT")), files


def test_aggregators_equal_on_recorded_streams(recorded, tmp_path):
    """Nothing is dropped: with both clocks pinned the two packages'
    `/metrics` text, `/slo` and `/runs` JSON, tick transitions and written
    slo lines are equal whole."""
    jax_out, files = _replay("moco_tpu", recorded, tmp_path / "jax")
    port_out, _ = _replay("moco_tpu_torch", recorded, tmp_path / "port")
    assert port_out == jax_out
    (ticks, metrics, slo, runs), slo_lines = port_out
    validate_prometheus(metrics)
    assert sorted(files) == ["fleet/events.jsonl", "fleet/replica0/events.jsonl",
                             "fleet/replica1/events.jsonl", "train/events.jsonl"]
    assert runs["streams"] == 4
    kinds = {k for r in runs["runs"] for k in r["kinds"]}
    assert {"step", "run_start", "run_end", "fleet", "serve"} <= kinds
    for name in ("moco_tpu_steps_total", "moco_tpu_step_time_ms", "moco_tpu_mfu",
                 "moco_tpu_health", "moco_tpu_router_requests_total",
                 "moco_tpu_serve_latency_ms", "moco_tpu_slo_alert"):
        assert name in metrics, name
    fired = {t["rule"] for tick in ticks for t in tick}
    assert {"any_step", "quarantines", "reload_failure"} <= fired
    assert sum(len(v) for v in slo_lines.values()) == len(
        [t for tick in ticks for t in tick])
    states = {r["name"]: r["runs"] for r in slo["rules"]}
    assert any(s["state"] == "alert" for s in states["quarantines"].values())
