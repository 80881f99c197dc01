"""The port's run supervisor (`moco_tpu_torch/resilience/supervisor.py`) on
the CPU: every tier-1 test of `tests/test_supervisor.py` against the port's
modules, with the same stdlib stub child, then the port held against the
JAX functions on the same inputs, drawn from a numpy seed: `classify_exit`
over a grid of exit codes, hang flags and events tails, the restart
backoff with the same seeded `random.Random`, and `preflight_resume` on
the same fake checkpoint tree.

The one difference allowed: the native-crash detail names the CUDA runtime
where the JAX package names XLA's.
"""

import json
import os
import random
import shutil
import signal
import sys
import textwrap
import time

import numpy as np
import pytest

from moco_tpu.resilience import supervisor as jsup
from moco_tpu.resilience.integrity import write_manifest as jax_write_manifest
from moco_tpu_torch.resilience.chaos import ChaosPlan, parse_chaos_spec
from moco_tpu_torch.resilience.exitcodes import EXIT_PREEMPTED, EXIT_ROLLBACK_EXHAUSTED
from moco_tpu_torch.resilience.integrity import write_manifest
from moco_tpu_torch.resilience.supervisor import (
    CLASS_CLEAN,
    CLASS_CRASH,
    CLASS_HANG,
    CLASS_KILLED,
    CLASS_NATIVE_CRASH,
    CLASS_OOM,
    CLASS_PREEMPTED,
    CLASS_ROLLBACK_EXHAUSTED,
    FATAL_CLASSES,
    QUARANTINE_DIRNAME,
    RestartPolicy,
    Supervisor,
    classify_exit,
    preflight_resume,
    read_events_tail,
    read_heartbeat,
    tail_rss_bytes,
)

# ---------------------------------------------------------------------------
# classification
# ---------------------------------------------------------------------------


def test_classify_named_exit_codes():
    assert classify_exit(0)[0] == CLASS_CLEAN
    assert classify_exit(EXIT_PREEMPTED)[0] == CLASS_PREEMPTED
    assert classify_exit(EXIT_ROLLBACK_EXHAUSTED)[0] == CLASS_ROLLBACK_EXHAUSTED
    assert classify_exit(45)[0] == "config_error"
    assert classify_exit(2)[0] == "config_error"  # argparse usage error
    assert classify_exit(46)[0] == "data_quality"
    # a bind failure never restart-loops against the same occupied socket
    assert classify_exit(47)[0] == "serve_bind"
    assert "serve_bind" in FATAL_CLASSES
    assert classify_exit(1)[0] == CLASS_CRASH
    assert classify_exit(77)[0] == CLASS_CRASH  # unknown positive code


def test_classify_signal_deaths():
    assert classify_exit(-int(signal.SIGSEGV))[0] == CLASS_NATIVE_CRASH
    assert classify_exit(-int(signal.SIGABRT))[0] == CLASS_NATIVE_CRASH
    assert classify_exit(-int(signal.SIGBUS))[0] == CLASS_NATIVE_CRASH
    assert classify_exit(-int(signal.SIGKILL))[0] == CLASS_KILLED
    assert classify_exit(-int(signal.SIGTERM))[0] == CLASS_KILLED


def test_classify_hang_wins_over_exit_code():
    """A SIGTERM-responsive hang exits EXIT_PREEMPTED on the way down; the
    supervisor's own kill decision still classifies it as a hang."""
    cls, detail = classify_exit(EXIT_PREEMPTED, hang_killed=True)
    assert cls == CLASS_HANG
    assert "staleness" in detail


def test_classify_oom_from_events_tail():
    tail = [
        {"kind": "step", "step": 9, "host_rss_bytes": 2e9},
        {"kind": "step", "step": 10, "host_rss_bytes": 9e9},
        {"kind": "event", "event": "watchdog"},
    ]
    assert classify_exit(-9, events_tail=tail, oom_rss_bytes=8e9)[0] == CLASS_OOM
    # below the threshold, or with no threshold configured: external kill
    assert classify_exit(-9, events_tail=tail, oom_rss_bytes=1e10)[0] == CLASS_KILLED
    assert classify_exit(-9, events_tail=tail)[0] == CLASS_KILLED
    assert tail_rss_bytes(tail) == 9e9
    assert tail_rss_bytes([]) == 0.0


def test_read_events_tail_skips_torn_lines(tmp_path):
    path = str(tmp_path / "events.jsonl")
    with open(path, "w") as f:
        f.write('{"kind": "step", "step": 1}\n')
        f.write('{"kind": "step", "step": 2}\n')
        f.write('{"kind": "step", "ste')  # torn tail: SIGKILL mid-flush
    records = read_events_tail(path)
    assert [r["step"] for r in records] == [1, 2]
    assert read_events_tail(str(tmp_path / "missing.jsonl")) == []


def test_read_heartbeat_absent_or_torn(tmp_path):
    path = str(tmp_path / "heartbeat.json")
    assert read_heartbeat(path) is None
    with open(path, "w") as f:
        f.write('{"step": 4')
    assert read_heartbeat(path) is None
    with open(path, "w") as f:
        json.dump({"step": 4, "pid": 123}, f)
    assert read_heartbeat(path) == {"step": 4, "pid": 123}


# ---------------------------------------------------------------------------
# backoff + budget
# ---------------------------------------------------------------------------


def test_backoff_exponential_capped_jittered():
    p = RestartPolicy(backoff_base_secs=1.0, backoff_max_secs=8.0, backoff_jitter=0.0)
    rng = random.Random(0)
    assert [p.backoff_secs(n, rng) for n in (1, 2, 3, 4, 5)] == [1.0, 2.0, 4.0, 8.0, 8.0]
    jittered = RestartPolicy(backoff_base_secs=1.0, backoff_max_secs=8.0, backoff_jitter=0.5)
    vals = [jittered.backoff_secs(1, random.Random(s)) for s in range(32)]
    assert all(1.0 <= v <= 1.5 for v in vals)
    assert len(set(vals)) > 1  # jitter actually varies


def _bare_supervisor(tmp_path, **policy_kw):
    return Supervisor(["true"], telemetry_dir=str(tmp_path),
                      policy=RestartPolicy(**policy_kw))


def test_budget_consumed_by_no_progress_refunded_by_progress(tmp_path):
    sup = _bare_supervisor(tmp_path, max_restarts=2)
    assert sup._note_exit(progressed=False)   # budget 2 -> 1
    assert sup._note_exit(progressed=False)   # budget 1 -> 0
    assert not sup._note_exit(progressed=False)  # exhausted: crash loop
    sup = _bare_supervisor(tmp_path, max_restarts=2)
    assert sup._note_exit(progressed=False)
    assert sup._note_exit(progressed=True)    # progress refunds the budget
    assert sup._note_exit(progressed=False)
    assert sup._note_exit(progressed=False)
    assert not sup._note_exit(progressed=False)


def test_zero_budget_never_restarts(tmp_path):
    sup = _bare_supervisor(tmp_path, max_restarts=0)
    assert not sup._note_exit(progressed=True)


def test_progress_marker_prefers_heartbeat_falls_back_to_ckpt(tmp_path):
    ckpt = tmp_path / "ckpt"
    (ckpt / "8").mkdir(parents=True)
    sup = Supervisor(["true"], telemetry_dir=str(tmp_path), ckpt_dir=str(ckpt))
    assert sup._progress_marker() == 8  # no heartbeat yet: newest ckpt step
    with open(tmp_path / "heartbeat.json", "w") as f:
        json.dump({"step": 11, "pid": 1}, f)
    assert sup._progress_marker() == 11


# ---------------------------------------------------------------------------
# resume-integrity preflight
# ---------------------------------------------------------------------------


def _fake_ckpt_step(ckpt_dir, step, manifest=True, payload=b"x" * 2048,
                    writer=write_manifest):
    d = ckpt_dir / str(step)
    d.mkdir(parents=True)
    (d / "payload.bin").write_bytes(payload)
    if manifest:
        writer(str(ckpt_dir), step)


def test_preflight_quarantines_corrupt_newest_stops_at_survivor(tmp_path):
    ckpt = tmp_path / "ckpt"
    _fake_ckpt_step(ckpt, 4, manifest=False)  # pre-manifest: never touched
    _fake_ckpt_step(ckpt, 8)
    _fake_ckpt_step(ckpt, 12)
    _fake_ckpt_step(ckpt, 16)
    (ckpt / "16" / "payload.bin").write_bytes(b"y" * 1024)  # corrupt newest
    (ckpt / "12" / "payload.bin").write_bytes(b"z" * 1024)  # and the next
    emitted = []
    gone = preflight_resume(str(ckpt), emit=lambda e, **f: emitted.append((e, f)))
    # newest-first: 16 and 12 quarantined, the walk STOPS at verifying 8
    assert gone == [16, 12]
    assert sorted(n for n in os.listdir(ckpt) if n.isdigit()) == ["4", "8"]
    assert os.path.isdir(ckpt / QUARANTINE_DIRNAME / "16")
    assert os.path.isdir(ckpt / QUARANTINE_DIRNAME / "12")
    # the corrupt steps' sidecars do not survive as dangling references
    assert not os.path.exists(ckpt / ".integrity" / "16.json")
    assert [e for e, _ in emitted] == ["preflight_quarantine"] * 2
    assert [f["step"] for _, f in emitted] == [16, 12]
    # second pass: newest (8) verifies immediately, nothing to do
    assert preflight_resume(str(ckpt)) == []
    assert preflight_resume(str(tmp_path / "missing")) == []


def test_preflight_manifestless_newest_stops_walk(tmp_path):
    """A manifest-less newest step verifies vacuously (the restore is then
    the gate) and ends the walk."""
    ckpt = tmp_path / "ckpt"
    _fake_ckpt_step(ckpt, 8)
    (ckpt / "8" / "payload.bin").write_bytes(b"y" * 1024)  # corrupt, behind
    _fake_ckpt_step(ckpt, 12, manifest=False)
    assert preflight_resume(str(ckpt)) == []
    assert sorted(n for n in os.listdir(ckpt) if n.isdigit()) == ["12", "8"]


# ---------------------------------------------------------------------------
# chaos kill/freeze plumbing
# ---------------------------------------------------------------------------


def test_parse_chaos_spec_kill_and_freeze():
    plan = parse_chaos_spec("kill_at_step=6,freeze_at_step=9")
    assert plan.kill_at_step == 6
    assert plan.freeze_at_step == 9


def test_chaos_fire_once_persists_across_processes(tmp_path):
    """A kill/freeze fault fires once per SCENARIO, not once per process:
    the restarted child re-traverses the fault's step. The marker is
    written BEFORE the fault executes."""
    state = str(tmp_path / "chaos_state")
    first = ChaosPlan(kill_at_step=5, state_dir=state)
    assert first._fire_once("kill")
    assert os.path.exists(os.path.join(state, "fired_kill"))
    assert not first._fire_once("kill")
    second = ChaosPlan(kill_at_step=5, state_dir=state)
    assert not second._fire_once("kill")
    assert second._fire_once("freeze")  # other faults unaffected


def test_env_chaos_state_dir_wired(tmp_path, monkeypatch):
    from moco_tpu_torch.resilience.chaos import active_chaos, clear_chaos

    monkeypatch.setenv("MOCO_TPU_CHAOS", "kill_at_step=3")
    monkeypatch.setenv("MOCO_TPU_CHAOS_STATE", str(tmp_path))
    clear_chaos()
    try:
        plan = active_chaos()
        assert plan.kill_at_step == 3
        assert plan.state_dir == str(tmp_path)
    finally:
        clear_chaos()


# ---------------------------------------------------------------------------
# stub-child e2e: the real Supervisor loop, seconds-cheap children
# ---------------------------------------------------------------------------

STUB = textwrap.dedent("""\
    import json, os, sys, time
    tdir, state_path = sys.argv[1], sys.argv[2]
    plan = sys.argv[3].split(",")
    extra = sys.argv[4:]  # e.g. the supervisor-appended `--resume auto`
    n = 0
    if os.path.exists(state_path):
        n = int(open(state_path).read())
    open(state_path, "w").write(str(n + 1))
    with open(os.path.join(tdir, "argv_%d.json" % n), "w") as f:
        json.dump(extra, f)
    behavior = plan[min(n, len(plan) - 1)]
    def beat(step, phase="step"):
        p = os.path.join(tdir, "heartbeat.json")
        with open(p + ".tmp", "w") as f:
            json.dump({"v": 1, "t": round(time.time(), 3), "step": step,
                       "pid": os.getpid(), "phase": phase}, f)
        os.replace(p + ".tmp", p)
    kind, _, arg = behavior.partition(":")
    if kind == "hang":
        beat(int(arg or 1))
        time.sleep(300)
    elif kind == "ok":
        beat(int(arg or 5))
        sys.exit(0)
    elif kind == "eval_pause":
        beat(3)
        beat(3, phase="eval")
        time.sleep(float(arg or 1.5))
        beat(5)
        sys.exit(0)
    elif kind == "silent_ok":
        time.sleep(float(arg or 1.0))
        sys.exit(0)
    elif kind == "preempt":
        beat(int(arg or 3), phase="preempt_exit")
        sys.exit(43)
    elif kind == "exit":
        sys.exit(int(arg))
    else:
        raise SystemExit("unknown stub behavior %r" % behavior)
""")


def _stub_supervisor(tmp_path, plan, **policy_kw):
    stub = tmp_path / "stub.py"
    stub.write_text(STUB)
    tdir = tmp_path / "telemetry"
    tdir.mkdir(exist_ok=True)
    defaults = dict(
        max_restarts=3, heartbeat_stale_secs=0.5, startup_grace_secs=10.0,
        term_grace_secs=1.0, backoff_base_secs=0.05, backoff_max_secs=0.2,
        backoff_jitter=0.0, poll_secs=0.1,
    )
    defaults.update(policy_kw)
    return Supervisor(
        [sys.executable, str(stub), str(tdir), str(tmp_path / "attempts"), plan],
        telemetry_dir=str(tdir),
        policy=RestartPolicy(**defaults),
        seed=0,
    ), tdir


def test_e2e_hang_killed_within_window_then_restarted(tmp_path):
    """A child that beats once then goes silent is killed within 2x the
    staleness window and the relaunch finishes the run."""
    sup, tdir = _stub_supervisor(tmp_path, "hang:1,ok:5")
    t0 = time.monotonic()
    result = sup.run()
    assert result.final_class == CLASS_CLEAN
    assert result.classifications == [CLASS_HANG, CLASS_CLEAN]
    assert result.restarts == 1 and not result.gave_up
    kills = [r for r in sup.incidents if r["event"] == "kill"]
    assert kills and kills[0]["reason"] == "heartbeat_stale"
    # 2x the window, plus fixed slack for scheduler noise at this 0.5 s window
    assert kills[0]["stale_secs"] <= 2 * sup.policy.heartbeat_stale_secs + 1.0
    assert time.monotonic() - t0 < 30.0
    records = read_events_tail(os.path.join(str(tdir), "events.jsonl"))
    events = [r["event"] for r in records if r.get("kind") == "supervisor"]
    assert "launch" in events and "kill" in events and "done" in events


def test_e2e_crash_loop_exhausts_budget(tmp_path):
    sup, _ = _stub_supervisor(tmp_path, "exit:1", max_restarts=2)
    result = sup.run()
    assert result.gave_up
    assert result.final_class == CLASS_CRASH
    assert result.launches == 3  # initial + max_restarts
    assert all(c == CLASS_CRASH for c in result.classifications)
    give_up = [r for r in sup.incidents if r["event"] == "give_up"]
    assert give_up and "budget exhausted" in give_up[0]["reason"]


def test_e2e_fatal_class_never_restarts(tmp_path):
    sup, _ = _stub_supervisor(tmp_path, "exit:44")
    result = sup.run()
    assert result.final_class == CLASS_ROLLBACK_EXHAUSTED
    assert result.launches == 1 and not result.gave_up
    assert [r["event"] for r in sup.incidents if r["event"] == "restart"] == []


def test_e2e_preempt_relaunches_without_backoff_and_forces_resume(tmp_path):
    sup, tdir = _stub_supervisor(tmp_path, "preempt:3,ok:7")
    result = sup.run()
    assert result.final_class == CLASS_CLEAN
    assert result.classifications == [CLASS_PREEMPTED, CLASS_CLEAN]
    assert [r for r in sup.incidents if r["event"] == "backoff"] == []
    # EVERY launch carries --resume auto (attempt 0 included)
    for attempt in (0, 1):
        with open(tdir / f"argv_{attempt}.json") as f:
            assert json.load(f) == ["--resume", "auto"]


def test_e2e_eval_phase_widens_staleness_window(tmp_path):
    """A declared non-step phase (the kNN eval's "eval" beat) suspends the
    tight window; only the startup grace applies while it lasts."""
    sup, _ = _stub_supervisor(tmp_path, "eval_pause:1.5")
    result = sup.run()
    assert result.final_class == CLASS_CLEAN
    assert result.restarts == 0
    assert [r for r in sup.incidents if r["event"] == "kill"] == []


def test_e2e_never_any_heartbeat_disables_kill_not_loops(tmp_path):
    """A child that never writes a heartbeat is not kill-restarted on a
    cycle: hang detection turns off with a loud incident."""
    sup, _ = _stub_supervisor(tmp_path, "silent_ok:1.2", startup_grace_secs=0.3)
    result = sup.run()
    assert result.final_class == CLASS_CLEAN
    assert result.restarts == 0
    assert [r for r in sup.incidents if r["event"] == "kill"] == []
    warns = [r for r in sup.incidents if r["event"] == "no_heartbeat"]
    assert len(warns) == 1


def test_e2e_stale_zero_disables_hang_detection(tmp_path):
    """heartbeat_stale_secs <= 0: no kill ever."""
    sup, _ = _stub_supervisor(tmp_path, "ok:5", heartbeat_stale_secs=0.0,
                              startup_grace_secs=0.01)
    result = sup.run()
    assert result.final_class == CLASS_CLEAN
    assert [r for r in sup.incidents if r["event"] == "kill"] == []


def test_launch_respects_equals_form_resume(tmp_path, monkeypatch):
    """`--resume=7` in the child argv suppresses the appended `--resume
    auto` exactly like the space-separated form."""
    import moco_tpu_torch.resilience.supervisor as supmod

    sup = Supervisor(["python", "-m", "moco_tpu_torch.train", "--resume=7"],
                     telemetry_dir=str(tmp_path))
    argv_out = {}

    class _FakePopen:
        pid = 1

        def __init__(self, argv, **kw):
            argv_out["argv"] = argv

    monkeypatch.setattr(supmod.subprocess, "Popen", _FakePopen)
    sup._launch(attempt=1)
    assert argv_out["argv"].count("--resume") == 0
    assert "--resume=7" in argv_out["argv"]
    assert "auto" not in argv_out["argv"]


def test_e2e_progress_refunds_budget(tmp_path):
    """Three deaths, each after fresh step progress, on a budget of 1."""
    sup, _ = _stub_supervisor(tmp_path, "preempt:3,preempt:6,preempt:9,ok:12",
                              max_restarts=1)
    result = sup.run()
    assert result.final_class == CLASS_CLEAN
    assert result.restarts == 3 and not result.gave_up


# ---------------------------------------------------------------------------
# parity with the JAX functions on the same inputs
# ---------------------------------------------------------------------------


def _tails(seed: int) -> list[list[dict] | None]:
    """Events tails drawn from a numpy seed: none, an empty one, one with
    no RSS sample, and ones whose RSS samples sit around the thresholds."""
    rng = np.random.RandomState(seed)
    tails = [None, [], [{"kind": "event", "event": "watchdog"}]]
    for _ in range(4):
        tail = []
        for step in range(int(rng.randint(1, 5))):
            kind = ["step", "pod", "event"][rng.randint(3)]
            rec = {"kind": kind, "step": step}
            key = ["host_rss_bytes", "host_rss_bytes_max", None][rng.randint(3)]
            if key:
                rec[key] = float(rng.uniform(0, 16e9))
            tail.append(rec)
        tails.append(tail)
    return tails


@pytest.mark.parametrize("seed", range(3))
def test_classify_exit_equals_the_jax_function_over_a_grid(seed):
    thresholds = [0.0] + list(np.random.RandomState(100 + seed).uniform(0, 16e9, size=2))
    n = 0
    for rc in range(-31, 61):
        for hang in (False, True):
            for tail in _tails(seed):
                for oom in thresholds:
                    ours = classify_exit(rc, hang_killed=hang, events_tail=tail,
                                         oom_rss_bytes=oom)
                    theirs = jsup.classify_exit(rc, hang_killed=hang, events_tail=tail,
                                                oom_rss_bytes=oom)
                    assert ours[0] == theirs[0], (rc, hang, tail, oom)
                    assert ours[1].replace("CUDA runtime", "XLA runtime") == theirs[1]
                    n += 1
    assert n == 92 * 2 * 7 * 3
    assert FATAL_CLASSES == jsup.FATAL_CLASSES
    assert RestartPolicy().restart_on == jsup.RestartPolicy().restart_on
    assert RestartPolicy().no_backoff == jsup.RestartPolicy().no_backoff


@pytest.mark.parametrize("seed", range(4))
def test_backoff_equals_the_jax_policy_with_the_same_rng(seed):
    knobs = np.random.RandomState(seed)
    kw = dict(backoff_base_secs=float(knobs.uniform(0.01, 3.0)),
              backoff_max_secs=float(knobs.uniform(1.0, 90.0)),
              backoff_jitter=float(knobs.uniform(0.0, 1.0)))
    ours, theirs = RestartPolicy(**kw), jsup.RestartPolicy(**kw)
    ra, rb = random.Random(seed), random.Random(seed)
    for n in range(0, 12):
        assert ours.backoff_secs(n, ra) == theirs.backoff_secs(n, rb)


@pytest.mark.parametrize("seed", range(3))
def test_preflight_equals_the_jax_function_on_the_same_tree(seed, tmp_path):
    """The same fake checkpoint tree (steps, manifests and corruptions from
    a numpy seed) under each package's preflight: the same steps
    quarantined, the same records (their paths relative to the root), the
    same steps left, the same sidecars."""
    rng = np.random.RandomState(seed)
    steps = sorted(rng.choice(np.arange(2, 40, 2), size=5, replace=False).tolist())
    roots = {"port": tmp_path / "port", "jax": tmp_path / "jax"}
    for which, root in roots.items():
        ckpt = root / "ckpt"
        writer = write_manifest if which == "port" else jax_write_manifest
        for step in steps:
            manifest = bool(np.random.RandomState(seed * 100 + step).rand() < 0.8)
            _fake_ckpt_step(ckpt, step, manifest=manifest,
                            payload=np.random.RandomState(step).bytes(512), writer=writer)
        corrupt = np.random.RandomState(seed + 7).rand(len(steps)) < 0.5
        for step, bad in zip(steps, corrupt):
            if bad:
                (ckpt / str(step) / "payload.bin").write_bytes(b"y" * 100)
    out = {}
    for which, fn in (("port", preflight_resume), ("jax", jsup.preflight_resume)):
        root = roots[which]
        ckpt = root / "ckpt"
        emitted = []
        gone = fn(str(ckpt), emit=lambda e, **f: emitted.append(
            (e, {k: os.path.relpath(v, root) if k == "moved_to" else v
                 for k, v in f.items()})))
        left = sorted(os.listdir(ckpt))
        sidecars = sorted(os.listdir(ckpt / ".integrity")) \
            if (ckpt / ".integrity").exists() else []
        out[which] = (gone, emitted, left, sidecars)
        shutil.rmtree(ckpt / QUARANTINE_DIRNAME, ignore_errors=True)
    assert out["port"] == out["jax"]
