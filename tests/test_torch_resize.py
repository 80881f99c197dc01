"""The port's elastic resize (`moco_tpu_torch/resilience/resize.py`), its
rank launcher (`parallel/launch.py`, `--num-devices N`) and the driver's
device checks on the CPU.

- Every tier-1 test of `tests/test_resize.py` against the port's modules,
  with its stdlib stub child, `--num-devices` in place of `--fake-devices`;
  `test_dialect_shim_restores_across_mesh_size_change` has no port here
  (the restore across world sizes is `tests/test_torch_zero.py`'s and
  `tests/test_torch_distributed.py`'s), and the driver's chaos resize runs
  as two gloo ranks under the launcher instead of on `mesh8`.
- The port held against the JAX functions on the same inputs, from a numpy
  seed: `parse_resize_request`, `argv_device_count` and
  `ResizeController.apply` (argv and summary). Allowed differences: the
  device flag's name, and no compile-cache key (the port rotates no cache).
- The launcher with gloo ranks and with stub ranks: a SIGKILLed launcher
  leaves no rank alive, one rank's exit ends the others with its code, a
  rank's SIGSEGV is the launcher's -11, and `--device cuda --num-devices 2`
  on a host without a card exits 45.
- The driver's device checks (CUDA asked for and absent, a `LOCAL_RANK`
  with no card) and the `imagenet-moco-v2-8chip` preset.
"""

import json
import os
import signal
import subprocess
import sys
import textwrap
import threading
import time

import numpy as np
import pytest
import torch

from moco_tpu.resilience import resize as jresize
from moco_tpu_torch.resilience.chaos import ChaosPlan, parse_chaos_spec
from moco_tpu_torch.resilience.exitcodes import EXIT_CONFIG_ERROR, EXIT_RESIZE
from moco_tpu_torch.resilience.resize import (
    ResizeController,
    ResizeListener,
    argv_device_count,
    consume_resize_request,
    parse_resize_request,
    pick_device_flag,
    read_honored_request,
    read_recorded_devices,
    write_resize_request,
)
from moco_tpu_torch.resilience.supervisor import (
    CLASS_CLEAN,
    CLASS_RESIZE,
    FATAL_CLASSES,
    RestartPolicy,
    Supervisor,
    classify_exit,
    read_events_tail,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

# ---------------------------------------------------------------------------
# request file protocol
# ---------------------------------------------------------------------------


def test_parse_resize_request_forms():
    req = parse_resize_request("devices=2 grad_sync_cadence=4")
    assert (req.devices, req.grad_sync_cadence, req.slow) == (2, 4, False)
    assert parse_resize_request("devices=2,slow=1").slow is True
    empty = parse_resize_request("")  # "resize to whatever is visible"
    assert empty.devices is None and empty.grad_sync_cadence is None
    with pytest.raises(ValueError, match="unknown resize request key"):
        parse_resize_request("device=2")  # the typo'd key is loud
    with pytest.raises(ValueError, match="devices must be >= 1"):
        parse_resize_request("devices=0")
    with pytest.raises(ValueError, match="key=value"):
        parse_resize_request("devices")
    assert parse_resize_request("devices=8 sharding=fsdp").sharding == "fsdp"
    assert parse_resize_request("devices=2").sharding is None
    with pytest.raises(ValueError, match="sharding"):
        parse_resize_request("sharding=zero3")


def test_resize_apply_carries_sharding_mode(tmp_path):
    """The relaunch argv carries the requested sharding mode (argparse
    last-wins append, like the device count)."""
    d = str(tmp_path)
    ctl = ResizeController(d)
    write_resize_request(d, devices=8, sharding="fsdp")
    req = ctl.poll()
    assert req is not None and req.sharding == "fsdp"
    req = ctl.take()  # the child exited EXIT_RESIZE; claim + disarm
    argv = ["python", "-m", "moco_tpu_torch.train", "--num-devices", "1"]
    summary = ctl.apply(req, argv)
    assert argv[-4:] == ["--num-devices", "8", "--sharding", "fsdp"]
    assert summary["sharding"] == "fsdp"
    # a mode-less request appends nothing: the argv's own --sharding wins
    write_resize_request(d, devices=2)
    req2 = ctl.poll(now=time.monotonic() + 1.0)  # past the poll gate
    assert req2 is not None
    req2 = ctl.take()
    argv2 = ["python", "-m", "moco_tpu_torch.train", "--sharding", "fsdp",
             "--num-devices", "8"]
    ctl.apply(req2, argv2)
    assert "--sharding" not in argv2[-2:]
    assert argv2.count("--sharding") == 1


def test_request_claimed_exactly_once(tmp_path):
    d = str(tmp_path)
    write_resize_request(d, devices=2, grad_sync_cadence=4)
    req = consume_resize_request(d)
    assert req.devices == 2 and req.grad_sync_cadence == 4
    # the claim is a rename: a second consumer finds nothing, but the
    # payload survives at the honored path
    assert consume_resize_request(d) is None
    honored = read_honored_request(d)
    assert honored is not None and honored.devices == 2
    assert consume_resize_request(str(tmp_path / "empty")) is None


def test_unparseable_request_is_claimed_and_ignored(tmp_path):
    d = str(tmp_path)
    with open(os.path.join(d, "resize.request"), "w") as f:
        f.write("device=2\n")  # typo
    assert consume_resize_request(d) is None
    # claimed anyway: a malformed request must not fire on every poll
    assert not os.path.exists(os.path.join(d, "resize.request"))


# ---------------------------------------------------------------------------
# chaos fault + classification
# ---------------------------------------------------------------------------


def test_chaos_resize_spec_and_fire_once(tmp_path):
    plan = parse_chaos_spec("resize_at_step=6,devices=2")
    assert plan.resize_at_step == 6 and plan.resize_devices == 2
    assert parse_chaos_spec("resize_at_step=3,resize_devices=4").resize_devices == 4
    assert plan.maybe_resize(5) is None
    assert plan.maybe_resize(6) == 2
    assert plan.maybe_resize(6) is None  # fire-once in-process
    # marker persistence: the resized relaunch is never fired at again
    state = str(tmp_path / "chaos_state")
    first = ChaosPlan(resize_at_step=4, resize_devices=2, state_dir=state)
    assert first.maybe_resize(4) == 2
    second = ChaosPlan(resize_at_step=4, resize_devices=2, state_dir=state)
    assert second.maybe_resize(4) is None


def test_config_accepts_the_resize_drill():
    """Refused until the elastic resize was ported."""
    from moco_tpu_torch.config import PretrainConfig

    assert PretrainConfig(chaos="resize_at_step=3,devices=2").chaos


def test_classify_resize_restartable_without_backoff():
    cls, detail = classify_exit(EXIT_RESIZE)
    assert cls == CLASS_RESIZE
    assert "resize" in detail
    assert CLASS_RESIZE not in FATAL_CLASSES
    policy = RestartPolicy()
    assert CLASS_RESIZE in policy.restart_on
    assert CLASS_RESIZE in policy.no_backoff


# ---------------------------------------------------------------------------
# argv rewrite + recorded-devices sidecar
# ---------------------------------------------------------------------------


def test_argv_device_count_last_wins_both_forms():
    assert argv_device_count(["x", "--num-devices", "4"]) == 4
    assert argv_device_count(["x", "--num-devices=8"]) == 8
    # argparse last-wins is what the resize append relies on
    assert argv_device_count(["--num-devices", "4", "--num-devices", "2"]) == 2
    assert argv_device_count(["--num-devices", "0"]) is None  # not a count
    assert argv_device_count(["x", "--batch-size", "16"]) is None
    # the JAX CPU proxy's spelling pins nothing in the port
    assert argv_device_count(["x", "--fake-devices", "8"]) is None
    assert pick_device_flag(["--fake-devices", "8"]) == "--num-devices"
    assert pick_device_flag(["--num-devices=4"]) == "--num-devices"
    assert pick_device_flag(["x"]) == "--num-devices"


def test_read_recorded_devices_newest_stamped_step(tmp_path):
    ckpt = tmp_path / "ckpt"
    pos = ckpt / ".position"
    pos.mkdir(parents=True)
    (ckpt / "4").mkdir()
    (ckpt / "8").mkdir()
    (pos / "4.json").write_text('{"epoch": 1, "batch": 0, "devices": 4}')
    (pos / "8.json").write_text('{"epoch": 2, "batch": 0}')  # no stamp
    assert read_recorded_devices(str(ckpt)) == (4, 4)
    (pos / "8.json").write_text('{"epoch": 2, "batch": 0, "devices": 2}')
    assert read_recorded_devices(str(ckpt)) == (8, 2)
    assert read_recorded_devices(str(tmp_path / "missing")) is None


def test_controller_arms_once_and_applies(tmp_path):
    d = str(tmp_path)
    ctl = ResizeController(d, slow_cadence=8)
    assert ctl.poll() is None  # nothing pending
    write_resize_request(d, devices=2, slow=True)
    ctl._last_poll = float("-inf")  # past the poll gate
    req = ctl.poll()
    assert req is not None and req.devices == 2 and req.slow
    assert ctl.poll() is None  # armed: no re-arm until taken
    taken = ctl.take()
    assert taken is req
    argv = ["python", "-m", "moco_tpu_torch.train", "--num-devices", "1"]
    summary = ctl.apply(taken, argv)
    # appended, not edited (argparse last-wins)
    assert argv[-4:] == ["--num-devices", "2", "--grad-sync-cadence", "8"]
    assert summary["devices_from"] == 1 and summary["devices_to"] == 2
    assert "cache_dir" not in summary  # no compile cache to rotate
    # the honored payload is deleted after apply
    assert read_honored_request(d) is None


def test_sigusr2_to_controller_arms_empty_request(tmp_path):
    ctl = ResizeController(str(tmp_path))
    ctl.signal_resize()
    req = ctl.poll()
    assert req is not None and req.source == "sigusr2" and req.devices is None
    assert ctl.poll() is None


def test_sigusr2_recovers_payload_the_child_already_claimed(tmp_path):
    """The operator writes the request, the CHILD's listener claims the
    file, THEN the SIGUSR2 lands: the target count comes from the honored
    payload."""
    d = str(tmp_path)
    write_resize_request(d, devices=3)
    assert consume_resize_request(d) is not None  # the child's claim
    ctl = ResizeController(d)
    ctl.signal_resize()
    req = ctl.poll()
    assert req is not None and req.devices == 3 and req.source == "sigusr2"


def test_listener_file_trigger_and_sigusr2(tmp_path):
    d = str(tmp_path)
    with ResizeListener(d, poll_secs=0.0) as listener:
        assert not listener.poll()
        write_resize_request(d, devices=2)
        assert listener.poll()  # file trigger, consumed on claim
        assert not os.path.exists(os.path.join(d, "resize.request"))
    with ResizeListener("", poll_secs=0.0) as listener:
        assert not listener.poll()
        signal.raise_signal(signal.SIGUSR2)
        assert listener.triggered
    # a TRIGGERED listener leaves SIGUSR2 ignored on exit: the elastic
    # checkpoint is written after the ExitStack closes
    assert signal.getsignal(signal.SIGUSR2) is signal.SIG_IGN
    signal.raise_signal(signal.SIGUSR2)  # harmless now
    prev = signal.signal(signal.SIGUSR2, signal.SIG_DFL)
    try:
        with ResizeListener("", poll_secs=0.0):
            pass
        assert signal.getsignal(signal.SIGUSR2) == signal.SIG_DFL
    finally:
        signal.signal(signal.SIGUSR2, prev)


# ---------------------------------------------------------------------------
# guardrails: the exit path speaks the named constant
# ---------------------------------------------------------------------------


def test_r5_covers_resize_exit_path(tmp_path):
    """A literal 49 would fork the supervisor's protocol (lint rule R5); the
    port's driver exits through EXIT_RESIZE and its launcher passes codes
    through without a literal."""
    from tools import lint_robustness as lint

    (tmp_path / "bad.py").write_text("import sys\nsys.exit(49)\n")
    found = lint.check_file(str(tmp_path / "bad.py"))
    assert len(found) == 1 and "named constants" in found[0]
    with open(os.path.join(ROOT, "moco_tpu_torch", "train.py")) as f:
        source = f.read()
    assert "sys.exit(EXIT_RESIZE)" in source
    for rel in ("train.py", "parallel/launch.py", "supervise.py"):
        path = os.path.join(ROOT, "moco_tpu_torch", rel)
        assert [m for m in lint.check_file(path) if "named constants" in m] == []


# ---------------------------------------------------------------------------
# report folds
# ---------------------------------------------------------------------------


def _sup_record(event, **fields):
    rec = {"v": 1, "t": 0.0, "kind": "supervisor", "event": event}
    rec.update(fields)
    return rec


def test_report_resize_section_and_follow_lines():
    from tools.telemetry_report import render, render_record, summarize

    records = [
        _sup_record("launch", attempt=0),
        _sup_record("resize_request", source="request", devices=2),
        _sup_record("exit", classification="resize", returncode=49),
        _sup_record("resize_relaunch", source="request", devices_from=1,
                    devices_to=2, step=6, grad_sync_cadence=4),
        _sup_record("mesh_change", ckpt_step=6, devices_from=1, devices_to=2),
        _sup_record("launch", attempt=1),
        _sup_record("exit", classification="clean", returncode=0),
        _sup_record("done", launches=2, restarts=1),
    ]
    summary = summarize(records)
    rsz = summary["resize"]
    assert rsz["requests"] == 1 and rsz["relaunches"] == 1
    assert rsz["mesh_changes"] == 1
    assert rsz["transitions"] == [{
        "devices_from": 1, "devices_to": 2, "step": 6,
        "grad_sync_cadence": 4, "source": "request",
    }]
    text = render(summary)
    assert "resize: 1 relaunch(es)" in text
    assert "1→2@6 (cadence 4)" in text
    assert "mesh changes observed at relaunch preflight: 1" in text
    line = render_record(records[3])
    assert line.startswith("resize: resize_relaunch")
    assert render_record(records[4]).startswith("resize: mesh_change")
    assert render_record(records[0]).startswith("supervisor: launch")


# ---------------------------------------------------------------------------
# driver: two gloo ranks under the launcher honor a chaos resize
# ---------------------------------------------------------------------------

TINY = ["--preset", "imagenet-moco-v2", "--dataset", "synthetic", "--arch", "resnet_tiny",
        "--image-size", "32", "--batch-size", "16", "--num-negatives", "64",
        "--embed-dim", "16", "--device", "cpu", "--knn-monitor", "false"]


def _cli(*flags, env=None, timeout=120):
    return subprocess.run([sys.executable, "-m", "moco_tpu_torch.train", *flags], cwd=ROOT,
                          capture_output=True, text=True, timeout=timeout,
                          env=dict(os.environ, OMP_NUM_THREADS="1", **(env or {})))


@pytest.mark.chaos
def test_driver_chaos_resize_elastic_checkpoint(tmp_path):
    """`--num-devices 2`: `resize_at_step=3` fires in one rank (the chaos
    markers are shared), the ranks agree on it at step 4, rank 0 writes one
    elastic checkpoint stamped with 2 processes, run_end says `resized`,
    the heartbeat `resize_exit`, and every rank and the launcher exit 49."""
    tdir, ck = tmp_path / "tel", tmp_path / "ck"
    proc = _cli(*TINY, "--num-devices", "2", "--steps-per-epoch", "3", "--epochs", "3",
                "--resilience-sync-steps", "1", "--heartbeat-secs", "0",
                "--telemetry-dir", str(tdir), "--ckpt-dir", str(ck),
                "--chaos", "resize_at_step=3,devices=1",
                env={"MOCO_TPU_CHAOS_STATE": str(tmp_path / "chaos")})
    assert proc.returncode == EXIT_RESIZE, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert proc.stdout.count("[exit] resize honored") == 2
    assert proc.stdout.count("[chaos] injecting resize request at step 3") == 1
    assert read_recorded_devices(str(ck)) == (4, 2)
    from moco_tpu_torch import checkpoint as ckpt

    assert ckpt.read_position(str(ck), 4) == (1, 1)
    req = consume_resize_request(str(tdir))
    honored = req or read_honored_request(str(tdir))
    assert honored is not None and honored.devices == 1
    with open(tdir / "heartbeat.json") as f:
        hb = json.load(f)
    assert hb["phase"] == "resize_exit" and hb["step"] == 4
    records = read_events_tail(str(tdir / "events.jsonl"), max_bytes=1 << 22)
    (end,) = [r for r in records if r.get("kind") == "run_end"]
    assert end["resized"] is True and end["preempted"] is False


# ---------------------------------------------------------------------------
# stub-child e2e: the real Supervisor loop, seconds-cheap children
# ---------------------------------------------------------------------------

STUB = textwrap.dedent("""\
    import json, os, signal, sys, time
    tdir, state_path, ckpt_dir = sys.argv[1], sys.argv[2], sys.argv[3]
    plan = sys.argv[4].split(",")
    extra = sys.argv[5:]
    n = 0
    if os.path.exists(state_path):
        n = int(open(state_path).read())
    open(state_path, "w").write(str(n + 1))
    with open(os.path.join(tdir, "argv_%d.json" % n), "w") as f:
        json.dump(extra, f)
    with open(os.path.join(tdir, "env_%d.json" % n), "w") as f:
        json.dump({"cache": os.environ.get("MOCO_TPU_CACHE_DIR", "")}, f)
    def beat(step, phase="step"):
        p = os.path.join(tdir, "heartbeat.json")
        with open(p + ".tmp", "w") as f:
            json.dump({"v": 1, "t": round(time.time(), 3), "step": step,
                       "pid": os.getpid(), "phase": phase}, f)
        os.replace(p + ".tmp", p)
    def ckpt(step, devices):
        d = os.path.join(ckpt_dir, str(step))
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(d, "payload.bin"), "wb") as f:
            f.write(b"x" * 64)
        pd = os.path.join(ckpt_dir, ".position")
        os.makedirs(pd, exist_ok=True)
        with open(os.path.join(pd, "%d.json" % step), "w") as f:
            json.dump({"epoch": 0, "batch": step, "devices": devices}, f)
    behavior = plan[min(n, len(plan) - 1)]
    kind, _, arg = behavior.partition(":")
    if kind == "resize49":
        step, devices = (int(x) for x in arg.split("/"))
        signal.signal(signal.SIGUSR2, signal.SIG_IGN)
        beat(step)
        ckpt(step, devices)
        time.sleep(0.6)
        sys.exit(49)
    elif kind == "usr2exit":
        signal.signal(signal.SIGUSR2, lambda *a: sys.exit(49))
        beat(int(arg or 2))
        time.sleep(30)
        sys.exit(1)
    elif kind == "exit":
        beat(2)
        sys.exit(int(arg))
    elif kind == "ok":
        beat(int(arg or 5))
        sys.exit(0)
    else:
        raise SystemExit("unknown stub behavior %r" % behavior)
""")


def _stub_supervisor(tmp_path, plan, argv_extra=(), **sup_kw):
    stub = tmp_path / "stub.py"
    stub.write_text(STUB)
    tdir = tmp_path / "telemetry"
    tdir.mkdir(exist_ok=True)
    ckpt = tmp_path / "ckpt"
    policy = RestartPolicy(
        max_restarts=3, heartbeat_stale_secs=10.0, startup_grace_secs=10.0,
        term_grace_secs=1.0, backoff_base_secs=0.05, backoff_max_secs=0.2,
        backoff_jitter=0.0, poll_secs=0.1,
    )
    return Supervisor(
        [sys.executable, str(stub), str(tdir), str(tmp_path / "attempts"),
         str(ckpt), plan, *argv_extra],
        telemetry_dir=str(tdir), ckpt_dir=str(ckpt), policy=policy, seed=0, **sup_kw,
    ), tdir


def test_e2e_request_file_resize_rewrites_relaunch(tmp_path, monkeypatch):
    """A pending resize.request is armed and consumed, the child's 49
    relaunches with `--num-devices 2` appended (and the environment as it
    was: no cache dir), the mesh_change preflight fires (sidecar 1, argv
    2), and the incident lands as resize events and a `resize` span under
    the child span."""
    monkeypatch.delenv("MOCO_TPU_CACHE_DIR", raising=False)
    sup, tdir = _stub_supervisor(tmp_path, "resize49:4/1,ok:8",
                                 argv_extra=("--num-devices", "1"))
    write_resize_request(str(tdir), devices=2)
    result = sup.run()
    assert result.final_class == CLASS_CLEAN
    assert result.classifications == [CLASS_RESIZE, CLASS_CLEAN]
    assert result.restarts == 1 and not result.gave_up
    assert [r for r in sup.incidents if r["event"] == "backoff"] == []
    requests = [r for r in sup.incidents if r["event"] == "resize_request"]
    assert requests and requests[0]["devices"] == 2
    relaunches = [r for r in sup.incidents if r["event"] == "resize_relaunch"]
    assert len(relaunches) == 1
    assert relaunches[0]["devices_from"] == 1
    assert relaunches[0]["devices_to"] == 2
    changes = [r for r in sup.incidents if r["event"] == "mesh_change"]
    assert changes and (changes[0]["devices_from"], changes[0]["devices_to"]) == (1, 2)
    with open(tdir / "argv_1.json") as f:
        argv1 = json.load(f)
    assert argv1[-4:] == ["--num-devices", "2", "--resume", "auto"]
    for n in (0, 1):
        with open(tdir / f"env_{n}.json") as f:
            assert json.load(f)["cache"] == ""
    spans = read_events_tail(os.path.join(str(tdir), "spans.jsonl"))
    child_ids = {s["span"] for s in spans if s.get("name") == "child"}
    resize_spans = [s for s in spans if s.get("name") == "resize"]
    assert resize_spans and resize_spans[0]["parent"] in child_ids
    assert resize_spans[0]["attrs"]["devices_to"] == 2
    from tools.telemetry_report import summarize

    records = read_events_tail(os.path.join(str(tdir), "events.jsonl"), max_bytes=1 << 20)
    summary = summarize(records)
    assert summary["resize"]["relaunches"] == 1
    assert summary["supervisor"]["classifications"] == ["resize", "clean"]


def test_e2e_sigusr2_resize_without_payload(tmp_path):
    """SIGUSR2 to the SUPERVISOR with no request file: the child is
    signaled (the stub exits 49 from its handler, as the driver's listener
    path does), and the relaunch keeps the argv's own device flag."""
    sup, tdir = _stub_supervisor(tmp_path, "usr2exit:2,ok:9",
                                 argv_extra=("--num-devices", "1"))
    runner = threading.Thread(target=lambda: setattr(sup, "_test_result", sup.run()))
    runner.start()
    time.sleep(0.5)  # child up and beating
    sup.resize.signal_resize()  # what the CLI's SIGUSR2 handler calls
    runner.join(timeout=30)
    assert not runner.is_alive()
    result = sup._test_result
    assert result.final_class == CLASS_CLEAN
    assert result.classifications == [CLASS_RESIZE, CLASS_CLEAN]
    relaunches = [r for r in sup.incidents if r["event"] == "resize_relaunch"]
    assert relaunches and relaunches[0]["devices_to"] is None
    assert relaunches[0]["source"] == "sigusr2"
    with open(tdir / "argv_1.json") as f:
        argv1 = json.load(f)
    assert argv1.count("--num-devices") == 1  # untouched: no target count


def test_e2e_unbootable_resize_reverts_instead_of_dying(tmp_path):
    """A device count above the hardware makes the resized argv exit
    config_error at boot; the supervisor reverts the appended flags and
    finishes the run on the old count."""
    sup, tdir = _stub_supervisor(tmp_path, "resize49:4/1,exit:45,ok:8",
                                 argv_extra=("--num-devices", "1"))
    write_resize_request(str(tdir), devices=100)
    base_len = len(sup.child_argv)
    result = sup.run()
    assert result.final_class == CLASS_CLEAN, result
    assert result.classifications == [CLASS_RESIZE, "config_error", CLASS_CLEAN]
    reverts = [r for r in sup.incidents if r["event"] == "resize_revert"]
    assert reverts and reverts[0]["dropped"] == ["--num-devices", "100"]
    assert len(sup.child_argv) == base_len  # appended flags gone
    with open(tdir / "argv_2.json") as f:
        argv2 = json.load(f)
    assert "100" not in argv2
    from tools.telemetry_report import render, summarize

    summary = summarize(sup.incidents)
    assert summary["resize"]["reverts"] == 1
    assert "1 reverted (unbootable argv)" in render(summary)


def test_resize_relaunch_keeps_the_operators_environment(tmp_path):
    """The JAX supervisor rotates the compile cache at a resize unless the
    operator pinned one; the port has none to rotate (its kernel build is
    atomic and named by its sources' hash), so every launch, the resized
    one too, sees the environment the supervisor was given."""
    sup, tdir = _stub_supervisor(tmp_path, "resize49:4/1,ok:8",
                                 argv_extra=("--num-devices", "1"))
    sup.env = dict(os.environ, MOCO_TPU_CACHE_DIR="/operator/pinned")
    write_resize_request(str(tdir), devices=2)
    assert sup.run().classifications == [CLASS_RESIZE, CLASS_CLEAN]
    for n in (0, 1):
        with open(tdir / f"env_{n}.json") as f:
            assert json.load(f)["cache"] == "/operator/pinned"
    (relaunch,) = [r for r in sup.incidents if r["event"] == "resize_relaunch"]
    assert "cache_dir" not in relaunch


def test_take_path_still_records_the_request(tmp_path):
    """A resize the child honored before the supervisor's poll armed it
    still lands a resize_request record."""
    sup, tdir = _stub_supervisor(tmp_path, "exit:49,ok:8",
                                 argv_extra=("--num-devices", "1"))
    sup.resize._last_poll = float("inf")  # the monitor never arms
    write_resize_request(str(tdir), devices=2)
    result = sup.run()
    assert result.classifications == [CLASS_RESIZE, CLASS_CLEAN]
    requests = [r for r in sup.incidents if r["event"] == "resize_request"]
    assert len(requests) == 1 and requests[0]["devices"] == 2
    from tools.telemetry_report import summarize

    summary = summarize(sup.incidents)
    assert summary["resize"]["requests"] == 1
    assert summary["resize"]["relaunches"] == 1


# ---------------------------------------------------------------------------
# parity with the JAX functions on the same inputs
# ---------------------------------------------------------------------------


def _requests(seed: int) -> list[str]:
    rng = np.random.RandomState(seed)
    texts = ["", "devices=1", "slow=1", "devices=2,slow=1"]
    for _ in range(12):
        parts = []
        if rng.rand() < 0.8:
            parts.append(f"devices={rng.randint(1, 65)}")
        if rng.rand() < 0.5:
            parts.append(f"grad_sync_cadence={rng.randint(1, 9)}")
        if rng.rand() < 0.3:
            parts.append(f"sharding={['dp', 'fsdp', 'fsdp_tp'][rng.randint(3)]}")
        if rng.rand() < 0.4:
            parts.append(f"slow={rng.randint(2)}")
        rng.shuffle(parts)
        texts.append([" ", ","][rng.randint(2)].join(parts))
    return texts + ["devices=0", "device=2", "devices", "sharding=zero3",
                    "grad_sync_cadence=0"]


@pytest.mark.parametrize("seed", range(3))
def test_parse_resize_request_equals_the_jax_parser(seed):
    for text in _requests(seed):
        try:
            want = jresize.parse_resize_request(text)
        except ValueError as e:
            with pytest.raises(ValueError) as got:
                parse_resize_request(text)
            assert str(got.value) == str(e)
            continue
        got = parse_resize_request(text)
        assert (got.devices, got.grad_sync_cadence, got.sharding, got.slow, got.source) == \
            (want.devices, want.grad_sync_cadence, want.sharding, want.slow, want.source)


def _argvs(seed: int) -> list[list[str]]:
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(20):
        argv = ["python", "-m", "train"]
        for _ in range(rng.randint(0, 4)):
            n = str(rng.randint(-1, 9)) if rng.rand() < 0.9 else "x"
            form = rng.randint(3)
            argv += (["--num-devices", n] if form == 0 else [f"--num-devices={n}"]
                     if form == 1 else ["--batch-size", n])
        out.append(argv)
    return out + [["--num-devices"], []]


@pytest.mark.parametrize("seed", range(3))
def test_argv_device_count_equals_the_jax_function(seed):
    for argv in _argvs(seed):
        assert argv_device_count(argv) == jresize.argv_device_count(argv), argv
        assert pick_device_flag(argv) == jresize.pick_device_flag(argv) == "--num-devices"


@pytest.mark.parametrize("seed", range(3))
def test_controller_apply_equals_the_jax_controller(seed, tmp_path):
    """The same requests through both controllers (the JAX one without its
    cache rotation): the same argv appends and summaries."""
    rng = np.random.RandomState(seed)
    slow = int(rng.randint(0, 6))
    ours = ResizeController(str(tmp_path / "port"), slow_cadence=slow)
    theirs = jresize.ResizeController(str(tmp_path / "jax"), slow_cadence=slow,
                                      rotate_cache=False)
    for text in _requests(seed)[:-5]:
        base = _argvs(seed + 10)[rng.randint(20)]
        a, b = list(base), list(base)
        sa = ours.apply(parse_resize_request(text), a)
        sb = theirs.apply(jresize.parse_resize_request(text), b, {})
        assert a == b and sa == sb, text
    assert ours.resizes_applied == theirs.resizes_applied


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------


def _alive(pid: int) -> bool:
    """Running (a zombie, reaped by nobody here, counts as gone)."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except OSError:
        return False


def test_sigkilled_launcher_leaves_no_rank_alive(tmp_path):
    """Two gloo ranks of a long run: once both step, SIGKILL the launcher;
    the kernel's parent-death signal ends both within 10 s."""
    tdir = tmp_path / "tel"
    launcher = subprocess.Popen(
        [sys.executable, "-m", "moco_tpu_torch.train", *TINY, "--num-devices", "2",
         "--max-steps", "100000", "--steps-per-epoch", "1000", "--epochs", "1000",
         "--telemetry-dir", str(tdir), "--heartbeat-secs", "0"],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=dict(os.environ, OMP_NUM_THREADS="1"))
    try:
        line = ""
        while "[launch]" not in line:
            line = launcher.stdout.readline()
            assert line, "the launcher ended before it started its ranks"
        pids = json.loads(line[line.index("pids ") + 5:].strip())
        assert len(pids) == 2 and all(_alive(p) for p in pids)
        deadline = time.monotonic() + 90
        while time.monotonic() < deadline:
            try:
                with open(tdir / "heartbeat.json") as f:
                    if json.load(f).get("phase") == "step":
                        break
            except (OSError, ValueError):
                pass
            time.sleep(0.1)
        else:
            pytest.fail("the ranks never stepped")
        launcher.kill()
        launcher.wait()
        gone_by = time.monotonic() + 10
        while any(_alive(p) for p in pids) and time.monotonic() < gone_by:
            time.sleep(0.1)
        assert not any(_alive(p) for p in pids)
    finally:
        launcher.kill()
        launcher.stdout.close()


RANK_STUB = textwrap.dedent("""\
    import os, signal, sys, time
    from moco_tpu_torch.parallel.launch import join_launcher
    join_launcher()
    rank = int(os.environ["RANK"])
    behavior = sys.argv[1].split(",")[rank]
    if behavior == "wait":       # a rank blocked in a collective that never completes
        signal.signal(signal.SIGTERM, signal.SIG_IGN)
        time.sleep(120)
    elif behavior.startswith("sleep"):  # a rank outside any resize listener
        time.sleep(float(behavior[5:]))
    elif behavior == "segv":
        time.sleep(0.3)
        os.kill(os.getpid(), signal.SIGSEGV)
    else:
        time.sleep(0.3)
        sys.exit(int(behavior))
""")


def _stub_launcher(tmp_path, behaviors: str) -> subprocess.CompletedProcess:
    stub = tmp_path / "rank.py"
    stub.write_text(RANK_STUB)
    code = ("import sys; from moco_tpu_torch.parallel.launch import launch, exit_with; "
            f"exit_with(launch(2, [{behaviors!r}], command=[sys.executable, {str(stub)!r}], "
            "exit_grace_secs=0.5, term_grace_secs=0.5))")
    return subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=60, env=dict(os.environ, PYTHONPATH=ROOT))


def test_one_rank_exiting_alone_ends_the_others_with_its_code(tmp_path):
    """Rank 1 exits 43 while rank 0 waits in a collective and ignores
    SIGTERM: SIGTERM, then SIGKILL, and the launcher exits 43."""
    t0 = time.monotonic()
    proc = _stub_launcher(tmp_path, "wait,43")
    assert proc.returncode == 43, proc.stdout + proc.stderr
    assert "sending SIGTERM" in proc.stdout and "SIGKILL" in proc.stdout
    assert time.monotonic() - t0 < 30
    assert _stub_launcher(tmp_path, "46,46").returncode == 46  # the shared code


def test_forwarded_sigusr2_never_kills_a_rank_outside_its_listener(tmp_path):
    """A resize request forwarded while a rank starts or writes its
    checkpoint (no listener installed) is ignored, not fatal."""
    stub = tmp_path / "rank.py"
    stub.write_text(RANK_STUB)
    code = ("import sys; from moco_tpu_torch.parallel.launch import launch, exit_with; "
            f"exit_with(launch(2, ['sleep2,sleep2'], command=[sys.executable, {str(stub)!r}]))")
    proc = subprocess.Popen([sys.executable, "-c", code], cwd=ROOT, text=True,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            env=dict(os.environ, PYTHONPATH=ROOT))
    time.sleep(1.0)
    proc.send_signal(signal.SIGUSR2)
    out, _ = proc.communicate(timeout=60)
    assert proc.returncode == 0, out
    assert "rank exit codes [0, 0]" in out


def test_shared_chaos_markers_fire_in_exactly_one_process(tmp_path):
    """The ranks of a group share `MOCO_TPU_CHAOS_STATE`: racing for the same
    fault, exactly one fires it, and concurrent resize requests never trip
    over each other's temporary files."""
    code = textwrap.dedent(f"""
        import sys, time
        from moco_tpu_torch.resilience.chaos import ChaosPlan
        from moco_tpu_torch.resilience.resize import write_resize_request
        time.sleep(max(float(sys.argv[1]) - time.time(), 0))
        plan = ChaosPlan(resize_at_step=3, resize_devices=2, state_dir={str(tmp_path / "m")!r})
        fired = plan.maybe_resize(3)
        for _ in range(50):
            write_resize_request({str(tmp_path / "tel")!r}, devices=2)
        print(fired)
    """)
    start = str(time.time() + 3.0)
    procs = [subprocess.Popen([sys.executable, "-c", code, start], cwd=ROOT, text=True,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              env=dict(os.environ, PYTHONPATH=ROOT)) for _ in range(6)]
    outs = [p.communicate(timeout=60) for p in procs]
    assert all(p.returncode == 0 for p in procs), [e for _, e in outs]
    assert sorted(o.split()[-1] for o, _ in outs) == ["2"] + ["None"] * 5
    assert read_honored_request(str(tmp_path / "tel")) is None
    assert consume_resize_request(str(tmp_path / "tel")).devices == 2


def test_rank_sigsegv_is_the_launchers_signal_death(tmp_path):
    proc = _stub_launcher(tmp_path, "wait,segv")
    assert proc.returncode == -int(signal.SIGSEGV), proc.stdout + proc.stderr
    assert classify_exit(proc.returncode)[0] == "native_crash"


def test_num_devices_on_cuda_without_a_card_exits_45():
    proc = _cli(*TINY[:-4], "--device", "cuda", "--num-devices", "2", "--max-steps", "1")
    assert proc.returncode == EXIT_CONFIG_ERROR, proc.stderr[-2000:]
    assert "[exit] device config error" in proc.stdout


# ---------------------------------------------------------------------------
# the driver's device checks and the 8-card preset
# ---------------------------------------------------------------------------


def test_cuda_asked_for_and_absent_exits_45():
    proc = _cli("--device", "cuda", "--max-steps", "1")
    assert proc.returncode == EXIT_CONFIG_ERROR, proc.stderr[-2000:]
    assert "CUDA was requested" in proc.stdout


@pytest.mark.parametrize("env, match", [
    (dict(WORLD_SIZE="4", RANK="3", LOCAL_RANK="3"), "LOCAL_RANK 3 names no card"),
    (dict(WORLD_SIZE="2", RANK="2", LOCAL_RANK="0"), "rank 2 outside a world of 2"),
    (dict(WORLD_SIZE="2"), "RANK is not set"),
])
def test_a_world_the_host_cannot_give_exits_45(env, match, monkeypatch, capsys):
    """On a host that has one card (the CUDA queries patched so): a
    `LOCAL_RANK` with no card, a rank outside the world, a world without a
    rank all exit 45 before any rendezvous."""
    from moco_tpu_torch import train

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    for k in ("RANK", "LOCAL_RANK", "WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    with pytest.raises(SystemExit) as e:
        train.main(["--max-steps", "1"])
    assert e.value.code == EXIT_CONFIG_ERROR
    assert match in capsys.readouterr().out


def test_num_devices_above_the_cards_or_under_torchrun_exits_45(monkeypatch, capsys):
    from moco_tpu_torch import train

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    for k in ("RANK", "LOCAL_RANK", "WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(SystemExit) as e:
        train.main(["--num-devices", "3"])
    assert e.value.code == EXIT_CONFIG_ERROR
    assert "--num-devices 3 but this host has 2" in capsys.readouterr().out
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(SystemExit) as e:
        train.main(["--num-devices", "2", "--device", "cpu"])
    assert e.value.code == EXIT_CONFIG_ERROR
    assert "under torchrun" in capsys.readouterr().out


def test_imagenet_moco_v2_8chip_is_imagenet_moco_v2_but_its_name():
    from moco_tpu.config import get_preset as jax_get_preset
    from moco_tpu_torch.config import get_preset

    got, base = get_preset("imagenet-moco-v2-8chip"), get_preset("imagenet-moco-v2")
    assert got.name == "imagenet-moco-v2-8chip"
    assert got.replace(name=base.name) == base
    want = jax_get_preset("imagenet-moco-v2-8chip")
    fields = [f for f in got.__dataclass_fields__ if f != "ckpt_dir"]
    assert {f: getattr(got, f) for f in fields} == {f: getattr(want, f) for f in fields}
    proc = _cli("--preset", "imagenet-moco-v2-8chip", "--device", "cuda")
    assert proc.returncode == EXIT_CONFIG_ERROR  # accepted; no card here
    assert "device config error" in proc.stdout
