"""Supervised drills on the CPU with real children: `python -m
moco_tpu_torch.supervise -- python -m moco_tpu_torch.train ...` at the tiny
configuration of `tests/test_torch_distributed.py` (`resnet_tiny`, 32 px,
B=16, K=64), each drill (its uninterrupted reference included) under a time
limit of its own, after which its whole process group is killed.

- `kill_at_step`: the child SIGKILLs itself after step 3; the supervisor
  classifies `killed`, relaunches with `--resume auto` from the step-2
  checkpoint, and every step's loss equals the uninterrupted run's bit for
  bit.
- 1 -> 2 -> 1: chaos `resize_at_step=2,devices=2` ends the one-process leg
  with an elastic checkpoint and exit 49; the supervisor relaunches with
  `--num-devices 2` (two gloo ranks under the launcher); an operator's
  `resize.request devices=1`, dropped while that leg steps, reaches the
  ranks as the launcher's forwarded SIGUSR2 and ends it the same way; the
  last leg runs alone to the end. The classifications are `[resize,
  resize, clean]`. The losses of steps 1-2, before the first hop, equal
  the uninterrupted run's bit for bit. Tolerance, fixed before the first
  run: the final loss within 5% of the uninterrupted run's, the JAX
  drill's bound (`tests/test_resize.py`). The drill runs without
  `sync_bn` (the port has none yet), so the two-rank leg's BatchNorm
  statistics are each rank's 8 samples, not the 16 of a one-process step,
  and its steps differ from the reference by more than float noise.
"""

import json
import os
import signal
import subprocess
import sys
import time

import pytest

from moco_tpu_torch.resilience.resize import write_resize_request
from moco_tpu_torch.resilience.supervisor import read_events_tail

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DRILL_LIMIT_S = 120.0

TINY = ["--preset", "imagenet-moco-v2", "--dataset", "synthetic", "--arch", "resnet_tiny",
        "--image-size", "32", "--batch-size", "16", "--num-negatives", "64",
        "--embed-dim", "16", "--device", "cpu", "--knn-monitor", "false",
        "--print-freq", "1", "--heartbeat-secs", "0", "--telemetry-flush-steps", "1",
        "--resilience-sync-steps", "1", "--watchdog-secs", "0"]


class Drill:
    """Processes of one drill, all in new sessions, under one deadline."""

    def __init__(self, tmp_path):
        self.deadline = time.monotonic() + DRILL_LIMIT_S
        self.tmp = tmp_path
        self.procs: list[subprocess.Popen] = []

    def env(self, **extra) -> dict:
        env = dict(os.environ, OMP_NUM_THREADS="1")
        for k in ("MOCO_TPU_CHAOS", "MOCO_TPU_CHAOS_STATE", "WORLD_SIZE", "RANK",
                  "LOCAL_RANK"):
            env.pop(k, None)
        env.update(extra)
        return env

    def start(self, argv: list[str], log: str, env: dict) -> subprocess.Popen:
        out = open(self.tmp / log, "w")
        proc = subprocess.Popen([sys.executable, "-m", *argv], cwd=ROOT, env=env,
                                stdout=out, stderr=subprocess.STDOUT, start_new_session=True)
        out.close()
        self.procs.append(proc)
        return proc

    def wait(self, proc: subprocess.Popen) -> int:
        try:
            return proc.wait(timeout=max(self.deadline - time.monotonic(), 0.1))
        except subprocess.TimeoutExpired:
            pytest.fail(f"the drill outlasted {DRILL_LIMIT_S} s")

    def close(self) -> None:
        for proc in self.procs:
            try:
                os.killpg(proc.pid, signal.SIGKILL)
            except OSError:
                pass  # the group already ended
            proc.wait()


@pytest.fixture
def drill(tmp_path):
    d = Drill(tmp_path)
    yield d
    d.close()


def _train_argv(tdir, ckpt, *extra) -> list[str]:
    return ["moco_tpu_torch.train", *TINY, "--telemetry-dir", str(tdir),
            "--ckpt-dir", str(ckpt), *extra]


def _supervise_argv(tdir, ckpt, child: list[str], **policy) -> list[str]:
    knobs = dict(max_restarts=3, heartbeat_stale_secs=30.0, startup_grace_secs=60.0,
                 term_grace_secs=5.0, backoff_base_secs=0.1, backoff_max_secs=0.5,
                 poll_secs=0.1)
    knobs.update(policy)
    flags = [x for k, v in knobs.items() for x in ("--" + k.replace("_", "-"), str(v))]
    return ["moco_tpu_torch.supervise", "--telemetry-dir", str(tdir), "--ckpt-dir",
            str(ckpt), *flags, "--", sys.executable, "-m", *child]


def _losses(tdir) -> list[tuple[int, float]]:
    """(step, loss) of every step record, in the stream's order."""
    return [(int(r["step"]), float(r["loss"]))
            for r in read_events_tail(os.path.join(str(tdir), "events.jsonl"),
                                      max_bytes=1 << 24)
            if r.get("kind") == "step" and "loss" in r]


def _supervisor_records(tdir, event: str) -> list[dict]:
    return [r for r in read_events_tail(os.path.join(str(tdir), "events.jsonl"),
                                        max_bytes=1 << 24)
            if r.get("kind") == "supervisor" and r.get("event") == event]


def _reference(drill, tmp_path, *extra) -> dict[int, float]:
    ref_t, ref_ck = tmp_path / "ref_tel", tmp_path / "ref_ck"
    proc = drill.start(_train_argv(ref_t, ref_ck, *extra), "ref.log", drill.env())
    assert drill.wait(proc) == 0, (tmp_path / "ref.log").read_text()[-3000:]
    return dict(_losses(ref_t))


@pytest.mark.chaos
def test_supervised_kill_at_step_is_relaunched_bit_for_bit(drill, tmp_path):
    run = ("--steps-per-epoch", "2", "--epochs", "3")
    ref = _reference(drill, tmp_path, *run)
    assert sorted(ref) == [1, 2, 3, 4, 5, 6]
    tdir, ck = tmp_path / "tel", tmp_path / "ck"
    env = drill.env(MOCO_TPU_CHAOS="kill_at_step=3",
                    MOCO_TPU_CHAOS_STATE=str(tmp_path / "chaos"))
    sup = drill.start(_supervise_argv(tdir, ck, _train_argv(tdir, ck, *run)), "sup.log", env)
    assert drill.wait(sup) == 0, (tmp_path / "sup.log").read_text()[-3000:]
    exits = _supervisor_records(tdir, "exit")
    assert [r["classification"] for r in exits] == ["killed", "clean"]
    assert exits[0]["returncode"] == -int(signal.SIGKILL)
    launches = _supervisor_records(tdir, "launch")
    assert all(r["argv"][-2:] == ["--resume", "auto"] for r in launches)
    got = _losses(tdir)
    # steps 1-3 of the killed child, then 3-6 of the relaunch from step 2
    assert [s for s, _ in got] == [1, 2, 3, 3, 4, 5, 6]
    for step, loss in got:
        assert loss == ref[step], (step, loss, ref[step])


@pytest.mark.chaos
def test_supervised_resize_1_2_1(drill, tmp_path):
    run = ("--steps-per-epoch", "4", "--epochs", "4")
    ref = _reference(drill, tmp_path, *run)
    assert sorted(ref) == list(range(1, 17))
    tdir, ck = tmp_path / "tel", tmp_path / "ck"
    tdir.mkdir()
    # the slow step (fire-once across the relaunches; the one-process leg
    # ends at step 2, so the two-rank leg meets it) holds that leg open
    # while the operator's request goes in
    env = drill.env(MOCO_TPU_CHAOS="resize_at_step=2,devices=2,slow_at_step=5,slow_ms=6000",
                    MOCO_TPU_CHAOS_STATE=str(tmp_path / "chaos"))
    child = _train_argv(tdir, ck, *run, "--num-devices", "1")
    sup = drill.start(_supervise_argv(tdir, ck, child), "sup.log", env)
    hb_path = tdir / "heartbeat.json"
    while sup.poll() is None:
        assert time.monotonic() < drill.deadline, "the two-rank leg never stepped"
        try:
            with open(hb_path) as f:
                hb = json.load(f)
            if hb.get("phase") == "step" and int(hb.get("step", 0)) > 2:
                break
        except (OSError, ValueError):
            pass
        time.sleep(0.05)
    write_resize_request(str(tdir), devices=1)
    assert drill.wait(sup) == 0, (tmp_path / "sup.log").read_text()[-3000:]
    exits = _supervisor_records(tdir, "exit")
    assert [r["classification"] for r in exits] == ["resize", "resize", "clean"]
    relaunches = _supervisor_records(tdir, "resize_relaunch")
    assert [(r["devices_from"], r["devices_to"]) for r in relaunches] == [(1, 2), (2, 1)]
    changes = _supervisor_records(tdir, "mesh_change")
    assert [(r["devices_from"], r["devices_to"]) for r in changes] == [(1, 2), (2, 1)]
    log = (tdir / "child.log").read_text()
    # the second hop: the supervisor's SIGUSR2, forwarded by the launcher
    assert log.count("[resize] caught SIGUSR2") == 2
    assert log.count("[exit] resize honored") == 1 + 2  # the lone leg, then both ranks
    assert "[exit] the 2 ranks ended; the launcher exits 49" in log
    got = _losses(tdir)
    assert [s for s, _ in got][:2] == [1, 2] and got[-1][0] == 16
    for step, loss in got[:2]:
        assert loss == ref[step], (step, loss, ref[step])
    final = got[-1][1]
    assert abs(final - ref[16]) <= 0.05 * abs(ref[16]), (final, ref[16])
