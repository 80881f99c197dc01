"""Out-of-process run supervisor (the port's own copy of
`moco_tpu/resilience/supervisor.py`: the same failure classes, policy,
incident records and event names, so `tools/telemetry_report.py` renders a
port run's supervisor and resize sections unchanged).

The driver survives every fault it can OBSERVE (`train.py`: the rollback,
the emergency checkpoint, the watchdog); this module closes the loop for
the ones it cannot: a SIGKILL-grade preemption, a segfault in the native
staging loader or the CUDA runtime, an OOM-killed process, and the silence
of a wedged NCCL collective. The `Supervisor` runs the training driver
(`python -m moco_tpu_torch.train`, with `--num-devices N` its own rank
launcher) as a child process and:

1. detects HANGS by polling `heartbeat.json` staleness (the every-step,
   time-gated beat from telemetry) and kills wedged children with a
   SIGTERM → grace → SIGKILL escalation — SIGTERM first, because a merely
   slow child still gets its emergency-checkpoint exit;
2. CLASSIFIES each death from the structured exit-code protocol
   (resilience/exitcodes.py), the death signal, and an `events.jsonl` tail
   forensic pass (OOM suspicion from the last RSS samples, native-loader
   frames);
3. applies a PER-CLASS restart policy: fatal classes (clean finish,
   rollback exhausted, config error, data quality) never restart;
   restartable classes draw on a budget with exponential backoff + jitter,
   and the budget is REFUNDED whenever the child made step progress since
   its last launch (read from the heartbeat / checkpoint sidecars) — so a
   run that keeps advancing restarts indefinitely while a crash loop
   exhausts the budget in `max_restarts` tries;
4. runs a resume-integrity PREFLIGHT before each relaunch: every
   checkpoint step that fails its integrity manifest is quarantined out of the
   directory, so a corrupt emergency checkpoint cannot crash-loop the
   child through `--resume auto`;
5. records every lifecycle event (launch, kill, exit classification,
   backoff, budget state, give-up) as structured `kind: "supervisor"`
   records appended to the child's own events.jsonl — one stream, rendered
   by tools/telemetry_report.py.

The CLI wrapper is `python -m moco_tpu_torch.supervise`. Everything here is
stdlib: the supervisor imports no torch (it has to stay alive and small
while the child runs the host or the card out of memory).
"""

from __future__ import annotations

import dataclasses
import json
import os
import random
import signal
import subprocess
import time

from moco_tpu_torch.resilience.exitcodes import (
    EXIT_CODE_NAMES,
    EXIT_CONFIG_ERROR,
    EXIT_DATA_QUALITY,
    EXIT_FLEET_BIND,
    EXIT_OK,
    EXIT_PREEMPTED,
    EXIT_RESIZE,
    EXIT_ROLLBACK_EXHAUSTED,
    EXIT_SERVE_BIND,
    EXIT_STAGING_BIND,
    USAGE_ERROR,
)
from moco_tpu_torch.resilience.resize import (
    ResizeController,
    argv_device_count,
    read_recorded_devices,
)
# stdlib by contract (the lazy telemetry __init__ keeps this import free of
# torch and numpy): the supervisor is the trace ROOT; it mints the run id,
# stamps the child's env, and its launch/kill spans join the same timeline
# the child writes
from moco_tpu_torch.telemetry.trace import Tracer
from moco_tpu_torch.utils.logging import log_event

EVENTS_FILENAME = "events.jsonl"
HEARTBEAT_FILENAME = "heartbeat.json"
QUARANTINE_DIRNAME = ".quarantine"

# -- failure classes ---------------------------------------------------------
# the supervisor's whole vocabulary: every child death maps to exactly one
CLASS_CLEAN = "clean"                          # ran to the configured end
CLASS_PREEMPTED = "preempted"                  # honored SIGTERM, ckpt written
CLASS_ROLLBACK_EXHAUSTED = "rollback_exhausted"  # structural divergence
CLASS_CONFIG_ERROR = "config_error"            # same argv can never succeed
CLASS_DATA_QUALITY = "data_quality"            # dataset itself is bad
CLASS_HANG = "hang"                            # supervisor killed a stale child
CLASS_NATIVE_CRASH = "native_crash"            # SIGSEGV/SIGABRT/SIGBUS/...
CLASS_OOM = "oom"                              # SIGKILL + high tail RSS
CLASS_KILLED = "killed"                        # external SIGKILL/SIGTERM death
CLASS_CRASH = "crash"                          # any other nonzero exit
CLASS_SERVE_BIND = "serve_bind"                # serve.py couldn't bind its port
CLASS_FLEET_BIND = "fleet_bind"                # serve_fleet.py couldn't bind
                                               # its front-end router port
CLASS_RESIZE = "resize"                        # elastic checkpoint written;
                                               # relaunch onto the new number
                                               # of cards
CLASS_STAGING_BIND = "staging_bind"            # staging_server.py (or its
                                               # decode worker) couldn't bind
                                               # its health/data port:
                                               # reschedule, don't race the
                                               # socket

# classes where restarting can never help — the run is OVER
FATAL_CLASSES = frozenset({
    CLASS_CLEAN, CLASS_ROLLBACK_EXHAUSTED, CLASS_CONFIG_ERROR,
    CLASS_DATA_QUALITY, CLASS_SERVE_BIND, CLASS_FLEET_BIND,
    CLASS_STAGING_BIND,
})
RESTARTABLE_CLASSES = frozenset({
    CLASS_PREEMPTED, CLASS_HANG, CLASS_NATIVE_CRASH, CLASS_OOM,
    CLASS_KILLED, CLASS_CRASH, CLASS_RESIZE,
})

_CRASH_SIGNALS = {
    int(getattr(signal, name))
    for name in ("SIGSEGV", "SIGABRT", "SIGBUS", "SIGILL", "SIGFPE")
    if hasattr(signal, name)
}


# -- forensics ---------------------------------------------------------------


def read_events_tail(path: str, max_bytes: int = 1 << 16) -> list[dict]:
    """Parse the last `max_bytes` of an events.jsonl (torn first/last lines
    skipped — the file may have died mid-flush with its writer)."""
    try:
        size = os.path.getsize(path)
        with open(path, "rb") as f:
            if size > max_bytes:
                f.seek(size - max_bytes)
                f.readline()  # drop the (likely) partial first line
            raw = f.read()
    except OSError:
        return []
    records = []
    for line in raw.decode("utf-8", errors="replace").splitlines():
        line = line.strip()
        if not line:
            continue
        try:
            rec = json.loads(line)
        except json.JSONDecodeError:
            continue
        if isinstance(rec, dict):
            records.append(rec)
    return records


def tail_rss_bytes(records: list[dict]) -> float:
    """Last host-RSS sample in a record tail (0.0 when none): the OOM
    forensic — a SIGKILL that follows samples near the host's memory is the
    kernel's OOM killer, not a preemption."""
    for rec in reversed(records):
        if rec.get("kind") in ("step", "pod"):
            rss = rec.get("host_rss_bytes", rec.get("host_rss_bytes_max"))
            if rss is not None:
                try:
                    return float(rss)
                except (TypeError, ValueError):
                    return 0.0
    return 0.0


def read_heartbeat(path: str) -> dict | None:
    """Parse heartbeat.json; None when absent/torn (the write is atomic, so
    torn means no heartbeat was ever completed)."""
    try:
        with open(path, encoding="utf-8") as f:
            payload = json.load(f)
    except (OSError, json.JSONDecodeError):
        return None
    return payload if isinstance(payload, dict) else None


def beat_marker(hb: dict):
    """Change-detection key for one heartbeat payload: the writer-side
    monotonic `seq` when present — a wall
    step can make two distinct beats stamp the same `t` (backwards jump)
    and silently mask progress — else the wall stamp for old payloads.
    Tagged so a `seq` value can never compare equal to a `t` value."""
    seq = hb.get("seq")
    if isinstance(seq, int) and not isinstance(seq, bool):
        return ("seq", seq)
    return ("t", hb.get("t"))


# how far the writer's (wall − mono) clock offset may differ from the
# reader's before the two monotonic clocks are judged incomparable
# (different host, or a wall step since the beat was written)
_SAME_BOOT_SKEW_S = 5.0


def beat_is_fresh(hb: dict, launched_wall: float,
                  launched_mono: float) -> bool:
    """Was this beat written after OUR launch? Prefers the monotonic
    `mono_s` (CLOCK_MONOTONIC — shared by every process on a host, so it
    orders a same-host child's write against the supervisor's launch
    without consulting the steppable wall clock): a backward wall jump
    can no longer unfresh a live child's beats. The mono comparison is
    used only when the beat's own (t − mono_s) offset agrees with this
    process's current offset — same boot, no wall step since the write —
    because CLOCK_MONOTONIC is meaningless across hosts: a wrapper
    child (srun) beating from ANOTHER node over a shared filesystem
    keeps the wall-clock semantics that worked for it before the pair
    existed. Old payloads without the pair fall back to wall `t`."""
    mono = hb.get("mono_s")
    t = hb.get("t")
    wall_ok = isinstance(t, (int, float)) and not isinstance(t, bool)
    if (isinstance(mono, (int, float)) and not isinstance(mono, bool)
            and wall_ok):
        offset_writer = t - mono
        offset_reader = time.time() - time.monotonic()
        if abs(offset_writer - offset_reader) <= _SAME_BOOT_SKEW_S:
            return mono > launched_mono
    return wall_ok and t > launched_wall


def classify_exit(
    returncode: int,
    *,
    hang_killed: bool = False,
    events_tail: list[dict] | None = None,
    oom_rss_bytes: float = 0.0,
) -> tuple[str, str]:
    """(failure class, human-readable detail) for one child death.

    `hang_killed`: the supervisor itself ended this child for heartbeat
    staleness — that classification wins over the exit code, because a
    SIGTERM-responsive child exits EXIT_PREEMPTED on the way down and would
    otherwise masquerade as an ordinary preemption."""
    if hang_killed:
        return CLASS_HANG, (
            f"killed by supervisor for heartbeat staleness (exited "
            f"{returncode})"
        )
    named = {
        EXIT_OK: CLASS_CLEAN,
        EXIT_PREEMPTED: CLASS_PREEMPTED,
        EXIT_ROLLBACK_EXHAUSTED: CLASS_ROLLBACK_EXHAUSTED,
        EXIT_CONFIG_ERROR: CLASS_CONFIG_ERROR,
        EXIT_DATA_QUALITY: CLASS_DATA_QUALITY,
        # relaunching the same argv races the same occupied socket: the
        # orchestrator one level up must reschedule, not retry-loop
        EXIT_SERVE_BIND: CLASS_SERVE_BIND,
        EXIT_FLEET_BIND: CLASS_FLEET_BIND,
        EXIT_STAGING_BIND: CLASS_STAGING_BIND,
        EXIT_RESIZE: CLASS_RESIZE,
        USAGE_ERROR: CLASS_CONFIG_ERROR,
    }
    if returncode in named:
        return named[returncode], (
            f"exit {returncode} ({EXIT_CODE_NAMES.get(returncode, '?')})"
        )
    if returncode < 0:
        sig = -returncode
        try:
            signame = signal.Signals(sig).name
        except ValueError:
            signame = f"signal {sig}"
        if sig in _CRASH_SIGNALS:
            return CLASS_NATIVE_CRASH, (
                f"died on {signame}: native crash (staging loader / CUDA "
                "runtime)"
            )
        if sig == int(signal.SIGKILL):
            rss = tail_rss_bytes(events_tail or [])
            if oom_rss_bytes > 0 and rss >= oom_rss_bytes:
                return CLASS_OOM, (
                    f"SIGKILL with tail RSS {rss / 2**30:.2f} GiB >= the "
                    f"{oom_rss_bytes / 2**30:.2f} GiB OOM threshold"
                )
            return CLASS_KILLED, (
                "SIGKILL from outside (hard preemption or OOM killer; tail "
                f"RSS {rss / 2**30:.2f} GiB)"
            )
        return CLASS_KILLED, f"died on external {signame}"
    return CLASS_CRASH, f"unrecognized exit {returncode} (python traceback?)"


# -- resume-integrity preflight ---------------------------------------------


def preflight_resume(ckpt_dir: str, emit=None) -> list[int]:
    """Quarantine every checkpoint step that fails its integrity manifest
    BEFORE relaunching the child, so `--resume auto` never even sees a
    corrupt emergency checkpoint. (The child's own restore walks back past
    corrupt steps too — but a restore crash inside a freshly-launched
    child costs a whole restart out of the budget; here it costs a rename.)

    Newest-first, stopping at the first step that verifies: `--resume
    auto` only ever restores the newest surviving candidate, so hashing
    the older steps too would add minutes of sha256 I/O (multi-GB states ×
    max_to_keep) to every relaunch — including the no-backoff preemption
    relaunches that are supposed to be immediate. A corrupt step BEHIND a
    verifying one is unreachable except through the child's own
    restore-time walk-back, which re-verifies per candidate anyway.

    Steps are moved to `<ckpt_dir>/.quarantine/<step>` (dot-prefixed:
    invisible to Orbax's step listing) with their sidecars; manifest-less
    steps are left alone — pre-manifest checkpoints stay restorable, the
    restore itself is then the gate. Returns the quarantined step numbers."""
    from moco_tpu_torch.resilience.integrity import (
        manifest_path,
        position_path,
        verify_step,
    )

    quarantined: list[int] = []
    try:
        names = os.listdir(ckpt_dir)
    except OSError:
        return quarantined
    for name in sorted((n for n in names if n.isdigit()), key=int,
                       reverse=True):
        step = int(name)
        reason = verify_step(ckpt_dir, step)
        if reason is None:
            break  # newest surviving candidate: the only one resume reads
        qdir = os.path.join(ckpt_dir, QUARANTINE_DIRNAME)
        os.makedirs(qdir, exist_ok=True)
        target = os.path.join(qdir, name)
        if os.path.exists(target):  # quarantined twice across restarts
            target = os.path.join(qdir, f"{name}.{int(time.time())}")
        os.rename(os.path.join(ckpt_dir, name), target)
        for sidecar in (
            manifest_path(ckpt_dir, step),
            position_path(ckpt_dir, step),
        ):
            try:
                os.remove(sidecar)
            except OSError:
                pass  # sidecar absent (pre-position checkpoint) — fine
        quarantined.append(step)
        if emit is not None:
            emit("preflight_quarantine", step=step, reason=reason,
                 moved_to=target)
        log_event(
            "supervisor",
            f"preflight: quarantined corrupt checkpoint step {step} "
            f"({reason}) -> {target}",
        )
    return quarantined


# -- policy ------------------------------------------------------------------


@dataclasses.dataclass
class RestartPolicy:
    """Per-class restart policy knobs (`moco_tpu_torch.supervise` exposes
    each)."""

    max_restarts: int = 5             # consecutive no-progress restarts
                                      # before giving up; any step progress
                                      # refunds the full budget
    backoff_base_secs: float = 1.0    # exponential backoff base ...
    backoff_max_secs: float = 60.0    # ... capped here ...
    backoff_jitter: float = 0.2       # ... times (1 + U[0, jitter]) so a
                                      # pod of supervisors doesn't relaunch
                                      # in lockstep
    heartbeat_stale_secs: float = 120.0  # kill the child when its newest
                                      # step-phase beat is older than this.
                                      # <= 0 disables hang detection
                                      # entirely (exit classification and
                                      # restarts still run) — REQUIRED for
                                      # supervisors of non-main pod hosts,
                                      # which never write a heartbeat
                                      # (telemetry is process-0-only) and
                                      # would otherwise be killed as
                                      # "hung" on a cycle
    startup_grace_secs: float = 900.0  # staleness allowance before the
                                      # first step-phase beat of each
                                      # launch (imports, kernel load, restore
                                      # legitimately produce no steps)
    term_grace_secs: float = 30.0     # SIGTERM -> this grace -> SIGKILL
    poll_secs: float = 2.0            # supervisor wake-up cadence
    oom_rss_bytes: float = 0.0        # classify SIGKILL as OOM when the
                                      # events tail shows RSS >= this (0 =
                                      # never; there is no portable way to
                                      # read the cgroup limit from here)
    restart_on: frozenset = RESTARTABLE_CLASSES
    no_backoff: frozenset = frozenset({CLASS_PREEMPTED, CLASS_RESIZE})
                                      # a preempted VM that came back is
                                      # healthy — relaunch immediately; a
                                      # resize exit is VOLUNTARY (the child
                                      # checkpointed on request) — backoff
                                      # would just stretch the capacity gap

    def backoff_secs(self, consecutive_failures: int, rng: random.Random) -> float:
        """Exponential in the number of consecutive no-progress failures,
        capped, with multiplicative jitter."""
        base = min(
            self.backoff_base_secs * (2.0 ** max(consecutive_failures - 1, 0)),
            self.backoff_max_secs,
        )
        return base * (1.0 + self.backoff_jitter * rng.random())


@dataclasses.dataclass
class SupervisorResult:
    final_class: str
    exit_code: int | None
    launches: int               # total child launches (restarts + 1)
    restarts: int
    gave_up: bool               # budget exhausted with the run unfinished
    classifications: list[str]  # one per child death, in order


class Supervisor:
    """Run `child_argv` under supervision until it finishes or the policy
    gives up. `telemetry_dir` must match the child's `--telemetry-dir`
    (heartbeat + events live there); `ckpt_dir` (the child's `--ckpt-dir`)
    enables the resume preflight and the checkpoint-step progress fallback.

    On every launch (the first included — a restarted supervisor over an
    existing ckpt_dir must continue the run, not retrain from step 0
    underneath it) `--resume auto` is appended to the child argv unless
    the caller already passed a `--resume` (`force_resume=False` disables
    this) — a supervisor that restarts from scratch would be a very slow
    crash loop."""

    def __init__(
        self,
        child_argv: list[str],
        *,
        telemetry_dir: str,
        ckpt_dir: str = "",
        policy: RestartPolicy | None = None,
        env: dict | None = None,
        force_resume: bool = True,
        child_log_path: str = "",
        seed: int | None = None,
        time_fn=time.monotonic,
        resize_device_flag: str = "",
        resize_slow_cadence: int = 0,
    ):
        self.child_argv = list(child_argv)
        self.telemetry_dir = telemetry_dir
        self.ckpt_dir = ckpt_dir
        self.policy = policy or RestartPolicy()
        self.env = env
        self.force_resume = force_resume
        self.child_log_path = child_log_path or os.path.join(
            telemetry_dir, "child.log"
        )
        self.events_path = os.path.join(telemetry_dir, EVENTS_FILENAME)
        self.heartbeat_path = os.path.join(telemetry_dir, HEARTBEAT_FILENAME)
        self.incidents: list[dict] = []  # in-memory mirror of emitted records
        # seed=None (the CLI default) draws system entropy: a fleet of
        # supervisors hit by one pod-wide fault must NOT share a jitter
        # stream, or they relaunch in lockstep — the stampede the jitter
        # exists to prevent. Tests pass an explicit seed for determinism.
        self._rng = random.Random(seed)
        self._now = time_fn
        # trace root: one run_id for the whole supervised run
        # (inherited from MOCO_TPU_RUN_ID when an orchestrator set one);
        # every child launch gets the ids via env, every supervisor
        # incident record carries them, and the supervisor's own spans
        # (one per child lifetime) land in the shared spans.jsonl.
        # Supervisor spans always record: a handful per launch is free,
        # and a timeline with the children but not their supervisor would
        # bury exactly the restart/kill context it exists to show.
        self.tracer = Tracer(telemetry_dir, "steps", proc="supervisor")
        self.run_id = self.tracer.run_id
        self._child_capturing = False
        self._budget = self.policy.max_restarts
        self._consecutive_failures = 0
        self._ever_beat = False  # any beat in any launch: distinguishes a
                                 # wedged child from a missing heartbeat
                                 # channel (telemetry off / wrong dir)
        # elastic resize: trigger-file / SIGUSR2 requests and the
        # relaunch-argv rewrite. `moco_tpu_torch.supervise` routes the
        # supervisor's own SIGUSR2 to resize.signal_resize.
        self.resize = ResizeController(
            telemetry_dir, device_flag=resize_device_flag,
            slow_cadence=resize_slow_cadence,
        )
        self._last_mesh_change: tuple | None = None
        self._resize_signaled = False
        self._resize_request_emitted = False
        # argv length snapshot taken just before a resize rewrite: if the
        # VERY NEXT launch dies config_error (an unsatisfiable device
        # count), the appended flags are reverted instead of ending the
        # run — a typo'd resize request must not take a healthy run down
        self._resize_fallback: int | None = None

    # -- structured incidents (same stream the child writes) ----------------
    def _emit(self, event: str, **fields) -> None:
        record = {"v": 1, "t": round(time.time(), 3), "kind": "supervisor",
                  "event": event, "run_id": self.run_id,
                  "trace_id": self.tracer.trace_id}
        record.update(fields)
        self.incidents.append(record)
        os.makedirs(self.telemetry_dir, exist_ok=True)
        # O_APPEND one-line writes: safe to interleave with the child's own
        # appends (the child is usually dead when the supervisor writes; a
        # concurrent kill record lands on its own line either way)
        with open(self.events_path, "a", encoding="utf-8") as f:
            f.write(json.dumps(record) + "\n")
            f.flush()
            os.fsync(f.fileno())
        detail = " ".join(f"{k}={v}" for k, v in fields.items())
        log_event("supervisor", f"{event} {detail}".strip())

    # -- progress (heartbeat + checkpoint sidecar fallback) -----------------
    def _progress_marker(self) -> int:
        """Newest known completed step: the heartbeat's (whoever wrote it —
        across a death it is the dead child's last word), else the newest
        on-disk checkpoint step. -1 when nothing has ever progressed."""
        marker = -1
        hb = read_heartbeat(self.heartbeat_path)
        if hb is not None:
            try:
                marker = max(marker, int(hb.get("step", -1)))
            except (TypeError, ValueError):
                pass  # foreign heartbeat shape: fall through to checkpoints
        if self.ckpt_dir:
            try:
                for name in os.listdir(self.ckpt_dir):
                    if name.isdigit():
                        marker = max(marker, int(name))
            except OSError:
                pass  # no checkpoint dir yet
        return marker

    # -- budget (crash-loop detection) --------------------------------------
    def _note_exit(self, progressed: bool) -> bool:
        """Update the restart budget after a restartable death; True when a
        restart is still allowed. Progress refunds the FULL budget and its
        restart is free: only consecutive no-progress deaths count toward
        the crash-loop limit, so a multi-day run that keeps advancing
        restarts indefinitely."""
        if progressed:
            self._budget = self.policy.max_restarts
            self._consecutive_failures = 0
            return self._budget > 0
        self._consecutive_failures += 1
        if self._budget <= 0:
            return False
        self._budget -= 1
        return True

    # -- child lifecycle -----------------------------------------------------
    def _launch(self, attempt: int) -> subprocess.Popen:
        argv = list(self.child_argv)
        has_resume = any(
            a == "--resume" or a.startswith("--resume=")
            for a in self.child_argv
        )
        if self.force_resume and not has_resume:
            # EVERY launch, attempt 0 included: a restarted SUPERVISOR
            # (host reboot, cron) over an existing ckpt_dir must continue
            # the run, not retrain from step 0 underneath it — and on an
            # empty directory `--resume auto` restores nothing, so this is
            # strictly safe
            argv += ["--resume", "auto"]
        # the supervisor usually starts BEFORE the child ever creates the
        # telemetry dir — the log (and the first incident record) must not
        # depend on the child having run
        os.makedirs(os.path.dirname(self.child_log_path) or ".", exist_ok=True)
        # trace propagation: the child's tracer adopts this
        # run_id and parents its root spans under the CURRENT supervisor
        # span (the per-launch `child` span run() holds open) — one
        # trace_id from supervisor through driver to staging worker
        env = dict(os.environ if self.env is None else self.env)
        env.update(self.tracer.child_env())
        log_file = open(self.child_log_path, "ab")
        try:
            child = subprocess.Popen(
                argv, stdout=log_file, stderr=subprocess.STDOUT, env=env
            )
        finally:
            # the child holds its own descriptor; keeping ours open would
            # leak one fd per restart for the supervisor's lifetime
            log_file.close()
        self._emit("launch", attempt=attempt, pid=child.pid,
                   budget_left=self._budget, argv=argv)
        return child

    def _kill_for_hang(self, child: subprocess.Popen, stale_for: float) -> None:
        self.tracer.instant("hang_kill", cat="supervisor", pid=child.pid,
                            stale_secs=round(stale_for, 3))
        self._emit("kill", pid=child.pid, reason="heartbeat_stale",
                   stale_secs=round(stale_for, 3), phase="sigterm")
        child.send_signal(signal.SIGTERM)
        deadline = self._now() + self.policy.term_grace_secs
        while child.poll() is None and self._now() < deadline:
            time.sleep(min(self.policy.poll_secs, 0.2))
        if child.poll() is None:
            self._emit("kill", pid=child.pid, reason="heartbeat_stale",
                       phase="sigkill")
            child.kill()
            child.wait()

    def _monitor(self, child: subprocess.Popen) -> bool:
        """Block until the child exits; True when the supervisor killed it
        for heartbeat staleness. The tight staleness window only applies
        while the newest beat from THIS child has phase "step" — during
        startup (torch import, kernel load, restore) and every other
        declared phase (an "eval" beat before a multi-minute kNN eval, the
        "run_end"/"preempt_exit" beat before finalize/export) silence is
        normal and only the generous startup grace applies. A supervisor
        that NEVER sees a beat in any launch (telemetry off, mismatched
        --telemetry-dir) disables hang detection with a loud incident
        instead of kill-looping a healthy child forever."""
        launched = self._now()
        launched_wall = time.time()
        launched_mono = time.monotonic()  # freshness basis for mono_s
                                          # beats (wall-jump-immune)
        beat_phase = None     # phase of the newest beat from this child
        last_beat = launched  # supervisor-clock time of the newest beat
        last_marker = None    # the beat's own change marker (seq, else t)
        warned_pid = False
        hang_detection = self.policy.heartbeat_stale_secs > 0
        self._resize_signaled = False  # a still-armed request re-signals
                                       # THIS launch once it starts stepping
        while child.poll() is None:
            time.sleep(self.policy.poll_secs)
            self._poll_resize(child, beat_phase, hang_detection,
                              self._now() - launched)
            if not hang_detection:
                continue  # non-main pod hosts: no heartbeat ever exists
            hb = read_heartbeat(self.heartbeat_path)
            if hb is not None:
                # a beat counts when its pid is our direct child, OR when
                # it is fresher than this launch — the trainer may be a
                # grandchild behind a wrapper (srun, bash -c, docker run),
                # whose pid never equals Popen's. The freshness bound
                # keeps a STALE file from the previous incarnation from
                # arming the tight window during this child's compile —
                # judged on the heartbeat's monotonic mono_s when present
                # (seq/mono_s pair: a wall-clock step must read as
                # neither hang nor freshness), wall t for old payloads.
                mine = hb.get("pid") == child.pid
                fresh = beat_is_fresh(hb, launched_wall, launched_mono)
                if (mine or fresh) and beat_marker(hb) != last_marker:
                    last_marker = beat_marker(hb)
                    last_beat = self._now()
                    beat_phase = hb.get("phase")
                    self._ever_beat = True
                    if fresh and not mine and not warned_pid:
                        warned_pid = True
                        self._emit(
                            "heartbeat_pid_mismatch", child_pid=child.pid,
                            beat_pid=hb.get("pid"),
                            note="wrapper command? beats accepted by "
                                 "freshness; progress checks unaffected",
                        )
                if mine or fresh:
                    # same staleness guard as the beat bookkeeping: a
                    # stale file from the PREVIOUS incarnation (which may
                    # have died mid-capture) must not fabricate
                    # "currently profiling" transitions for this child
                    self._note_trace_state(hb)
            window = (self.policy.heartbeat_stale_secs
                      if beat_phase == "step"
                      else self.policy.startup_grace_secs)
            stale_for = self._now() - last_beat
            if stale_for > window:
                if last_marker is None and not self._ever_beat:
                    # no beat EVER, in this or any previous launch: the
                    # heartbeat channel itself is missing (telemetry off,
                    # mismatched --telemetry-dir) — killing a child that
                    # never promised beats would loop forever, each kill
                    # refunded by checkpoint progress
                    self._emit(
                        "no_heartbeat", child_pid=child.pid,
                        heartbeat_path=self.heartbeat_path,
                        note="no heartbeat observed in any launch — hang "
                             "detection DISABLED; is --telemetry-dir the "
                             "child's telemetry dir, and telemetry on?",
                    )
                    hang_detection = False
                    continue
                self._kill_for_hang(child, stale_for)
                return True
        if hang_detection:
            # one post-exit read: a short capture window (or a child that
            # DIED while capturing — the interesting case) must not slip
            # between two polls unseen. Same mine-or-fresh guard: a child
            # that never beat leaves the previous incarnation's file.
            hb = read_heartbeat(self.heartbeat_path)
            if hb is not None and (
                    hb.get("pid") == child.pid
                    or beat_is_fresh(hb, launched_wall, launched_mono)):
                self._note_trace_state(hb)
        return False

    def _poll_resize(self, child: subprocess.Popen,
                     beat_phase: str | None,
                     hang_detection: bool,
                     child_age: float) -> None:
        """Arm a pending resize request (trigger file / SIGUSR2-to-the-
        supervisor) and signal the child to take its elastic checkpoint.

        The signal is HELD until the newest beat says the child is in its
        step loop: before that (torch import, kernel load, restore) the driver
        has not installed its SIGUSR2 listener yet, and the default
        disposition would TERMINATE the child mid-boot. With hang
        detection off there is no phase to wait for — signal immediately,
        best effort. `hang_detection` is the monitor's LIVE state, not
        the policy knob: a run whose heartbeat channel turned out missing
        (the `no_heartbeat` incident) will never produce a "step" beat,
        and holding the signal there would strand an armed request — its
        trigger file already consumed — forever. SIGUSR2 goes to the Popen pid; a
        wrapper command (srun, docker) that doesn't forward it still
        converges — the child's own listener polls the same trigger file,
        and the file claim is atomic (exactly one side wins; both roads
        end at an EXIT_RESIZE)."""
        req = self.resize.poll()
        if req is not None:
            self._resize_signaled = False
            self._resize_request_emitted = True
            self.tracer.instant("resize_request", cat="supervisor",
                                source=req.source, devices=req.devices)
            self._emit(
                "resize_request", pid=child.pid, source=req.source,
                devices=req.devices, grad_sync_cadence=req.grad_sync_cadence,
                slow=req.slow,
            )
        if self.resize.armed is None or self._resize_signaled:
            return
        # no-heartbeat children still get the startup grace before the
        # signal: an immediate SIGUSR2 would land during torch import on
        # EVERY relaunch (no handler yet → terminated mid-boot) and one
        # armed request would kill-loop the run to budget exhaustion
        ready_blind = (not hang_detection
                       and child_age > self.policy.startup_grace_secs)
        if beat_phase == "step" or ready_blind:
            self._resize_signaled = True
            try:
                child.send_signal(signal.SIGUSR2)
            except OSError:
                pass  # child died between poll() and the signal: the exit
                      # classification (and resize.take) handle the rest

    def _note_trace_state(self, hb: dict) -> None:
        """"Currently profiling" surfacing: the beat
        carries the child's capture state, so the operator watching
        supervisor output learns a capture started/ended without reading
        events.jsonl. Emits one `child_trace` record per transition."""
        trace_state = hb.get("trace")
        if not isinstance(trace_state, dict):
            return
        capturing = bool(trace_state.get("capturing"))
        if capturing == self._child_capturing:
            return
        self._child_capturing = capturing
        self._emit(
            "child_trace",
            capturing=capturing,
            step=hb.get("step"),
            captures_used=trace_state.get("captures_used"),
            capture_budget=trace_state.get("capture_budget"),
        )

    # -- elastic resize --------------------------------------------------------
    def _apply_resize(self, child_span, step: int) -> None:
        """Consume the honored resize request and rewrite the relaunch:
        device-count append (argparse last-wins) and the optional grad-sync
        cadence override for slowly linked cards. Emits the `resize_relaunch` incident and records the
        whole request→relaunch interval as a `resize` span parented under
        the exiting launch's `child` span (retroactive: the interval is
        only known now — the Tracer's record_span API exists for exactly
        this shape)."""
        t_armed = self.resize.armed_at_wall or time.time()
        req = self.resize.take()
        if not self._resize_request_emitted:
            # the child honored the request before the supervisor's poll
            # ever armed it (the chaos drill, or the child's own file
            # claim): the request must still appear in the stream — a
            # report showing relaunches "from 0 requests" reads as
            # resizes nobody asked for
            self._emit(
                "resize_request", source=req.source, devices=req.devices,
                grad_sync_cadence=req.grad_sync_cadence, slow=req.slow,
            )
        self._resize_request_emitted = False
        self._resize_fallback = len(self.child_argv)
        summary = self.resize.apply(req, self.child_argv)
        summary["step"] = step
        self.tracer.record_span(
            "resize", t_armed, max(time.time() - t_armed, 0.0),
            cat="supervisor", parent=child_span.context(), **summary,
        )
        self._emit("resize_relaunch", **summary)

    def _check_mesh_change(self) -> None:
        """`mesh_change` incident when the device count this launch's argv
        pins differs from the world the newest checkpoint records (the
        position sidecar's `devices` stamp) — the relaunch-preflight
        membership check. Silent when either side is unknown (no sidecar
        yet / argv leaves the mesh to the hardware): never guessed."""
        if not self.ckpt_dir:
            return
        recorded = read_recorded_devices(self.ckpt_dir)
        declared = argv_device_count(self.child_argv)
        if recorded is None or declared is None:
            return
        step, old = recorded
        if old == declared:
            self._last_mesh_change = None
            return
        key = (step, old, declared)
        if key == self._last_mesh_change:
            return  # this exact mismatch was already reported
        self._last_mesh_change = key
        self.tracer.instant("mesh_change", cat="supervisor",
                            devices_from=old, devices_to=declared)
        self._emit(
            "mesh_change", ckpt_step=step, devices_from=old,
            devices_to=declared,
            note="relaunch world differs from the newest checkpoint's "
                 "recorded world; the restore restarts the gradsync "
                 "accumulators from zeros",
        )

    # -- main loop -----------------------------------------------------------
    def run(self) -> SupervisorResult:
        try:
            return self._run()
        finally:
            self.tracer.close()  # land any buffered supervisor spans

    def _run(self) -> SupervisorResult:
        attempt = 0
        classifications: list[str] = []
        marker_before = self._progress_marker()
        while True:
            if self.ckpt_dir and attempt > 0:
                preflight_resume(self.ckpt_dir, emit=self._emit)
            # membership check: the world this launch will build differs
            # from the one the newest checkpoint was saved under — say so
            # HERE, not first inside the child's restore
            self._check_mesh_change()
            # one span per child LIFETIME (launch → death): the child's own
            # root spans parent under it via the env stamped in _launch,
            # so the merged timeline nests each incarnation's work beneath
            # the supervisor's view of it
            with self.tracer.span("child", cat="supervisor",
                                  attempt=attempt) as child_span:
                child = self._launch(attempt)
                self._child_capturing = False
                hang_killed = self._monitor(child)
                rc = child.returncode
                cls, detail = classify_exit(
                    rc,
                    hang_killed=hang_killed,
                    events_tail=read_events_tail(self.events_path),
                    oom_rss_bytes=self.policy.oom_rss_bytes,
                )
                child_span.set(pid=child.pid, returncode=rc,
                               classification=cls)
            marker_now = self._progress_marker()
            progressed = marker_now > marker_before
            marker_before = max(marker_before, marker_now)
            classifications.append(cls)
            self._emit("exit", pid=child.pid, returncode=rc,
                       classification=cls, detail=detail,
                       progressed=progressed, last_step=marker_now)
            # one-shot resize fallback: this exit is the FIRST after a
            # resize rewrite (the snapshot is cleared here regardless of
            # class). A config_error death on that launch means the
            # rewritten argv can never boot (typo'd device count > the
            # hardware): revert the appended flags and keep the run alive
            # on the old mesh instead of ending it for a bad request.
            reverted = False
            if self._resize_fallback is not None:
                snapshot, self._resize_fallback = self._resize_fallback, None
                if cls == CLASS_CONFIG_ERROR:
                    dropped = self.child_argv[snapshot:]
                    del self.child_argv[snapshot:]
                    reverted = True
                    self._emit(
                        "resize_revert", dropped=dropped, returncode=rc,
                        note="resized argv failed config validation — "
                             "relaunching on the previous mesh",
                    )
            if cls == CLASS_CLEAN:
                self._emit("done", launches=attempt + 1, restarts=attempt)
                return SupervisorResult(cls, rc, attempt + 1, attempt,
                                        False, classifications)
            if not reverted and cls not in self.policy.restart_on:
                self._emit("give_up", reason=f"fatal class {cls}",
                           returncode=rc, restarts=attempt)
                return SupervisorResult(cls, rc, attempt + 1, attempt,
                                        False, classifications)
            if not self._note_exit(progressed):
                self._emit(
                    "give_up",
                    reason=(
                        f"restart budget exhausted: "
                        f"{self._consecutive_failures} consecutive "
                        f"no-progress deaths (max_restarts="
                        f"{self.policy.max_restarts})"
                    ),
                    returncode=rc, restarts=attempt,
                )
                return SupervisorResult(cls, rc, attempt + 1, attempt,
                                        True, classifications)
            if cls == CLASS_RESIZE:
                # the child honored the resize: rewrite the relaunch argv
                # (device count, cadence override)
                # before the next launch — the whole incident lands as one
                # `resize` span under this launch's child span
                self._apply_resize(child_span, step=marker_now)
            if cls not in self.policy.no_backoff:
                delay = self.policy.backoff_secs(
                    self._consecutive_failures, self._rng
                )
                self._emit("backoff", secs=round(delay, 3),
                           consecutive_failures=self._consecutive_failures,
                           budget_left=self._budget)
                time.sleep(delay)
            attempt += 1
            self._emit("restart", attempt=attempt, after=cls,
                       budget_left=self._budget)
