"""Deterministic fault injection (the port's copy of
`moco_tpu/resilience/chaos.py`: the same fields, spec grammar, fire-once
rules and `MOCO_TPU_CHAOS_STATE` markers).

A `ChaosPlan` names a fault and the exact step or batch it fires at; the
driver and the Prefetcher poll the installed plan at their hook points, and
each fault fires AT MOST ONCE, so a run that rolls back and re-traverses
the same step numbers is not poisoned again, and every scenario is
reproducible bit for bit.

    with chaos_context(ChaosPlan(sigterm_at_step=11)):
        train(config, device="cpu")

    python -m moco_tpu_torch.train --preset ... --chaos "nan_at_step=300"
    MOCO_TPU_CHAOS="sigterm_at_step=5000" python -m moco_tpu_torch.train ...

The driver's hooks: `nan_at_step`/`nan_count`, `sigterm_at_step`,
`slow_at_step`, `kill_at_step`, `freeze_at_step`, `collapse_at_step`,
`resize_at_step`/`resize_devices`; the Prefetcher's:
`loader_error_at_batch`/`loader_error_count` (also polled by the input
service's `ServiceClient`); the staging server's decode worker
(`data/service/worker.py`): `kill_at_shard`, `stall_at_shard`/`stall_ms`.
`kill_at_step` and `freeze_at_step` are recovered by the out-of-process
supervisor (`resilience/supervisor.py`), `kill_at_shard` by the staging
server's. The serving faults (`kill_at_request`, `wedge_at_request`) parse
as in the JAX package; the port has no serving front end yet, so nothing
polls them.

`truncate_checkpoint` is the storage-fault injector: it halves the largest
file of a saved step in place, as a preempted writer leaves it.
"""

from __future__ import annotations

import contextlib
import os
import signal
import threading
import time
from dataclasses import dataclass, field

from moco_tpu_torch.resilience.errors import TransientDataError
from moco_tpu_torch.utils.logging import log_event


@dataclass
class ChaosPlan:
    """One deterministic fault scenario. Steps count COMPLETED train steps
    (the driver's step after the increment); batches are the Prefetcher's
    0-based batch index among the batches it stages.

    `state_dir` (from `MOCO_TPU_CHAOS_STATE` for env- and config-installed
    plans) makes the fire-once state of sigterm, kill and freeze survive the
    process: each drops a marker file before it fires and never fires again
    across restarts, and of the ranks of a group that share the directory
    exactly one fires it. The counted faults (`nan_count`, `loader_error_count`)
    stay per process: they model re-traversal within one process."""

    sigterm_at_step: int | None = None      # deliver SIGTERM after step k
    kill_at_step: int | None = None         # self-SIGKILL after step k (no
                                            # emergency checkpoint)
    freeze_at_step: int | None = None       # stop dead after step k (a wedged
                                            # collective): sleeps until killed
    slow_at_step: int | None = None         # sleep slow_ms inside step k
    slow_ms: int = 1000
    nan_at_step: int | None = None          # poison the reported loss at step k
    nan_count: int = 1                      # poison step k on this many traversals
                                            # (>1: a structural divergence)
    loader_error_at_batch: int | None = None  # Prefetcher read fault at batch b
    loader_error_count: int = 1             # consecutive faults before recovery
    kill_at_request: int | None = None      # serving: SIGKILL after request k
    resize_at_step: int | None = None       # elastic resize after step k
    resize_devices: int = 0                 # its target device count (`devices=`)
    collapse_at_step: int | None = None     # crush the key encoder from step k on
    kill_at_shard: int | None = None        # staging server: SIGKILL after shard k
    stall_at_shard: int | None = None       # staging server: stall shard k
    stall_ms: int = 1000
    wedge_at_request: int | None = None     # serving: stop answering after request k
    state_dir: str | None = None            # fire-once markers persisted here
    _fired: set = field(default_factory=set, repr=False)
    _nans_raised: int = field(default=0, repr=False)
    _loader_errors_raised: int = field(default=0, repr=False)
    # the staging workers poll the loader fault concurrently: the budget is
    # spent under a lock
    _lock: threading.Lock = field(default_factory=threading.Lock, repr=False)

    def _fire_once(self, key: str) -> bool:
        if key in self._fired:
            return False
        if self.state_dir:
            # the marker is written BEFORE the fault: a SIGKILL leaves no
            # later chance to record it. Created exclusively: of the ranks of
            # a group sharing the directory, exactly one fires.
            marker = os.path.join(self.state_dir, f"fired_{key}")
            os.makedirs(self.state_dir, exist_ok=True)
            try:
                fd = os.open(marker, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
            except FileExistsError:
                self._fired.add(key)
                return False
            with os.fdopen(fd, "w") as f:
                f.write(str(os.getpid()))
        self._fired.add(key)
        return True

    def maybe_sigterm(self, step: int) -> None:
        """A real SIGTERM through the OS, so the handler's own path runs."""
        if self.sigterm_at_step == step and self._fire_once("sigterm"):
            log_event("chaos", f"injecting SIGTERM at step {step}")
            signal.raise_signal(signal.SIGTERM)

    def maybe_kill(self, step: int) -> None:
        """Self-SIGKILL: no handler runs, the progress since the last
        checkpoint is lost; only a restart with `--resume auto` recovers."""
        if self.kill_at_step == step and self._fire_once("kill"):
            log_event("chaos", f"injecting SIGKILL at step {step}")
            os.kill(os.getpid(), signal.SIGKILL)

    def maybe_freeze(self, step: int) -> None:
        """Stop completing steps without exiting, as a stuck collective
        does; sleeps until killed from outside."""
        if self.freeze_at_step == step and self._fire_once("freeze"):
            log_event("chaos", f"injecting freeze (wedged-collective simulation) at step {step}")
            while True:
                time.sleep(3600.0)

    def maybe_slow(self, step: int) -> None:
        """Stall step `slow_at_step` by `slow_ms` (fire-once): a slow step,
        not a hang; the run goes on."""
        if self.slow_at_step == step and self._fire_once("slow"):
            log_event("chaos", f"injecting {self.slow_ms} ms slow step at step {step}")
            time.sleep(self.slow_ms / 1e3)

    def maybe_resize(self, step: int) -> int | None:
        """The target device count at `resize_at_step` (fire-once, marker
        persisted like kill and freeze: the resized relaunch must not fire
        the drill again into a resize loop); None otherwise. 0 means
        "resize without pinning a count". The driver writes the
        resize.request and exits through the operator's path, so the drill
        runs the real loop."""
        if self.resize_at_step == step and self._fire_once("resize"):
            log_event("chaos", f"injecting resize request at step {step} "
                               f"(devices={self.resize_devices or 'visible'})")
            return self.resize_devices
        return None

    def maybe_collapse(self, step: int) -> bool:
        """True for EVERY step from `collapse_at_step` on: the driver crushes
        the key encoder after each (the in-step EMA would heal a one-shot
        crush). The onset is logged once."""
        if self.collapse_at_step is None or step < self.collapse_at_step:
            return False
        if self._fire_once("collapse"):
            log_event("chaos", f"injecting representation collapse from step {step}: "
                               "key-encoder params crushed to a constant-feature tree")
        return True

    def maybe_nan(self, step: int) -> bool:
        """True at `nan_at_step` on its first `nan_count` traversals: the
        driver replaces the step's reported loss with NaN."""
        if self.nan_at_step == step and self._nans_raised < self.nan_count:
            self._nans_raised += 1
            log_event("chaos", f"injecting non-finite loss at step {step} "
                               f"({self._nans_raised}/{self.nan_count})")
            return True
        return False

    def maybe_kill_request(self, n_requests: int) -> None:
        """Serve-side SIGKILL after the n-th admitted request (fire-once,
        marker persisted: the relaunched replica counts its requests from 0
        again and must not fire the drill into a crash loop)."""
        if self.kill_at_request == n_requests and self._fire_once("kill_request"):
            log_event("chaos", f"injecting SIGKILL at request {n_requests}")
            os.kill(os.getpid(), signal.SIGKILL)

    def maybe_wedge_request(self, n_requests: int) -> bool:
        """True once, at the n-th admitted request: the caller (the serve
        front end) turns into accepting-but-not-answering: sockets still
        accept, every handler thread then sleeps forever. Unlike the kill,
        the wedge leaves a live process: only an outside probe-staleness
        kill ends it."""
        if self.wedge_at_request == n_requests and self._fire_once("wedge_request"):
            log_event("chaos", f"injecting serve wedge (accepting-but-not-answering) at "
                               f"request {n_requests}")
            return True
        return False

    def maybe_kill_shard(self, n_shards: int) -> None:
        """Staging-server SIGKILL after the n-th served shard (fire-once,
        marker persisted: the relaunched worker counts its shards from 0
        again and must not fire the drill into a crash loop). Fired BEFORE
        the shard's answer is sent, so the client sees a dead connection
        mid-request: the failure its retry on another server exists for."""
        if self.kill_at_shard == n_shards and self._fire_once("kill_shard"):
            log_event("chaos", f"injecting SIGKILL at shard {n_shards}")
            os.kill(os.getpid(), signal.SIGKILL)

    def maybe_stall_shard(self, n_shards: int) -> None:
        """Stall the n-th served shard by `stall_ms` before answering
        (fire-once, marker persisted). Above the client's request timeout
        the client's read times out and another server serves the shard;
        below it the shard is merely late. The stalled server stays
        healthy either way."""
        if self.stall_at_shard == n_shards and self._fire_once("stall_shard"):
            log_event("chaos", f"injecting {self.stall_ms} ms stall at shard {n_shards}")
            time.sleep(self.stall_ms / 1e3)

    def maybe_loader_error(self, batch_index: int) -> None:
        """Raise `TransientDataError` on the first `loader_error_count`
        attempts at `loader_error_at_batch`, across all staging workers."""
        if self.loader_error_at_batch != batch_index:
            return
        with self._lock:
            if self._loader_errors_raised >= self.loader_error_count:
                return
            self._loader_errors_raised += 1
            n = self._loader_errors_raised
        raise TransientDataError(f"chaos: injected read failure {n}/"
                                 f"{self.loader_error_count} at batch {batch_index}")


_INT_FIELDS = (
    "sigterm_at_step",
    "kill_at_step",
    "freeze_at_step",
    "slow_at_step",
    "slow_ms",
    "nan_at_step",
    "nan_count",
    "loader_error_at_batch",
    "loader_error_count",
    "kill_at_request",
    "kill_at_shard",
    "stall_at_shard",
    "stall_ms",
    "wedge_at_request",
    "collapse_at_step",
    "resize_at_step",
    "resize_devices",
)

# spec-key sugar: `resize_at_step=6,devices=2`
_SPEC_ALIASES = {"devices": "resize_devices"}


def parse_chaos_spec(spec: str) -> ChaosPlan | None:
    """`"sigterm_at_step=11,nan_at_step=3"` -> ChaosPlan; an empty spec ->
    None. An unknown key raises: a misspelt fault that never fires would
    make the drill vacuous."""
    spec = spec.strip()
    if not spec:
        return None
    kw: dict[str, int] = {}
    for part in spec.split(","):
        key, _, value = part.partition("=")
        key = _SPEC_ALIASES.get(key.strip(), key.strip())
        if key not in _INT_FIELDS:
            raise ValueError(f"unknown chaos fault {key!r}; known: {', '.join(_INT_FIELDS)}")
        kw[key] = int(value)
    return ChaosPlan(**kw)


# one plan a process: the hooks live in the staging threads and the main loop
_ACTIVE: ChaosPlan | None = None


def install_chaos(plan: ChaosPlan | None) -> None:
    global _ACTIVE
    _ACTIVE = plan


def clear_chaos() -> None:
    install_chaos(None)


def active_chaos() -> ChaosPlan | None:
    """The installed plan; else one parsed from `MOCO_TPU_CHAOS` (kept for
    the process, with `MOCO_TPU_CHAOS_STATE` as its marker directory)."""
    if _ACTIVE is None:
        env = os.environ.get("MOCO_TPU_CHAOS", "")
        if env:
            plan = parse_chaos_spec(env)
            if plan is not None:
                plan.state_dir = os.environ.get("MOCO_TPU_CHAOS_STATE") or None
            install_chaos(plan)
    return _ACTIVE


@contextlib.contextmanager
def chaos_context(plan: ChaosPlan):
    """Scoped install: no plan outlives the block, even when it raises."""
    install_chaos(plan)
    try:
        yield plan
    finally:
        clear_chaos()


def truncate_checkpoint(ckpt_dir: str, step: int) -> str:
    """Corrupt the saved `step` as a preempted writer does: truncate its
    largest file to half. Returns the file's path."""
    root = os.path.join(os.path.abspath(ckpt_dir), str(step))
    largest, size = None, -1
    for dirpath, _dirnames, filenames in os.walk(root):
        for fname in filenames:
            p = os.path.join(dirpath, fname)
            s = os.path.getsize(p)
            if s > size:
                largest, size = p, s
    if largest is None:
        raise FileNotFoundError(f"no files under checkpoint step dir {root}")
    with open(largest, "r+b") as f:
        f.truncate(size // 2)
    log_event("chaos", f"truncated {largest} from {size} to {size // 2} bytes")
    return largest

