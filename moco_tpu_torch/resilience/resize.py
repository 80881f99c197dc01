"""Elastic training: checkpoint, resize, relaunch across a changing number of
cards (the port's own copy of `moco_tpu/resilience/resize.py`).

A resize is a clean exit and a relaunch, wired from pieces that exist on
their own: the checkpoint restores at another world size (`checkpoint.py`,
positions count global batches, the gradient-sync accumulators restart from
zeros), the supervisor classifies deaths and relaunches
(`resilience/supervisor.py`), and the position sidecars keep the data
window.

  - `ResizeListener` (child side, wired by the train driver): a
    `<telemetry_dir>/resize.request` trigger file (polled, time-gated, at
    step boundaries) or a SIGUSR2 sets a flag; the ranks agree on it, the
    driver finishes the step in flight, writes an elastic checkpoint and
    exits `EXIT_RESIZE` (49), the "relaunch me onto another number of
    cards" exit, distinct from a preemption's 43.
  - `ResizeController` (supervisor side): takes resize requests (the same
    trigger file, or a SIGUSR2 delivered to the SUPERVISOR), signals the
    child, and on the child's 49 rewrites the relaunch argv: the new card
    count (an argparse last-wins append of `--num-devices`) and an optional
    `--grad-sync-cadence` when the request flags the new cards as slowly
    linked. `--resume auto` then restores the state at the new world size.
  - `read_recorded_devices` / `argv_device_count`: the relaunch preflight's
    membership check. Every checkpoint's position sidecar records the
    number of processes it was saved under, so a supervisor about to
    relaunch onto another count logs the `mesh_change` incident first.

The JAX module's `--fake-devices` spelling has no counterpart: `--device
cpu --num-devices 2` is two gloo ranks. Its rotation of the XLA compile
cache at each resize has none either: the port compiles its kernels into a
`.so` named by the hash of its sources, written atomically
(`ops/_build.py`), so no file a killed process leaves behind is ever read.

Request file: `key=value` pairs, whitespace- or comma-separated, e.g.
`devices=2 grad_sync_cadence=4`, or an empty file ("resize to whatever is
visible now"). `slow=1` flags the new cards as slowly linked without naming
a cadence; the supervisor then applies its `--resize-slow-cadence`.
`sharding=` parses as in the JAX package and the relaunch argv gains
`--sharding <mode>`: `train.main` checks that layout against the new
count before any rendezvous (EXIT_CONFIG_ERROR when it cannot divide it),
and the restore takes its slices of the state in the new mode.
Consumption renames the file to `resize.request.honored` (atomic), so a
stale request can never fire again in the next incarnation.

Everything here is stdlib: the supervisor imports it, and it must survive
the failures that kill the training process.
"""

from __future__ import annotations

import dataclasses
import json
import os
import signal
import threading
import time

from moco_tpu_torch.resilience.integrity import position_path
from moco_tpu_torch.utils.logging import log_event

RESIZE_REQUEST_FILENAME = "resize.request"
HONORED_SUFFIX = ".honored"

# argv spellings that pin a device count, as `--flag N` or `--flag=N`: the
# number of rank processes `python -m moco_tpu_torch.train` starts
DEVICE_FLAGS = ("--num-devices",)


@dataclasses.dataclass
class ResizeRequest:
    """One parsed resize request. `devices=None` means "resize to whatever
    the relaunch sees" (the argv keeps its device flags and the hardware
    defines the world)."""

    devices: int | None = None
    grad_sync_cadence: int | None = None
    sharding: str | None = None  # the sharding mode of the relaunch (dp/fsdp/fsdp_tp)
    slow: bool = False           # new cards flagged slowly linked: the supervisor
                                 # applies its configured cadence override
    source: str = "request"      # "request" | "sigusr2" | "chaos" | "exit"


def parse_resize_request(text: str, source: str = "request") -> ResizeRequest:
    """`"devices=2 grad_sync_cadence=4"` -> ResizeRequest. Empty text is a
    valid request (resize to the visible device count). Unknown keys are
    rejected loudly: a typo'd `device=2` resizing to the old count would be
    worse than the error."""
    req = ResizeRequest(source=source)
    for part in text.replace(",", " ").split():
        key, sep, value = part.partition("=")
        key = key.strip()
        if not sep:
            raise ValueError(f"malformed resize request entry {part!r} "
                             "(expected key=value)")
        if key == "devices":
            req.devices = int(value)
            if req.devices < 1:
                raise ValueError(f"resize devices must be >= 1, got {value}")
        elif key == "grad_sync_cadence":
            req.grad_sync_cadence = int(value)
            if req.grad_sync_cadence < 1:
                raise ValueError(
                    f"resize grad_sync_cadence must be >= 1, got {value}")
        elif key == "sharding":
            if value not in ("dp", "fsdp", "fsdp_tp"):
                raise ValueError(
                    f"resize sharding must be dp/fsdp/fsdp_tp, got {value!r}")
            req.sharding = value
        elif key == "slow":
            req.slow = bool(int(value))
        else:
            raise ValueError(
                f"unknown resize request key {key!r}; known: devices, "
                "grad_sync_cadence, sharding, slow"
            )
    return req


def request_path(telemetry_dir: str) -> str:
    return os.path.join(telemetry_dir, RESIZE_REQUEST_FILENAME)


def write_resize_request(
    telemetry_dir: str,
    devices: int | None = None,
    grad_sync_cadence: int | None = None,
    slow: bool = False,
    sharding: str | None = None,
) -> str:
    """Drop a resize request next to trace.trigger (atomic: a supervisor
    polling mid-write never parses half a request; each writer's temporary
    file is its own, so ranks or operators writing at once cannot collide).
    Returns the path."""
    parts = []
    if devices is not None:
        parts.append(f"devices={int(devices)}")
    if grad_sync_cadence is not None:
        parts.append(f"grad_sync_cadence={int(grad_sync_cadence)}")
    if sharding is not None:
        parts.append(f"sharding={sharding}")
    if slow:
        parts.append("slow=1")
    os.makedirs(telemetry_dir, exist_ok=True)
    path = request_path(telemetry_dir)
    tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
    with open(tmp, "w", encoding="utf-8") as f:
        f.write(" ".join(parts) + "\n")
    os.replace(tmp, path)
    return path


def consume_resize_request(telemetry_dir: str,
                           source: str = "request") -> ResizeRequest | None:
    """Atomically claim a pending request (a rename to `.honored`: exactly
    one of N racing consumers wins, and a relaunched child never fires on a
    stale file). None when no request is pending or it does not parse
    (logged, never fatal: a malformed request must not take the run down)."""
    path = request_path(telemetry_dir)
    honored = path + HONORED_SUFFIX
    try:
        os.replace(path, honored)  # atomic claim; overwrites the last one
    except OSError:
        return None  # no pending request
    return read_honored_request(telemetry_dir, source=source)


def read_honored_request(telemetry_dir: str,
                         source: str = "request") -> ResizeRequest | None:
    """The last CLAIMED request's payload. The supervisor falls back to it
    when the child's own poll won the claim (the claim is a rename, so the
    payload survives it); `ResizeController.apply` deletes the file once
    honored, so a stale payload never leaks into a later resize."""
    honored = request_path(telemetry_dir) + HONORED_SUFFIX
    try:
        with open(honored, encoding="utf-8") as f:
            text = f.read()
    except OSError:
        return None
    try:
        return parse_resize_request(text, source=source)
    except ValueError as e:
        log_event("resize", f"ignoring unparseable resize request: {e}")
        return None


# -- membership bookkeeping ---------------------------------------------------


def read_recorded_devices(ckpt_dir: str) -> tuple[int, int] | None:
    """`(step, devices)` of the NEWEST checkpoint step whose position
    sidecar records the number of processes it was saved under
    (`checkpoint.write_position` stamps `devices` on every save). None when
    no step records one: never guessed at."""
    try:
        names = os.listdir(ckpt_dir)
    except OSError:
        return None
    for name in sorted((n for n in names if n.isdigit()), key=int,
                       reverse=True):
        try:
            with open(position_path(ckpt_dir, int(name)),
                      encoding="utf-8") as f:
                payload = json.load(f)
            devices = int(payload["devices"])
        except (OSError, ValueError, KeyError, TypeError,
                json.JSONDecodeError):
            continue
        return int(name), devices
    return None


def argv_device_count(argv: list[str]) -> int | None:
    """The device count the argv pins (`--num-devices N`, either flag form;
    the LAST occurrence wins, the argparse rule the resize append relies
    on). None when the argv leaves the count to the default."""
    found: int | None = None
    i = 0
    while i < len(argv):
        arg = argv[i]
        for flag in DEVICE_FLAGS:
            value = None
            if arg == flag and i + 1 < len(argv):
                value = argv[i + 1]
            elif arg.startswith(flag + "="):
                value = arg[len(flag) + 1:]
            if value is not None:
                try:
                    n = int(value)
                except ValueError:
                    continue
                if n > 0:
                    found = n
        i += 1
    return found


def pick_device_flag(argv: list[str], default: str = "--num-devices") -> str:
    """The flag the resize append uses: whichever device flag the argv
    already speaks, else `default`."""
    for arg in argv:
        for flag in DEVICE_FLAGS:
            if arg == flag or arg.startswith(flag + "="):
                return flag
    return default


# -- child side ---------------------------------------------------------------


class ResizeListener:
    """Turns a resize request into a flag the train driver polls (the
    `PreemptionHandler` pattern): SIGUSR2 sets it at once; `poll()` also
    checks the trigger file, time-gated (`poll_secs`), consuming it on
    trigger so an unsupervised relaunch never fires on the stale file. The
    driver finishes the step in flight, writes the elastic checkpoint and
    exits `EXIT_RESIZE`.

    Signal handlers install from the main thread only (pytest workers and
    nested drivers get a listener that polls the file alone)."""

    def __init__(self, telemetry_dir: str = "", poll_secs: float = 0.5):
        self.telemetry_dir = telemetry_dir
        self.poll_secs = float(poll_secs)
        self._flag = threading.Event()
        self._last_poll = float("-inf")
        self._prev = None
        self._installed = False

    def _handle(self, signum, frame):
        if not self._flag.is_set():
            log_event(
                "resize",
                "caught SIGUSR2: finishing the in-flight step, then writing "
                "an elastic checkpoint and exiting for the resize relaunch",
            )
        self._flag.set()

    def __enter__(self) -> "ResizeListener":
        if threading.current_thread() is threading.main_thread():
            self._prev = signal.signal(signal.SIGUSR2, self._handle)
            self._installed = True
        return self

    def __exit__(self, *exc) -> bool:
        if self._installed:
            if self._flag.is_set():
                # the resize is being honored: the listener exits before the
                # elastic checkpoint is written, and the supervisor may still
                # deliver its SIGUSR2 in that window; the default disposition
                # would terminate the child mid-save, so SIGUSR2 stays ignored
                # for the rest of this (exiting) process
                signal.signal(signal.SIGUSR2, signal.SIG_IGN)
            else:
                signal.signal(signal.SIGUSR2, self._prev)
            self._installed = False
        return False

    @property
    def triggered(self) -> bool:
        return self._flag.is_set()

    def trigger(self, source: str = "chaos") -> None:
        """Programmatic trigger (the chaos `resize_at_step` drill)."""
        if not self._flag.is_set():
            log_event("resize", f"resize triggered ({source}): exiting for "
                                "relaunch after the elastic checkpoint")
        self._flag.set()

    def poll(self, now: float | None = None) -> bool:
        """The flag, refreshed from the trigger file at most once per
        `poll_secs` (one `os.replace` attempt; the fast path is a
        monotonic-clock compare). A supervised run rarely reaches the file:
        the supervisor consumes it first and sends SIGUSR2."""
        if self._flag.is_set():
            return True
        if not self.telemetry_dir:
            return False
        now = time.monotonic() if now is None else now
        if now - self._last_poll < self.poll_secs:
            return False
        self._last_poll = now
        req = consume_resize_request(self.telemetry_dir)
        if req is not None:
            self.trigger(source="trigger file")
        return self._flag.is_set()


# -- supervisor side ----------------------------------------------------------


class ResizeController:
    """The supervisor's half of the elastic loop: the armed request and the
    relaunch-argv rewrite. The `Supervisor` calls

      - `poll()` each monitor cycle: arms from the trigger file (or a
        SIGUSR2 routed to `signal_resize`) and returns the request once, so
        the supervisor can signal the child and emit `resize_request`;
      - `take()` after a child exits `EXIT_RESIZE`: the armed request, else
        a last-chance file claim (the chaos drill's child writes the file
        and exits faster than the poll cadence), else an empty request;
      - `apply(req, argv)` before the relaunch: rewrites argv in place (the
        device-count append, the cadence override); the child's environment
        stays as it was (the JAX controller's compile-cache rotation has no
        counterpart here).
    """

    def __init__(self, telemetry_dir: str, *,
                 device_flag: str = "",
                 slow_cadence: int = 0,
                 poll_gate_secs: float = 0.5):
        self.telemetry_dir = telemetry_dir
        self.device_flag = device_flag  # "" = pick from the argv itself
        self.slow_cadence = int(slow_cadence)
        self.poll_gate_secs = float(poll_gate_secs)
        self.armed: ResizeRequest | None = None
        self.armed_at_wall: float = 0.0
        self.resizes_applied = 0
        self._signal_flag = threading.Event()
        self._last_poll = float("-inf")

    def signal_resize(self) -> None:
        """The supervisor's SIGUSR2 entry point (`moco_tpu_torch.supervise`
        installs it): arm a resize with the trigger file's payload when one
        is pending, else an empty request. Safe in a signal handler: an
        Event set; the next poll does the file I/O."""
        self._signal_flag.set()

    def poll(self, now: float | None = None) -> ResizeRequest | None:
        """A newly armed request, exactly once per arming; None otherwise."""
        if self.armed is not None:
            return None  # already armed: waiting for the child to exit
        via_signal = self._signal_flag.is_set()
        now = time.monotonic() if now is None else now
        if not via_signal and now - self._last_poll < self.poll_gate_secs:
            return None
        self._last_poll = now
        req = consume_resize_request(self.telemetry_dir)
        if via_signal:
            self._signal_flag.clear()
            if req is None:
                # the CHILD's listener may have won the claim between the
                # operator's write and this SIGUSR2: the payload (the target
                # count) survives at the honored path
                req = read_honored_request(self.telemetry_dir)
            if req is None:
                req = ResizeRequest(source="sigusr2")
            else:
                req.source = "sigusr2"
        if req is not None:
            self.armed = req
            self.armed_at_wall = time.time()
        return req

    def take(self) -> ResizeRequest:
        """Claim the request a just-exited `EXIT_RESIZE` child honored: the
        armed one, else an unconsumed file, else the honored file the
        child's own poll claimed, else an empty request."""
        req = (self.armed
               or consume_resize_request(self.telemetry_dir)
               or read_honored_request(self.telemetry_dir, source="exit"))
        if req is None:
            req = ResizeRequest(source="exit")
        if not self.armed_at_wall:
            self.armed_at_wall = time.time()
        self.armed = None
        return req

    def cadence_override(self, req: ResizeRequest) -> int | None:
        """The `--grad-sync-cadence` the relaunch carries: an explicit value
        wins; `slow=1` applies the configured slow-link cadence; neither
        means no override."""
        if req.grad_sync_cadence is not None:
            return req.grad_sync_cadence
        if req.slow and self.slow_cadence > 0:
            return self.slow_cadence
        return None

    def apply(self, req: ResizeRequest, argv: list[str]) -> dict:
        """Rewrite the relaunch argv IN PLACE for the resize; returns a
        summary for the `resize_relaunch` incident. Appends (argparse
        last-wins) rather than edits: the operator's argv stays visible in
        the launch record, and repeated resizes stack."""
        old_devices = argv_device_count(argv)
        summary: dict = {"source": req.source, "devices_from": old_devices}
        if req.devices is not None:
            flag = self.device_flag or pick_device_flag(argv)
            argv += [flag, str(int(req.devices))]
            summary["devices_to"] = int(req.devices)
            summary["device_flag"] = flag
        else:
            summary["devices_to"] = None  # whatever the hardware shows
        cadence = self.cadence_override(req)
        if cadence is not None:
            argv += ["--grad-sync-cadence", str(int(cadence))]
            summary["grad_sync_cadence"] = int(cadence)
        if req.sharding is not None:
            argv += ["--sharding", req.sharding]
            summary["sharding"] = req.sharding
        try:
            # honored payload applied: a stale copy must not leak into a
            # later payload-less resize's take()
            os.remove(request_path(self.telemetry_dir) + HONORED_SUFFIX)
        except OSError:
            pass
        self.resizes_applied += 1
        self.armed_at_wall = 0.0
        return summary
