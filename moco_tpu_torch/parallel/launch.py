"""The rank launcher behind `python -m moco_tpu_torch.train --num-devices N`:
N processes of the driver, one per card, as the reference's
`main_moco.py --multiprocessing-distributed` starts them with `mp.spawn`.

The port's counterpart of the JAX driver's `--num-devices N` is a process
count, because the port runs one process per card. A supervisor relaunches
a resized run by appending `--num-devices N` to its child's argv, reads the
child's own exit code and sends it SIGUSR2 to ask for a resize; torchrun as
that child would defeat all three: its count sits before the script, it
turns a rank's 43 or 49 into its own exit 1, and it does not handle SIGUSR2
(its default action kills torchrun and leaves the ranks behind). So the
driver launches its own ranks:

- each rank is `python -m moco_tpu_torch.train` with the same flags but
  `--num-devices`, and `RANK`, `LOCAL_RANK`, `WORLD_SIZE` set; they meet
  at a `file://` store in a new temporary directory (`ENV_INIT_METHOD`),
  so a relaunch never meets the group of a dying predecessor;
- each rank asks the kernel for SIGKILL when the launcher dies
  (`join_launcher`, `PR_SET_PDEATHSIG`): a launcher SIGKILLed by its
  supervisor leaves no rank holding a card; and it ignores SIGUSR2 except
  while the driver's resize listener holds it, so a forwarded request
  never kills a rank that is starting or already writing its checkpoint;
- SIGTERM, SIGINT, SIGUSR1 (the trace trigger) and SIGUSR2 (the resize)
  are forwarded to every rank;
- when one rank exits while others still run, those are waiting in a
  collective that will never complete: after `exit_grace_secs` they get
  SIGTERM, after `term_grace_secs` more SIGKILL;
- the launcher exits with one code: the ranks' shared code (the agreement
  on preemption and resize makes that the usual case), else the first
  failure's, a signal death raised again on the launcher itself so that
  its parent sees `returncode < 0` (`exit_with`).

The launcher itself never touches CUDA. Stdlib only.
"""

from __future__ import annotations

import ctypes
import os
import resource
import shutil
import signal
import subprocess
import sys
import tempfile
import time

from moco_tpu_torch.utils.logging import log_event

ENV_INIT_METHOD = "MOCO_TPU_DIST_INIT"        # the rendezvous of the launched ranks
ENV_LAUNCHER_PID = "MOCO_TPU_LAUNCHER_PID"    # the pid a rank dies with
DEVICE_FLAG = "--num-devices"
FORWARDED_SIGNALS = (signal.SIGTERM, signal.SIGINT, signal.SIGUSR1, signal.SIGUSR2)
_PR_SET_PDEATHSIG = 1


def strip_device_flag(argv: list[str]) -> list[str]:
    """`argv` without any `--num-devices N` / `--num-devices=N`."""
    out, i = [], 0
    while i < len(argv):
        if argv[i] == DEVICE_FLAG:
            i += 2
            continue
        if not argv[i].startswith(DEVICE_FLAG + "="):
            out.append(argv[i])
        i += 1
    return out


def join_launcher() -> None:
    """In a rank the launcher started: have the kernel SIGKILL this process
    when the launcher dies (`prctl(PR_SET_PDEATHSIG, SIGKILL)`), and die now
    if it already has; ignore SIGUSR2 (the resize listener installs its
    handler over that and puts it back). A no-op in any other process."""
    launcher = os.environ.get(ENV_LAUNCHER_PID)
    if not launcher:
        return
    signal.signal(signal.SIGUSR2, signal.SIG_IGN)
    libc = ctypes.CDLL(None, use_errno=True)
    if libc.prctl(_PR_SET_PDEATHSIG, int(signal.SIGKILL), 0, 0, 0) != 0:
        raise OSError(ctypes.get_errno(), "prctl(PR_SET_PDEATHSIG) failed")
    if os.getppid() != int(launcher):
        # the launcher died before the request took effect
        os.kill(os.getpid(), signal.SIGKILL)


def launch(n: int, argv: list[str], *, command: list[str] | None = None,
           exit_grace_secs: float = 10.0, term_grace_secs: float = 10.0,
           poll_secs: float = 0.05) -> int:
    """Run `n` ranks of `command + argv` (default: this interpreter on
    `-m moco_tpu_torch.train`) to their end and return the launcher's code:
    the ranks' shared exit code, else the first failure's (negative for a
    signal death, as `subprocess` reports it)."""
    command = list(command or [sys.executable, "-m", "moco_tpu_torch.train"])
    store = tempfile.mkdtemp(prefix="moco-rdzv-")
    env = dict(os.environ)
    env.update({ENV_INIT_METHOD: "file://" + os.path.join(store, "store"),
                ENV_LAUNCHER_PID: str(os.getpid()), "WORLD_SIZE": str(n)})
    procs: list[subprocess.Popen] = []

    def forward(signum, frame):
        for p in procs:
            if p.poll() is None:
                try:
                    p.send_signal(signum)
                except OSError:
                    pass  # exited between the poll and the signal

    # installed before the first rank starts: a signal in between is forwarded
    previous = {s: signal.signal(s, forward) for s in FORWARDED_SIGNALS}
    try:
        for r in range(n):
            procs.append(subprocess.Popen(
                command + list(argv),
                env=dict(env, RANK=str(r), LOCAL_RANK=str(r))))
        log_event("launch", f"{n} rank process(es), pids {[p.pid for p in procs]}",
                  pids=[p.pid for p in procs])
        exited: list[int] = []   # ranks in the order their exits were seen
        first_exit = term_at = kill_at = None
        while len(exited) < n:
            for r, p in enumerate(procs):
                if r not in exited and p.poll() is not None:
                    exited.append(r)
            if len(exited) == n:
                break
            now = time.monotonic()
            if exited and first_exit is None:
                first_exit = now
                term_at = now + exit_grace_secs
            if term_at is not None and now >= term_at:
                log_event("launch", f"rank {exited[0]} exited "
                                    f"{procs[exited[0]].returncode}; sending SIGTERM to the "
                                    "ranks still running")
                forward(signal.SIGTERM, None)
                term_at, kill_at = None, now + term_grace_secs
            if kill_at is not None and now >= kill_at:
                log_event("launch", "ranks still running after SIGTERM: SIGKILL")
                for p in procs:
                    if p.poll() is None:
                        p.kill()
                kill_at = None
            time.sleep(poll_secs)
    finally:
        for p in procs:
            # only on the way out by an exception: a rank must not outlive us
            if p.poll() is None:
                p.kill()
                p.wait()
        for s, h in previous.items():
            # a supervisor's SIGUSR2 may still be on its way: on this
            # (exiting) process it must not be fatal
            signal.signal(s, signal.SIG_IGN if s == signal.SIGUSR2 else h)
        shutil.rmtree(store, ignore_errors=True)
    codes = [p.returncode for p in procs]
    log_event("launch", f"rank exit codes {codes}, in the order {exited}",
              codes=codes, order=exited)
    if len(set(codes)) == 1:
        return codes[0]
    return next(procs[r].returncode for r in exited if procs[r].returncode != 0)


def exit_with(code: int) -> None:
    """Exit with a launcher code: a negative one by raising that signal on
    this process (its default action, no core file), so the parent sees the
    same signal death the rank had."""
    if code < 0:
        sig = -code
        resource.setrlimit(resource.RLIMIT_CORE, (0, 0))
        signal.signal(sig, signal.SIG_DFL)
        os.kill(os.getpid(), sig)
        time.sleep(1.0)  # a signal whose default action is to ignore it
        code = 128 + sig
    sys.exit(code)
