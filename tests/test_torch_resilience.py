"""The port's resilience primitives on the CPU, against the JAX package's
where it has the same one: the NaN sentinel's one-step lag, the preemption
handler, the step watchdog, the chaos plan's spec grammar and fire-once
rules, the exit codes, checkpoint truncation, the Prefetcher's injected
read faults, the asynchronous save with its deferred manifest, and the
config's resilience knobs.

Every test that starts threads runs under a timeout of its own (`within`),
so a hang fails that test instead of the run; the watchdog's timings have
wide margins (a loaded machine delays its thread).
"""

import dataclasses
import functools
import os
import signal
import threading
import time

import numpy as np
import pytest
import torch

from moco_tpu.resilience import chaos as jchaos
from moco_tpu.resilience import exitcodes as jexit
from moco_tpu_torch import checkpoint as ckpt
from moco_tpu_torch.config import PretrainConfig, get_preset
from moco_tpu_torch.data import loader
from moco_tpu_torch.resilience import (
    EXIT_CODE_NAMES,
    ChaosPlan,
    NaNSentinel,
    NonFiniteLossError,
    PreemptionHandler,
    StepWatchdog,
    TransientDataError,
    chaos_context,
    exitcodes,
    parse_chaos_spec,
    truncate_checkpoint,
)
from moco_tpu_torch.resilience.integrity import manifest_path, verify_step
from moco_tpu_torch.train_state import create_train_state
from moco_tpu_torch.train_step import build_encoder, build_train_step
from moco_tpu_torch.utils import logging as mlog

TINY = dict(arch="resnet_tiny", image_size=32, batch_size=8, num_negatives=32, embed_dim=16,
            compute_dtype="float32", print_freq=1, dataset="synthetic")


def within(seconds: float):
    """Run the test body in a thread and fail the test if it has not
    finished after `seconds`."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            outcome = {}

            def run():
                try:
                    fn(*args, **kwargs)
                except BaseException as e:  # handed to the test's own thread below
                    outcome["err"] = e

            t = threading.Thread(target=run, daemon=True, name=f"test-{fn.__name__}")
            t.start()
            t.join(seconds)
            if t.is_alive():
                pytest.fail(f"{fn.__name__} did not finish within {seconds} s")
            if "err" in outcome:
                raise outcome["err"]
        return wrapper
    return deco


# ---------------------------------------------------------------------------
# NaN sentinel
# ---------------------------------------------------------------------------


def test_sentinel_detects_with_one_step_lag():
    """The JAX package's case: step k's value surfaces at step k+1's
    observe, with its step and position; flush checks the last one."""
    s = NaNSentinel()
    s.observe(1, torch.tensor(2.5))
    s.observe(2, float("inf"), pos=(0, 1))  # step 1 checked here; 2 held
    with pytest.raises(NonFiniteLossError) as exc:
        s.observe(3, torch.tensor(1.0))
    assert (exc.value.step, exc.value.value, exc.value.pos) == (2, float("inf"), (0, 1))
    s2 = NaNSentinel()
    s2.observe(7, torch.tensor(float("nan")))
    with pytest.raises(NonFiniteLossError):
        s2.flush()  # the last step is never left unchecked
    s2.flush()  # idempotent once drained
    assert (s.checks, s2.checks, s.blocked) == (2, 1, 0)


def test_sentinel_holds_a_copy_not_the_tensor():
    """A loss tensor the next step overwrites in place is checked as it was
    when observed."""
    loss = torch.tensor(1.5)
    s = NaNSentinel()
    s.observe(1, loss)
    loss.fill_(float("nan"))
    s.observe(2, torch.tensor(0.5))  # checks step 1's 1.5: no raise
    s.flush()


def test_sentinel_matches_the_jax_one_on_a_sequence():
    from moco_tpu.resilience.sentinel import NaNSentinel as JaxSentinel

    values = [1.0, 2.0, float("nan"), 3.0]
    outcomes = []
    for cls, wrap in ((JaxSentinel, float), (NaNSentinel, torch.tensor)):
        s, seen = cls(), []
        for step, v in enumerate(values, 1):
            try:
                s.observe(step, wrap(v), pos=(0, step - 1))
                seen.append(None)
            except FloatingPointError as e:  # each package's NonFiniteLossError
                seen.append((type(e).__name__, e.step, e.pos))
        outcomes.append(seen)
    assert outcomes[0] == outcomes[1] == [None, None, None, ("NonFiniteLossError", 3, (0, 2))]


# ---------------------------------------------------------------------------
# preemption handler
# ---------------------------------------------------------------------------


def test_preemption_flag_and_second_signal_chains():
    before = signal.getsignal(signal.SIGINT)
    with PreemptionHandler(signums=(signal.SIGINT,)) as h:
        assert not h.triggered
        signal.raise_signal(signal.SIGINT)
        assert h.triggered  # the first signal sets the flag only
        with pytest.raises(KeyboardInterrupt):  # the second: Python's default
            signal.raise_signal(signal.SIGINT)
    assert signal.getsignal(signal.SIGINT) is before


def test_preemption_second_signal_chains_to_a_callable():
    calls = []

    def custom(signum, frame):
        calls.append(signum)

    before = signal.signal(signal.SIGTERM, custom)
    try:
        with PreemptionHandler(signums=(signal.SIGTERM,)) as h:
            signal.raise_signal(signal.SIGTERM)
            assert h.triggered and not calls
            signal.raise_signal(signal.SIGTERM)
            assert calls == [signal.SIGTERM]
        assert signal.getsignal(signal.SIGTERM) is custom  # restored, not SIG_DFL
    finally:
        signal.signal(signal.SIGTERM, before)


@within(30)
def test_preemption_inert_off_the_main_thread():
    """A handler entered on a staging thread installs nothing, so it cannot
    take the signal from the main thread's."""
    out = {}
    before = signal.getsignal(signal.SIGTERM)

    def body():
        with PreemptionHandler() as h:
            out["triggered"] = h.triggered
            out["installed"] = signal.getsignal(signal.SIGTERM) is not before

    t = threading.Thread(target=body)
    t.start()
    t.join()
    assert out == {"triggered": False, "installed": False}


# ---------------------------------------------------------------------------
# step watchdog
# ---------------------------------------------------------------------------


@within(60)
def test_watchdog_flags_a_stall_and_rearms_on_beat():
    with StepWatchdog(0.2) as w:
        time.sleep(1.0)
        assert w.stalls >= 1
        w.beat(3)
        seen = w.stalls
        time.sleep(0.05)
        assert w.stalls == seen  # the beat re-armed the window
    assert w._thread is None


@within(60)
def test_watchdog_suspended_scopes_nest():
    """Inside suspended() nothing is flagged; an inner scope's exit keeps the
    outer one; after the outermost exit a real stall is flagged again."""
    with StepWatchdog(0.1) as w:
        w.beat(1)
        with w.suspended():
            with w.suspended():
                time.sleep(0.5)
            assert w._suspend == 1
            time.sleep(0.5)
            assert w.stalls == 0
        assert w._suspend == 0
        time.sleep(1.0)
        assert w.stalls >= 1


def test_watchdog_disabled_is_inert():
    with StepWatchdog(0.0) as w:
        w.beat(1)
        with w.suspended():
            pass
        assert w._thread is None and w.stalls == 0


# ---------------------------------------------------------------------------
# chaos plan
# ---------------------------------------------------------------------------


def _public_fields(plan):
    return {f.name: getattr(plan, f.name) for f in dataclasses.fields(plan)
            if not f.name.startswith("_")}


SPECS = ["sigterm_at_step=11, nan_at_step=3,nan_count=2",
         "kill_at_step=4,freeze_at_step=9,slow_at_step=2,slow_ms=50",
         "loader_error_at_batch=1,loader_error_count=2",
         "resize_at_step=6,devices=2",
         "collapse_at_step=5",
         "kill_at_request=3,wedge_at_request=4,kill_at_shard=1,stall_at_shard=2,stall_ms=7",
         "  "]


@pytest.mark.parametrize("spec", SPECS)
def test_parse_chaos_spec_equals_the_jax_parser(spec):
    ours, theirs = parse_chaos_spec(spec), jchaos.parse_chaos_spec(spec)
    if theirs is None:
        assert ours is None
    else:
        assert _public_fields(ours) == _public_fields(theirs)
    assert [f.name for f in dataclasses.fields(ChaosPlan)] == [
        f.name for f in dataclasses.fields(jchaos.ChaosPlan)]


def test_parse_chaos_spec_rejects_what_the_jax_parser_rejects():
    with pytest.raises(ValueError) as ours:
        parse_chaos_spec("sigterm_at=11")
    with pytest.raises(ValueError) as theirs:
        jchaos.parse_chaos_spec("sigterm_at=11")
    assert str(ours.value) == str(theirs.value)


def _drive(plan, loader_error):
    """The hooks the port polls, in a fixed sequence; what each returned or
    raised."""
    seen = []
    for step in range(1, 8):
        seen.append(("nan", step, plan.maybe_nan(step)))
        seen.append(("collapse", step, plan.maybe_collapse(step)))
        plan.maybe_slow(step)
        for b in range(3):
            try:
                plan.maybe_loader_error(b)
                seen.append(("loader", b, None))
            except loader_error as e:
                seen.append(("loader", b, str(e)))
    return seen


def test_chaos_faults_fire_as_the_jax_plan_fires_them():
    kw = dict(nan_at_step=4, nan_count=2, loader_error_at_batch=1, loader_error_count=2,
              collapse_at_step=5, slow_at_step=2, slow_ms=1)
    from moco_tpu.resilience.errors import TransientDataError as JaxTransient

    ours, theirs = _drive(ChaosPlan(**kw), TransientDataError), \
        _drive(jchaos.ChaosPlan(**kw), JaxTransient)
    assert ours == theirs
    assert [s for k, s, v in ours if k == "nan" and v] == [4]  # once a step number here
    assert sum(1 for k, _, v in ours if k == "loader" and v) == 2
    # nan_count counts traversals of the same step
    plan = ChaosPlan(nan_at_step=4, nan_count=2)
    assert [plan.maybe_nan(4) for _ in range(3)] == [True, True, False]


def test_fire_once_markers_survive_the_plan(tmp_path):
    """With a state directory a fire-once fault leaves the JAX package's
    marker before it fires, and a new plan on the same directory (a
    restarted process) never fires it again."""
    ours, theirs = tmp_path / "ours", tmp_path / "theirs"
    for plan_cls, d in ((ChaosPlan, ours), (jchaos.ChaosPlan, theirs)):
        with PreemptionHandler(signums=(signal.SIGTERM,)) as h:
            plan_cls(sigterm_at_step=2, state_dir=str(d)).maybe_sigterm(2)
            assert h.triggered
        with PreemptionHandler(signums=(signal.SIGTERM,)) as h:
            plan_cls(sigterm_at_step=2, state_dir=str(d)).maybe_sigterm(2)
            assert not h.triggered
    assert sorted(os.listdir(ours)) == sorted(os.listdir(theirs)) == ["fired_sigterm"]


def test_env_plan_and_chaos_context(monkeypatch, tmp_path):
    from moco_tpu_torch.resilience import active_chaos, clear_chaos

    monkeypatch.setenv("MOCO_TPU_CHAOS", "nan_at_step=5")
    monkeypatch.setenv("MOCO_TPU_CHAOS_STATE", str(tmp_path))
    try:
        plan = active_chaos()
        assert plan.nan_at_step == 5 and plan.state_dir == str(tmp_path)
        assert active_chaos() is plan  # kept for the process
    finally:
        clear_chaos()
    monkeypatch.delenv("MOCO_TPU_CHAOS")
    with pytest.raises(RuntimeError):
        with chaos_context(ChaosPlan(nan_at_step=1)):
            raise RuntimeError("the scenario raised")
    assert active_chaos() is None


# ---------------------------------------------------------------------------
# exit codes
# ---------------------------------------------------------------------------


def test_exit_codes_are_the_jax_packages():
    assert EXIT_CODE_NAMES == jexit.EXIT_CODE_NAMES
    names = [n for n in dir(jexit) if n.startswith("EXIT_") and n != "EXIT_CODE_NAMES"]
    assert names and all(getattr(exitcodes, n) == getattr(jexit, n) for n in names)
    assert (exitcodes.EXIT_PREEMPTED, exitcodes.EXIT_ROLLBACK_EXHAUSTED,
            exitcodes.EXIT_CONFIG_ERROR, exitcodes.EXIT_DATA_QUALITY,
            exitcodes.EXIT_RESIZE) == (43, 44, 45, 46, 49)


# ---------------------------------------------------------------------------
# checkpoints: truncation, the asynchronous save
# ---------------------------------------------------------------------------


def _stepped_state(seed=0, steps=1):
    config = get_preset("imagenet-moco-v2").replace(**TINY)
    state = create_train_state(config, build_encoder(config), "cpu", seed=seed)
    step = build_train_step(config, steps_per_epoch=4)
    rng = np.random.RandomState(seed)
    for _ in range(steps):
        im = torch.from_numpy(rng.randn(2, 8, 32, 32, 3).astype(np.float32))
        step(state, im[0], im[1])
    return config, state, step


def _states_equal(a, b) -> bool:
    for name in ("model_q", "model_k"):
        sa, sb = getattr(a, name).state_dict(), getattr(b, name).state_dict()
        if sa.keys() != sb.keys() or not all(torch.equal(sa[k], sb[k]) for k in sa):
            return False
    oa, ob = a.optimizer.state_dict()["state"], b.optimizer.state_dict()["state"]
    return (oa.keys() == ob.keys() and all(
        torch.equal(oa[i]["momentum_buffer"], ob[i]["momentum_buffer"]) for i in oa)
        and torch.equal(a.queue, b.queue) and (a.step, a.queue_ptr) == (b.step, b.queue_ptr)
        and torch.equal(a.generator.get_state(), b.generator.get_state())
        and torch.equal(a.data_generator.get_state(), b.data_generator.get_state()))


def test_truncate_checkpoint_halves_the_largest_file_as_the_jax_one_does(tmp_path):
    for name, fn in (("ours", truncate_checkpoint), ("theirs", jchaos.truncate_checkpoint)):
        d = tmp_path / name / "5" / "inner"
        d.mkdir(parents=True)
        (d / "payload.bin").write_bytes(b"x" * 4096)
        (tmp_path / name / "5" / "meta.json").write_text("{}")
        mangled = fn(str(tmp_path / name), 5)
        assert mangled.endswith("payload.bin") and os.path.getsize(mangled) == 2048
        with pytest.raises(FileNotFoundError):
            fn(str(tmp_path / name), 99)


def test_truncated_latest_step_walks_back(tmp_path):
    """A truncated newest step fails its manifest, and `resume auto` lands
    on the one before it."""
    config, state, step = _stepped_state()
    mgr = ckpt.checkpoint_manager(str(tmp_path))
    ckpt.save_checkpoint(mgr, state, 1, position=(0, 1))
    im = torch.zeros(2, 8, 32, 32, 3)
    step(state, im[0], im[1])
    ckpt.save_checkpoint(mgr, state, 2, position=(0, 2))
    truncate_checkpoint(str(tmp_path), 2)
    assert "size mismatch" in verify_step(str(tmp_path), 2)
    fresh = create_train_state(config, build_encoder(config), "cpu", seed=3)
    seen = []

    def sink(kind, msg, fields):
        seen.append((kind, msg))

    mlog.add_event_sink(sink)
    try:
        assert ckpt.maybe_resume(mgr, fresh, "auto").step == 1
    finally:
        mlog.remove_event_sink(sink)
    # the walk-back reaches the run's sinks (events.jsonl), as the JAX package's does
    assert [k for k, _ in seen] == ["ckpt-restore", "ckpt-restore"]
    assert seen[0][1].startswith("step 2 fails (size mismatch")


@within(120)
def test_async_save_restores_the_synchronous_saves_state(tmp_path):
    """A `wait=False` save of step s, with the state stepped in place right
    after it, restores to the same state bit for bit as a synchronous save
    of step s; its manifest appears only at `finalize_checkpoints`, and the
    position sidecar at once."""
    config, state, step = _stepped_state(steps=2)
    sync_mgr = ckpt.checkpoint_manager(str(tmp_path / "sync"))
    async_mgr = ckpt.checkpoint_manager(str(tmp_path / "async"))
    ckpt.save_checkpoint(sync_mgr, state, 2, position=(0, 2))
    ckpt.save_checkpoint(async_mgr, state, 2, position=(0, 2), wait=False)
    assert ckpt.read_position(async_mgr.directory, 2) == (0, 2)
    assert not os.path.exists(manifest_path(async_mgr.directory, 2))
    im = torch.ones(2, 8, 32, 32, 3)
    step(state, im[0], im[1])  # the next step, in place
    ckpt.finalize_checkpoints(async_mgr)
    assert os.path.exists(manifest_path(async_mgr.directory, 2))
    assert verify_step(async_mgr.directory, 2) is None
    ckpt.finalize_checkpoints(async_mgr)  # idempotent
    a = create_train_state(config, build_encoder(config), "cpu", seed=5)
    b = create_train_state(config, build_encoder(config), "cpu", seed=6)
    ckpt.restore_checkpoint(sync_mgr, a, 2)
    ckpt.restore_checkpoint(async_mgr, b, 2)
    assert _states_equal(a, b) and not _states_equal(b, state)


@within(120)
def test_async_saves_prune_after_the_writer(tmp_path):
    """Five async saves with max_to_keep 3: each save joins the writer
    before the next, so the kept steps and their sidecars are the last
    three; a step without a manifest (a writer that died) restores as
    unverified."""
    _, state, _ = _stepped_state()
    mgr = ckpt.checkpoint_manager(str(tmp_path), max_to_keep=3)
    for s in range(1, 6):
        ckpt.save_checkpoint(mgr, state, s, position=(s, 0), wait=False)
    assert mgr.pending_manifest == 5
    ckpt.finalize_checkpoints(mgr)
    assert mgr.all_steps() == [3, 4, 5]
    for sub in (".integrity", ".position"):
        kept = sorted(int(os.path.splitext(n)[0]) for n in os.listdir(tmp_path / sub))
        assert kept == [3, 4, 5], sub
    os.remove(manifest_path(str(tmp_path), 5))
    assert verify_step(str(tmp_path), 5) is None


@within(60)
def test_async_writer_error_surfaces_at_finalize(tmp_path, monkeypatch):
    _, state, _ = _stepped_state()
    mgr = ckpt.checkpoint_manager(str(tmp_path))

    def broken(step, payload):
        raise OSError("disk full")

    monkeypatch.setattr(mgr, "save", broken)
    ckpt.save_checkpoint(mgr, state, 1, wait=False)
    with pytest.raises(OSError, match="disk full"):
        ckpt.finalize_checkpoints(mgr)
    assert mgr.pending_manifest is None


# ---------------------------------------------------------------------------
# Prefetcher: injected read faults
# ---------------------------------------------------------------------------


class _Images:
    def __init__(self, n=32):
        rng = np.random.RandomState(0)
        self.imgs = rng.randint(0, 256, (n, 4, 4, 3)).astype(np.uint8)
        self.labels = np.arange(n, dtype=np.int32)
        self.extents = np.tile(np.asarray([4, 4, 0], np.int32), (n, 1))

    def __len__(self):
        return len(self.imgs)

    def get_batch(self, indices):
        return self.imgs[indices], self.labels[indices], self.extents[indices]


@pytest.mark.parametrize("workers", [1, 2])
@within(60)
def test_prefetcher_retries_injected_faults(workers):
    """Two injected faults at batch 1 within a budget of 3 retries: every
    batch arrives, equal to the fault-free ones."""
    data = _Images()
    ref = [tuple(t.numpy() for t in b)
           for b in loader.Prefetcher(data, np.arange(32), 8, "cpu", workers=workers)]
    with chaos_context(ChaosPlan(loader_error_at_batch=1, loader_error_count=2)) as plan:
        pf = loader.Prefetcher(data, np.arange(32), 8, "cpu", retries=3, backoff_secs=0.01,
                               workers=workers)
        got = [tuple(t.numpy() for t in b) for b in pf]
        pf.close()
    assert plan._loader_errors_raised == 2 and len(got) == len(ref) == 4
    for a, b in zip(ref, got):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)


@within(60)
def test_prefetcher_exhausted_retries_raise():
    with chaos_context(ChaosPlan(loader_error_at_batch=0, loader_error_count=9)):
        pf = loader.Prefetcher(_Images(), np.arange(32), 8, "cpu", retries=2,
                               backoff_secs=0.01)
        with pytest.raises(TransientDataError, match="injected read failure 3/9"):
            list(pf)
        pf.close()  # delivered through the iterator: close does not raise it again


@within(60)
def test_prefetcher_close_mid_backoff_is_silent():
    """close() while a worker waits out a 30 s backoff wakes it at once and
    raises nothing: the fault was still within its budget."""
    with chaos_context(ChaosPlan(loader_error_at_batch=0, loader_error_count=5)) as plan:
        pf = loader.Prefetcher(_Images(), np.arange(32), 8, "cpu", retries=9,
                               backoff_secs=30.0)
        deadline = time.monotonic() + 10.0
        while not plan._loader_errors_raised and time.monotonic() < deadline:
            time.sleep(0.01)
        time.sleep(0.05)
        t0 = time.monotonic()
        pf.close()
        assert time.monotonic() - t0 < 10.0
    assert pf._err is None and not pf._thread.is_alive()


def test_epoch_loader_takes_the_configs_retry_policy(monkeypatch):
    """The driver hands `loader_retries`/`loader_backoff_secs` to each
    epoch's Prefetcher."""
    from moco_tpu_torch import train

    seen = []
    real = train.epoch_loader

    def spy(*args, **kw):
        seen.append((kw["retries"], kw["backoff_secs"]))
        return real(*args, **kw)

    monkeypatch.setattr(train, "epoch_loader", spy)
    config = get_preset("imagenet-moco-v2").replace(**TINY, loader_retries=7,
                                                    loader_backoff_secs=0.25)
    with chaos_context(ChaosPlan(loader_error_at_batch=0, loader_error_count=1)):
        state, _ = train.train(config, max_steps=1, device="cpu", on_step=lambda *a: None)
    assert seen == [(7, 0.25)] and state.step == 1


# ---------------------------------------------------------------------------
# config
# ---------------------------------------------------------------------------


_NEW_FIELDS = ("loss_sentinel", "max_rollbacks", "watchdog_secs", "loader_retries",
               "loader_backoff_secs", "chaos", "debug_nans", "collapse_rollback")


def test_resilience_fields_take_the_jax_defaults():
    from moco_tpu.config import PretrainConfig as JaxConfig

    assert {f: getattr(PretrainConfig(), f) for f in _NEW_FIELDS} == {
        f: getattr(JaxConfig(), f) for f in _NEW_FIELDS}


@pytest.mark.parametrize("bad, match", [
    (dict(max_rollbacks=-1), "max_rollbacks must be >= 0"),
    (dict(watchdog_secs=-0.5), "watchdog_secs must be >= 0"),
    (dict(loader_retries=-1), "loader_retries must be >= 0"),
    (dict(loader_backoff_secs=-1.0), "loader_backoff_secs must be >= 0"),
    (dict(chaos="resize_at_step=3,devices=two"), "invalid literal for int"),
])
def test_config_rejects_bad_resilience_knobs(bad, match):
    with pytest.raises(ValueError, match=match):
        PretrainConfig(**bad)


def test_config_rejects_a_chaos_spec_with_the_jax_parsers_message():
    with pytest.raises(ValueError) as ours:
        PretrainConfig(chaos="nan_at=3")
    with pytest.raises(ValueError) as theirs:
        jchaos.parse_chaos_spec("nan_at=3")
    assert str(ours.value) == str(theirs.value)


def test_config_accepts_collapse_rollback_and_the_flags():
    import argparse

    from moco_tpu_torch.config import add_config_flags, collect_overrides

    assert PretrainConfig(collapse_margin=0.01, collapse_rollback=True).collapse_rollback
    parser = argparse.ArgumentParser()
    add_config_flags(parser)
    args = parser.parse_args(["--chaos", "nan_at_step=3", "--max-rollbacks", "2",
                              "--watchdog-secs", "1.5", "--loss-sentinel", "false",
                              "--debug-nans", "true", "--loader-retries", "5",
                              "--loader-backoff-secs", "0.1"])
    assert collect_overrides(args) == dict(
        chaos="nan_at_step=3", max_rollbacks=2, watchdog_secs=1.5, loss_sentinel=False,
        debug_nans=True, loader_retries=5, loader_backoff_secs=0.1)
