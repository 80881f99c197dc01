"""The port's driver under injected faults on the CPU, with the step counts
of the JAX package's own scenarios (`tests/test_resilience.py`, whose
`micro_config` sizes these runs): a NaN rolled back, a rollback window
across epochs, a preemption and its bit-for-bit resume (after a rollback
too), a structural NaN exhausting the rollbacks, no checkpoint directory;
then what the JAX tests do not cover in the port: the collapse rollback,
the v3 step's rollback, `debug_nans`, the watchdog in the loop, the CLI's
exit codes, and a SIGTERM to one of two gloo ranks.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from moco_tpu_torch import checkpoint as ckpt
from moco_tpu_torch import train
from moco_tpu_torch.config import PRESETS, get_preset
from moco_tpu_torch.resilience import (
    ChaosPlan,
    NonFiniteLossError,
    RollbackExhaustedError,
    StepWatchdog,
    active_chaos,
    chaos_context,
    manifest_path,
)
from moco_tpu_torch.utils import logging as mlog
from torch_dist_worker import spawn

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
QUIET = dict(device="cpu", on_step=lambda *a: None)


@pytest.fixture(autouse=True)
def _one_thread():
    """The runs are tiny: one intra-op thread each keeps them from
    contending with the other test workers for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def micro_config(tmp_path, **overrides):
    """`tests/test_resilience.py::micro_config` in the port."""
    base = dict(arch="resnet_tiny", dataset="synthetic", image_size=16, batch_size=16,
                num_negatives=64, embed_dim=32, lr=0.1, epochs=3, steps_per_epoch=4,
                ckpt_dir=str(tmp_path / "ckpt"), tb_dir="", print_freq=1000,
                num_classes=10, knn_monitor=False)
    base.update(overrides)
    return get_preset("cifar10-moco-v1").replace(**base)


def assert_same_state(a, b):
    for name in ("model_q", "model_k"):
        sa, sb = getattr(a, name).state_dict(), getattr(b, name).state_dict()
        assert sa.keys() == sb.keys()
        for k in sa:
            assert torch.equal(sa[k], sb[k]), f"{name}.{k}"
    oa, ob = a.optimizer.state_dict()["state"], b.optimizer.state_dict()["state"]
    assert oa.keys() == ob.keys() and oa
    for i in oa:
        for k in oa[i]:
            assert torch.equal(torch.as_tensor(oa[i][k]), torch.as_tensor(ob[i][k])), (i, k)
    assert (a.queue is None) == (b.queue is None)
    if a.queue is not None:
        assert torch.equal(a.queue, b.queue)
    assert (a.step, a.queue_ptr) == (b.step, b.queue_ptr)
    assert torch.equal(a.data_generator.get_state(), b.data_generator.get_state())


class _Events:
    """The `log_event` kinds and messages of a block."""

    def __init__(self):
        self.seen = []

    def __call__(self, kind, msg, fields):
        self.seen.append((kind, msg))

    def __enter__(self):
        mlog.add_event_sink(self)
        return self

    def __exit__(self, *exc):
        mlog.remove_event_sink(self)

    def kinds(self):
        return [k for k, _ in self.seen]


# ---------------------------------------------------------------------------
# the JAX package's scenarios, with its step counts
# ---------------------------------------------------------------------------


@pytest.mark.chaos
def test_nan_rollback_completes_without_intervention(tmp_path):
    """NaN at step 6 (epoch 1, batch 1): restored at step 4, epoch 1's
    batches 0-1 skipped, so the run ends at step 10."""
    cfg = micro_config(tmp_path, max_rollbacks=3)
    with _Events() as ev, chaos_context(ChaosPlan(nan_at_step=6)):
        state, history = train.train(cfg, **QUIET)
    assert state.step == 10
    assert ev.kinds().count("rollback") == 2 and "sentinel" in ev.kinds()
    assert ckpt.checkpoint_manager(cfg.ckpt_dir).all_steps() == [4, 6, 10]
    assert ckpt.read_position(cfg.ckpt_dir, 6) == (2, 0)


@pytest.mark.chaos
def test_nan_rollback_spans_epoch_boundaries(tmp_path):
    """NaN at step 7 with a checkpoint every 2 epochs: restored at step 4,
    epoch 2 skipped whole, epoch 3 after its batch 0: the run ends at 5."""
    cfg = micro_config(tmp_path, epochs=4, steps_per_epoch=2, ckpt_every_epochs=2,
                       max_rollbacks=3, print_freq=1)
    with chaos_context(ChaosPlan(nan_at_step=7)):
        state, history = train.train(cfg, **QUIET)
    assert state.step == 5 and np.isfinite(history[-1]["loss"])
    assert ckpt.checkpoint_manager(cfg.ckpt_dir).all_steps() == [4, 5]


@pytest.mark.chaos
def test_sigterm_emergency_checkpoint_then_bitidentical_resume(tmp_path):
    ref, ref_hist = train.train(micro_config(tmp_path / "a", print_freq=1), **QUIET)
    assert ref.step == 12
    cfg = micro_config(tmp_path / "b", print_freq=1)
    with _Events() as ev, chaos_context(ChaosPlan(sigterm_at_step=6)):
        mid, mid_hist = train.train(cfg, **QUIET)
    # step 6 is epoch 1's batch 1: only the emergency path can have saved it
    assert mid.step == 6 and mid_hist[-1] == {"step": 6, "preempted": True}
    assert ckpt.checkpoint_manager(cfg.ckpt_dir).all_steps() == [4, 6]
    assert ckpt.read_position(cfg.ckpt_dir, 6) == (1, 2)
    assert os.path.exists(manifest_path(cfg.ckpt_dir, 6))
    assert [m for k, m in ev.seen if k == "preempt"][0].startswith("caught signal 15")
    resumed, res_hist = train.train(cfg.replace(resume="auto"), **QUIET)
    assert resumed.step == 12
    assert [h["loss"] for h in res_hist] == [h["loss"] for h in ref_hist[6:]]
    assert_same_state(resumed, ref)


@pytest.mark.chaos
def test_resume_after_rollback_drift_is_bitidentical(tmp_path):
    """After a rollback has drifted the step-to-batch mapping, a preemption
    resumes from the position sidecar, not from step arithmetic."""
    a = micro_config(tmp_path / "a", epochs=2)
    with chaos_context(ChaosPlan(nan_at_step=3)):
        ref, _ = train.train(a, **QUIET)  # rolled back at 3, ends at 5
    assert ref.step == 5
    b = micro_config(tmp_path / "b", epochs=2)
    with chaos_context(ChaosPlan(nan_at_step=3, sigterm_at_step=4)):
        mid, _ = train.train(b, **QUIET)
    assert mid.step == 4 and ckpt.read_position(b.ckpt_dir, 4) == (1, 3)
    resumed, _ = train.train(b.replace(resume="auto"), **QUIET)
    assert resumed.step == 5
    assert_same_state(resumed, ref)


@pytest.mark.chaos
def test_structural_nan_exhausts_rollbacks(tmp_path):
    cfg = micro_config(tmp_path, steps_per_epoch=2, epochs=2, max_rollbacks=1)
    with chaos_context(ChaosPlan(nan_at_step=3, nan_count=10)):
        with pytest.raises(RollbackExhaustedError, match="2 consecutive rollbacks"):
            train.train(cfg, **QUIET)


@pytest.mark.chaos
@pytest.mark.parametrize("knob", [dict(ckpt_dir=""), dict(max_rollbacks=0)])
def test_nan_without_a_rollback_raises_directly(knob, tmp_path):
    cfg = micro_config(tmp_path, epochs=1, **knob)
    with chaos_context(ChaosPlan(nan_at_step=2)):
        with pytest.raises(NonFiniteLossError) as exc:
            train.train(cfg, **QUIET)
    assert exc.value.step == 2 and exc.value.pos == (0, 1)


@pytest.mark.chaos
def test_loader_fault_retried_through_train(tmp_path):
    cfg = micro_config(tmp_path, ckpt_dir="", epochs=1, loader_retries=3,
                       loader_backoff_secs=0.01, print_freq=1)
    with chaos_context(ChaosPlan(loader_error_at_batch=1, loader_error_count=2)) as plan:
        state, history = train.train(cfg, **QUIET)
    assert state.step == 4 and plan._loader_errors_raised == 2
    assert np.isfinite(history[-1]["loss"])


@pytest.mark.chaos
def test_config_chaos_plan_is_scoped_to_the_call(tmp_path, monkeypatch):
    """A `chaos` plan gets its state directory from MOCO_TPU_CHAOS_STATE
    and is cleared after the call; an already active plan wins."""
    captured = {}
    real_clear = train.clear_chaos

    def spy_clear():
        captured["plan"] = active_chaos()
        real_clear()

    monkeypatch.setattr(train, "clear_chaos", spy_clear)
    monkeypatch.setenv("MOCO_TPU_CHAOS_STATE", str(tmp_path / "markers"))
    cfg = micro_config(tmp_path, ckpt_dir="", epochs=1, chaos="nan_at_step=99")
    train.train(cfg, **QUIET)
    assert captured["plan"].state_dir == str(tmp_path / "markers")
    assert active_chaos() is None
    with _Events() as ev, chaos_context(ChaosPlan(nan_at_step=98)) as plan:
        train.train(cfg, **QUIET)
        assert active_chaos() is plan
    assert any(k == "chaos" and "IGNORED" in m for k, m in ev.seen)


# ---------------------------------------------------------------------------
# the port's own cases
# ---------------------------------------------------------------------------


@pytest.mark.chaos
def test_collapse_rollback_rolls_back(tmp_path):
    """`collapse_rollback=True` (refused before this slice): the fired
    predicate raises into the rollback; the wedged-momentum drill keeps
    crushing the key encoder after every restore, so the budget of one
    rollback runs out."""
    cfg = micro_config(
        tmp_path, steps_per_epoch=10, epochs=3, ckpt_every_epochs=1, health_stride=2,
        collapse_window=3, collapse_emb_std=1e-4, collapse_min_step=4,
        collapse_rollback=True, max_rollbacks=1)
    with _Events() as ev, chaos_context(ChaosPlan(collapse_at_step=12)):
        with pytest.raises(RollbackExhaustedError):
            train.train(cfg, **QUIET)
    health = [m for k, m in ev.seen if k == "health"]
    assert health and "'emb_std'" in health[0] and "requesting rollback" in health[0]
    rollbacks = [m for k, m in ev.seen if k == "rollback"]
    assert rollbacks[0].startswith("representation collapse at step")
    assert any(m.startswith("advancing the data stream") for m in rollbacks)


@pytest.mark.chaos
def test_v3_rollback_and_the_pass_resumed_by_hand(tmp_path):
    """The v3 step rolls back through the same driver: NaN at step 3 (epoch
    1's batch 0), restored at step 2, final step 5; the end state equals a
    pass resumed from step 2 with the same skip, bit for bit."""
    cfg = PRESETS["imagenet-moco-v3-vits"].replace(
        dataset="synthetic", arch="vit_tiny", image_size=32, batch_size=8, embed_dim=16,
        steps_per_epoch=2, epochs=3, print_freq=1, ckpt_dir=str(tmp_path / "ck"))
    with chaos_context(ChaosPlan(nan_at_step=3)):
        state, history = train.train(cfg, **QUIET)
    assert state.step == 5 and np.isfinite(history[-1]["loss"])
    ref, _ = train._train_once(
        cfg.replace(ckpt_dir=str(tmp_path / "ref"), resume=str(tmp_path / "ck" / "2")),
        None, "cpu", None, QUIET["on_step"], None, data_advance=3, poison_pos=(1, 0))
    assert_same_state(state, ref)


@pytest.mark.chaos
def test_debug_nans_raises_on_the_print_step(tmp_path):
    """`debug_nans`: the print step's loss check raises FloatingPointError
    itself (not the sentinel's subclass), and autograd's anomaly mode is
    on for the run only."""
    seen = []
    real_build = train.build_train_step

    def build(*a, **kw):
        seen.append((torch.is_anomaly_enabled(), torch.is_anomaly_check_nan_enabled()))
        return real_build(*a, **kw)

    train.build_train_step = build
    try:
        cfg = micro_config(tmp_path, ckpt_dir="", epochs=1, debug_nans=True, print_freq=1)
        with chaos_context(ChaosPlan(nan_at_step=2)):
            with pytest.raises(FloatingPointError) as exc:
                train.train(cfg, **QUIET)
    finally:
        train.build_train_step = real_build
    assert type(exc.value) is FloatingPointError and "at step 2" in str(exc.value)
    assert seen == [(True, True)] and not torch.is_anomaly_enabled()


@pytest.mark.chaos
def test_watchdog_flags_the_slow_step_in_the_loop(tmp_path, monkeypatch):
    made = []

    class Kept(StepWatchdog):
        def __init__(self, interval):
            super().__init__(interval)
            made.append(self)

    monkeypatch.setattr(train, "StepWatchdog", Kept)
    cfg = micro_config(tmp_path, ckpt_dir="", epochs=1, watchdog_secs=0.5)
    with _Events() as ev, chaos_context(ChaosPlan(slow_at_step=2, slow_ms=2000)):
        state, _ = train.train(cfg, **QUIET)
    assert state.step == 4 and made[0].stalls >= 1
    assert any(k == "watchdog" and "last completed step 1" in m for k, m in ev.seen)


def _cli(tmp_path, *flags):
    cmd = [sys.executable, "-m", "moco_tpu_torch.train", "--preset", "cifar10-moco-v1",
           "--device", "cpu", "--dataset", "synthetic", "--arch", "resnet_tiny",
           "--image-size", "16", "--batch-size", "16", "--num-negatives", "64",
           "--embed-dim", "32", "--knn-monitor", "false", "--epochs", "2",
           "--ckpt-dir", str(tmp_path / "ck"), *flags]
    return subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=120,
                          env=dict(os.environ, OMP_NUM_THREADS="1"))


@pytest.mark.chaos
@pytest.mark.parametrize("flags, code", [
    (("--steps-per-epoch", "4", "--chaos", "sigterm_at_step=2"), 43),
    (("--steps-per-epoch", "2", "--chaos", "nan_at_step=3,nan_count=10",
      "--max-rollbacks", "1"), 44),
    (("--max-rollbacks", "-1"), 45),
])
def test_cli_exit_codes(flags, code, tmp_path):
    proc = _cli(tmp_path, *flags)
    assert proc.returncode == code, proc.stderr[-3000:] + proc.stdout[-3000:]
    assert "[exit]" in proc.stdout
    if code == 43:
        assert ckpt.checkpoint_manager(str(tmp_path / "ck")).all_steps() == [2]


TWO_RANKS = dict(variant="v2", arch="resnet_tiny", mlp_head=True, temperature=0.2,
                 aug_plus=True, cos=True, dataset="synthetic", image_size=16, batch_size=16,
                 num_negatives=32, embed_dim=16, epochs=2, lr=0.03, seed=3, print_freq=1,
                 staging_workers=2, steps_per_epoch=8, resilience_sync_steps=2)


@pytest.mark.chaos
def test_sigterm_to_one_of_two_ranks(tmp_path):
    """SIGTERM on rank 1 alone after step 3: the ranks agree on it at the
    next sync step (4), both stop there, rank 0 writes one emergency
    checkpoint, and the resumed 2-rank run equals the uninterrupted one bit
    for bit."""
    cfg = dict(TWO_RANKS, ckpt_dir=str(tmp_path / "ck"))
    spawn("run_preempted", 2, (cfg, str(tmp_path), 6, 128, 1, "sigterm_at_step=3"), 180.0)
    ranks = [torch.load(tmp_path / f"preempted_rank{r}.pt", weights_only=False)
             for r in range(2)]
    assert ckpt.read_position(cfg["ckpt_dir"], 4) == (0, 4)
    for r in ranks:
        assert r["steps_after_cut"] == [4]  # the one emergency checkpoint
        assert r["cut"]["step"] == 4 and r["cut_history"][-1] == {"step": 4, "preempted": True}
        assert r["whole"]["step"] == r["resumed"]["step"] == 6
        a, b = r["resumed"], r["whole"]
        assert a["queue_ptr"] == b["queue_ptr"] and torch.equal(a["queue"], b["queue"])
        for which in ("q", "k"):
            for key in a[which]:
                assert torch.equal(a[which][key], b[which][key]), (which, key)
        for i, s in a["optimizer"]["state"].items():
            assert torch.equal(s["momentum_buffer"], b["optimizer"]["state"][i]["momentum_buffer"])
        assert all(torch.equal(x, y) for x, y in zip(a["generators"], b["generators"]))
