"""The JAX driver and the port's under the same injected faults: the
epoch-spanning rollback, and a rollback followed by a SIGTERM. The JAX
driver runs on the 8-device CPU mesh (`mesh8`), as `tests/test_resilience.py`
runs it, the port in one process, each with `tests/test_resilience.py`'s
`micro_config` and its telemetry on. Compared: the `rollback`, `sentinel`
and `preempt` incident records of `events.jsonl` (the same kind and
message: the poisoned step, the restored step and the skipped `(epoch,
batch)`), the position sidecar of every kept checkpoint, and the final
step.
"""

import json
import os

import pytest

from moco_tpu.config import get_preset as jax_preset
from moco_tpu.resilience import ChaosPlan as JaxPlan
from moco_tpu.resilience import chaos_context as jax_chaos
from moco_tpu.train import train as jax_train
from moco_tpu_torch import train
from moco_tpu_torch.checkpoint import read_position
from moco_tpu_torch.config import get_preset
from moco_tpu_torch.resilience import ChaosPlan, chaos_context

INCIDENTS = ("rollback", "sentinel", "preempt")


def _config(get, tmp_path, **overrides):
    base = dict(arch="resnet_tiny", dataset="synthetic", image_size=16, batch_size=16,
                num_negatives=64, embed_dim=32, lr=0.1, epochs=3, steps_per_epoch=4,
                ckpt_dir=str(tmp_path / "ckpt"), tb_dir="", print_freq=1000,
                num_classes=10, knn_monitor=False, telemetry_dir=str(tmp_path / "tel"),
                heartbeat_secs=0.0)
    base.update(overrides)
    return get("cifar10-moco-v1").replace(**base)


def _incidents(config) -> list[tuple[str, str]]:
    with open(os.path.join(config.telemetry_dir, "events.jsonl")) as f:
        records = [json.loads(line) for line in f]
    return [(r["event"], r["msg"]) for r in records
            if r.get("kind") == "event" and r.get("event") in INCIDENTS]


def _positions(ckpt_dir) -> dict[int, tuple[int, int]]:
    steps = sorted(int(n) for n in os.listdir(ckpt_dir) if n.isdigit())
    return {s: read_position(ckpt_dir, s) for s in steps}


def _both(mesh8, tmp_path, faults: dict, **overrides):
    jcfg = _config(jax_preset, tmp_path / "jax", **overrides)
    with jax_chaos(JaxPlan(**faults)):
        jstate, _ = jax_train(jcfg, mesh8)
    cfg = _config(get_preset, tmp_path / "port", **overrides)
    with chaos_context(ChaosPlan(**faults)):
        state, history = train.train(cfg, device="cpu", on_step=lambda *a: None)
    return (jcfg, int(jstate.step)), (cfg, state.step, history)


@pytest.mark.chaos
def test_epoch_spanning_rollback_matches_the_jax_driver(mesh8, tmp_path):
    (jcfg, jstep), (cfg, step, _) = _both(
        mesh8, tmp_path, dict(nan_at_step=7), epochs=4, steps_per_epoch=2,
        ckpt_every_epochs=2, max_rollbacks=3, print_freq=1)
    assert step == jstep == 5
    incidents = _incidents(cfg)
    assert incidents == _incidents(jcfg)
    assert incidents == [
        ("sentinel", "non-finite loss nan at step 7; requesting rollback"),
        ("rollback", "advancing the data stream past the poisoned window: restored step 4, "
                     "skipping through batch 0 of epoch 3")]
    assert _positions(cfg.ckpt_dir) == _positions(jcfg.ckpt_dir) == {4: (2, 0), 5: (4, 0)}


@pytest.mark.chaos
def test_rollback_drift_then_sigterm_matches_the_jax_driver(mesh8, tmp_path):
    (jcfg, jstep), (cfg, step, history) = _both(
        mesh8, tmp_path, dict(nan_at_step=3, sigterm_at_step=4), epochs=2)
    assert step == jstep == 4 and history[-1] == {"step": 4, "preempted": True}
    incidents = _incidents(cfg)
    assert incidents == _incidents(jcfg)
    assert [kind for kind, _ in incidents] == ["sentinel", "rollback", "preempt"]
    assert incidents[1][1].endswith("restored step 0, skipping through batch 2 of epoch 0")
    # the epoch-0 save after the skipped window, and the emergency one at
    # epoch 1's batch 3
    assert _positions(cfg.ckpt_dir) == _positions(jcfg.ckpt_dir) == {1: (1, 0), 4: (1, 3)}
