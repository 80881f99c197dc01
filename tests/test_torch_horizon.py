"""The port's learning horizon (`python -m moco_tpu_torch.horizon`) against
the JAX package's tool (`tools/_horizon_run.py`, `tests/test_horizon_tool.py`)
on the CPU.

- Resume hygiene: a resume with changed flags, no fingerprint, a dead
  untrained-baseline sidecar, or an old fingerprint without the arch keys
  (accepted, then refused at the sidecar) exits 4 before any step; a run
  resumed after its final step exits 3; a short run fails its gates (exit
  1) with its record printed. The entry point runs in this process
  (`horizon.main`), the fail-fast cases exit before any model is built.
- The sidecar round trip at the driver level, as the JAX tool's test.
- The horizon's config through both drivers, `moco_tpu.train.train` on a
  one-device mesh and the port's `train.train`, at `--arch resnet_tiny
  --image-size 16`, from the same initial weights (the JAX state carried
  over by `moco_tpu_torch/weights.py`) and the same views: the two
  frameworks draw their augmentations from different generators, so both
  drivers take a deterministic view pair (the eval transform at crop
  fractions 1.0 and 0.75) in place of the v1 recipe. The untrained kNN
  baseline and the final kNN are equal; over 8 steps the losses agree
  within rtol 2e-4, the tolerance of `tests/test_torch_train_step.py` (the
  golden test's), and over 160 steps within 2e-3.
"""

import json
import math

import jax
import numpy as np
import pytest
import torch

import moco_tpu.train as jtrain
import moco_tpu.train_step as jtrain_step
from moco_tpu.config import get_preset as jax_preset
from moco_tpu.data import augment as jaug
from moco_tpu.data.datasets import SyntheticTextureDataset as JaxTexture
from moco_tpu.parallel.mesh import create_mesh
from moco_tpu.train_state import create_train_state as jax_create_train_state
from moco_tpu.train_step import build_encoder as jax_build_encoder
from moco_tpu.train_step import build_optimizer as jax_build_optimizer
from moco_tpu_torch import horizon, train
from moco_tpu_torch.config import get_preset
from moco_tpu_torch.data import augment as aug
from moco_tpu_torch.data.datasets import SyntheticTextureDataset
from moco_tpu_torch.weights import params_from_jax

# the fingerprint of --steps 4 --batch 16 --samples 16 on the CPU: 16
# samples, one step an epoch, 4 epochs
ARGS_4_16 = {"steps": 4, "batch": 16, "samples": 16, "arch": "resnet18", "image_size": 32,
             "lr": 0.03, "momentum_ema": 0.99, "backend": "cpu", "compute_dtype": "float32"}
SMALL = ["--steps", "4", "--batch", "16", "--samples", "16", "--device", "cpu"]
TINY = ["--arch", "resnet_tiny", "--image-size", "16"]
LOSS_RTOL = 2e-4
# (flags, (samples, steps an epoch, epochs, steps), loss rtol): 8 steps at
# the train-step tests' tolerance; 160 steps (10 epochs, the cosine decay
# and the queue's refills under way) at a tolerance that leaves room for
# f32 rounding, which the two frameworks' kernels do differently and the
# training amplifies. The long run is `slow` (about 35 s alone, minutes
# beside other test processes): `pytest tests/test_torch_horizon.py -m slow`
PARITY_RUNS = {
    "8_steps": (["--samples", "64", "--steps", "8", "--knn-every", "1"], (64, 4, 2, 8),
                LOSS_RTOL),
    "160_steps": (["--samples", "256", "--steps", "160", "--knn-every", "5"],
                  (256, 16, 10, 160), 2e-3),
}


def _run(capsys, argv) -> tuple[int, str]:
    with pytest.raises(SystemExit) as e:
        horizon.main(argv)
    return e.value.code, capsys.readouterr().out


def _fake_ckpt(tmp_path, run_args=None, sidecar=None) -> str:
    ck = tmp_path / "ck"
    ck.mkdir()
    (ck / "100").mkdir()  # a step directory: a checkpoint exists
    if run_args is not None:
        (ck / "horizon_args.json").write_text(json.dumps(run_args))
    if sidecar is not None:
        (ck / "untrained_baseline.json").write_text(sidecar)
    return str(ck)


RESUME_REFUSALS = {
    "changed_flags": (dict(ARGS_4_16, steps=4608), None, "resume refused: flags changed"),
    "missing_fingerprint": (None, None, "horizon_args.json missing/corrupt"),
    "dead_sidecar": (ARGS_4_16, '{"knn_val', "untrained_baseline.json missing/corrupt"),
    # as tools/_horizon_run.py, a fingerprint without --arch/--image-size
    # defaults the two keys, so the refusal is the next one, the dead sidecar's
    "pre_arch_fingerprint": ({k: v for k, v in ARGS_4_16.items()
                              if k not in ("arch", "image_size")}, '{"knn_val',
                             "untrained_baseline.json missing/corrupt"),
}


@pytest.mark.parametrize("case", list(RESUME_REFUSALS))
def test_resume_refused_before_any_step(tmp_path, capsys, case):
    run_args, sidecar, message = RESUME_REFUSALS[case]
    code, out = _run(capsys, SMALL + ["--ckpt-dir", _fake_ckpt(tmp_path, run_args, sidecar)])
    assert code == horizon.EXIT_RESUME_REFUSED, out
    assert message in out
    if case == "pre_arch_fingerprint":
        assert "flags changed" not in out
    assert "Epoch [-1]" not in out  # no model was built


def test_short_run_fails_its_gates_and_its_resume_exits_3(tmp_path, capsys):
    ck = str(tmp_path / "ck")
    enc = tmp_path / "enc.npz"
    code, out = _run(capsys, SMALL + TINY + ["--ckpt-dir", ck, "--export-path", str(enc)])
    lines = out.splitlines()
    header = json.loads(lines[0])
    assert header["backend"] == "cpu" and header["chance_loss"] == round(math.log(4097), 3)
    monitor = [ln for ln in lines if "kNN(" in ln]
    assert monitor[0].startswith("Epoch [-1] kNN(val)") and "UNTRAINED" in monitor[0]
    record = json.loads(next(ln for ln in lines if ln.startswith('{"untrained_knn"')))
    assert record["steps"] == 4 and record["split"] == "val" and record["backend"] == "cpu"
    # four steps cannot learn the textures: the gate refuses the run
    assert code == horizon.EXIT_GATE_FAILED and "HORIZON GATE FAILED: kNN gain" in out
    assert enc.exists() and "HORIZON GATES PASSED" not in out
    assert json.loads((tmp_path / "ck" / "horizon_args.json").read_text()) == dict(
        ARGS_4_16, arch="resnet_tiny", image_size=16)
    code, out = _run(capsys, SMALL + TINY + ["--ckpt-dir", ck])
    assert code == horizon.EXIT_ALREADY_COMPLETE, out
    assert json.loads(out.splitlines()[-1]) == {"already_complete": True, "steps": 4,
                                                "ckpt_dir": ck}


def test_baseline_sidecar_roundtrip(tmp_path):
    """A fresh run writes the sidecar atomically; a corrupt one on resume
    gives no baseline (the entry point then refuses to gate); a healthy one
    is restored as recorded."""
    ck = tmp_path / "sck"
    cfg = get_preset("cifar10-moco-v1").replace(
        arch="resnet_tiny", cifar_stem=True, dataset="synthetic_texture", image_size=16,
        batch_size=16, num_negatives=32, embed_dim=32, lr=0.03, epochs=1,
        steps_per_epoch=None, knn_monitor=True, knn_every_epochs=1, knn_bank_size=32,
        num_classes=16, ckpt_dir=str(ck), ckpt_every_epochs=1, resume="", tb_dir="",
        print_freq=100, num_workers=0, compute_dtype="float32")
    data = SyntheticTextureDataset(num_samples=32, image_size=16, num_classes=16)
    quiet = dict(device="cpu", dataset=data, on_step=lambda *a: None)
    _, history = train.train(cfg, **quiet)
    side = ck / "untrained_baseline.json"
    assert side.exists() and not (ck / "untrained_baseline.json.tmp").exists()
    tag = "knn_val_top1_untrained"
    assert json.loads(side.read_text())[tag] == pytest.approx(history[0][tag])
    side.write_text('{"knn_val_top1_untr')
    _, h2 = train.train(cfg.replace(resume="auto", epochs=2), **quiet)
    assert not any(k.endswith("_untrained") for h in h2 for k in h)
    side.write_text(json.dumps({tag: 0.123}))
    _, h3 = train.train(cfg.replace(resume="auto", epochs=3), **quiet)
    assert horizon._last(h3, tag) == pytest.approx(0.123)


# the tool's own fields (tools/_horizon_run.py), for the same flags
def _jax_config(args, epochs, steps_per_epoch):
    return jax_preset("cifar10-moco-v1").replace(
        arch=args.arch, cifar_stem=True, dataset="synthetic_texture",
        image_size=args.image_size, batch_size=args.batch, num_negatives=4096,
        embed_dim=128, lr=args.lr, momentum_ema=args.momentum, cos=True, epochs=epochs,
        steps_per_epoch=None, knn_monitor=True, knn_every_epochs=args.knn_every,
        knn_bank_size=2048, num_classes=16, ckpt_dir=args.ckpt_dir, ckpt_every_epochs=4,
        resume="auto" if args.ckpt_dir else "", tb_dir="", print_freq=steps_per_epoch,
        num_workers=1, compute_dtype="float32")


SHARED_FIELDS = ("variant", "arch", "cifar_stem", "dataset", "image_size", "batch_size",
                 "num_negatives", "embed_dim", "temperature", "mlp_head", "lr",
                 "momentum_ema", "cos", "epochs", "schedule", "weight_decay", "sgd_momentum",
                 "knn_monitor", "knn_every_epochs", "knn_bank_size", "num_classes",
                 "ckpt_every_epochs", "resume", "print_freq", "compute_dtype", "seed",
                 "shuffle_mode")


@pytest.mark.parametrize("run", ["8_steps", pytest.param("160_steps", marks=pytest.mark.slow)])
def test_horizon_config_trains_as_the_jax_driver(monkeypatch, run):
    flags, schedule, rtol = PARITY_RUNS[run]
    args = horizon.build_parser(False).parse_args(TINY + ["--batch", "16"] + flags)
    samples, spe, epochs, total = horizon.schedule(args.batch, args.samples, args.steps)
    assert (samples, spe, epochs, total) == schedule
    cfg = horizon.horizon_config(args, epochs, spe, on_card=False)
    jcfg = _jax_config(args, epochs, spe)
    for name in SHARED_FIELDS:
        assert getattr(cfg, name) == getattr(jcfg, name), name

    # the same deterministic, differing views in both drivers
    monkeypatch.setattr(jtrain, "aug_config_for", lambda c: (
        jaug.eval_aug_config(16, crop_frac=1.0), jaug.eval_aug_config(16, crop_frac=0.75)))
    monkeypatch.setattr(train, "aug_config_for", lambda c: (
        aug.eval_aug_config(16, crop_frac=1.0), aug.eval_aug_config(16, crop_frac=0.75)))
    jax_losses = []
    build_fused = jtrain_step.build_fused_step

    def recording_fused_step(*a):
        fused = build_fused(*a)

        def step(*b):
            state, metrics = fused(*b)
            jax_losses.append(float(metrics["loss"]))
            return state, metrics
        return step

    monkeypatch.setattr(jtrain_step, "build_fused_step", recording_fused_step)
    jdata = JaxTexture(num_samples=samples, image_size=16, num_classes=16)
    _, jmetrics = jtrain.train(jcfg, create_mesh(1), dataset=jdata)

    # the JAX driver's initial state (its init key, model and input shape)
    jinit = jax_create_train_state(
        jax.random.key(jcfg.seed), jax_build_encoder(jcfg), jax_build_optimizer(jcfg, spe)[0],
        (args.batch, 16, 16, 3), jcfg.num_negatives, jcfg.embed_dim)
    sd = params_from_jax(jax.tree.map(np.asarray, jinit.params_q),
                         jax.tree.map(np.asarray, jinit.batch_stats_q))
    queue = np.array(jinit.queue)
    create = train.create_train_state

    def create_from_jax(*a, **kw):
        state = create(*a, **kw)
        state.model_q.load_state_dict(sd)
        state.model_k.load_state_dict(sd)
        state.queue.copy_(torch.from_numpy(queue))
        return state

    monkeypatch.setattr(train, "create_train_state", create_from_jax)
    data = SyntheticTextureDataset(num_samples=samples, image_size=16, num_classes=16)
    state, history = train.train(cfg.replace(print_freq=1), device="cpu", dataset=data,
                                 on_step=lambda *a: None)
    assert state.step == total == len(jax_losses)
    # the untrained baseline (before any step) is equal, and so is the
    # final kNN
    untrained = horizon._last(history, "knn_val_top1_untrained")
    assert untrained == jmetrics["knn_val_top1_untrained"]
    assert horizon._last(history, "knn_val_top1") == jmetrics["knn_val_top1"]
    losses = [h["loss"] for h in history if "loss" in h]
    assert len(losses) == total and all(np.isfinite(losses))
    np.testing.assert_allclose(losses, jax_losses, rtol=rtol)
    assert [h["queue_ptr"] for h in history if "loss" in h] == [
        (16 * (i + 1)) % 4096 for i in range(total)]
