"""The pure parts of the onset pair tool (`tests/onset_cpu_pair.py`), which
trains one texture horizon per (driver, seed) and tables when each starts
learning. Nothing here trains.

- For every rung the port's config (`horizon.horizon_config` with the seed)
  and the JAX driver's (the fields of `tools/_horizon_run.py`) agree on the
  fields the horizon test holds equal, and the rung's schedule is the
  horizon's; the two drivers' lr schedules agree at every step of the
  rung and their texture datasets are equal.
- The log parser reads fixed lines of both drivers' formats (the port's
  `step ...` rows, the JAX driver's `Epoch: [e][ 0/n]` rows, the shared kNN
  rows, the tool's own `onset_pair` rows) and gives the onset epoch, or
  "> last" when no epoch passes 50%.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import onset_cpu_pair as pair  # noqa: E402
from test_torch_horizon import SHARED_FIELDS  # noqa: E402

from moco_tpu_torch import horizon  # noqa: E402


@pytest.mark.parametrize("rung", sorted(pair.RUNGS))
def test_rung_configs_agree_across_drivers(rung):
    r = pair.RUNGS[rung]
    _, spe, epochs, total = horizon.schedule(r.batch, r.samples, r.steps)
    assert pair.schedule(r) == (spe, epochs, total)
    cfg, jcfg = pair.port_config(rung, seed=3), pair.jax_config(rung, seed=3)
    for name in SHARED_FIELDS:
        assert getattr(cfg, name) == getattr(jcfg, name), name
    assert (cfg.seed, cfg.arch, cfg.batch_size, cfg.knn_every_epochs, cfg.print_freq) == (
        3, r.arch, r.batch, 2, spe)
    assert (cfg.num_negatives, cfg.momentum_ema, cfg.lr, cfg.knn_bank_size,
            cfg.num_classes, cfg.cos) == (4096, 0.99, 0.03, 2048, 16, True)
    assert pair.port_config(rung, 0, "bfloat16").compute_dtype == "bfloat16"


@pytest.mark.parametrize("rung", sorted(pair.RUNGS))
def test_rung_lr_schedule_and_data_match_jax(rung):
    import jax

    from moco_tpu.data.datasets import SyntheticTextureDataset as JaxTexture
    from moco_tpu.train_step import build_optimizer as jax_build_optimizer
    from moco_tpu_torch.data.datasets import SyntheticTextureDataset
    from moco_tpu_torch.train_step import lr_schedule

    r = pair.RUNGS[rung]
    spe, _, total = pair.schedule(r)
    steps = np.arange(total)
    jax_lr = np.asarray(jax.vmap(jax_build_optimizer(pair.jax_config(rung, 0), spe)[1])(steps))
    port = lr_schedule(pair.port_config(rung, 0), spe)
    np.testing.assert_allclose([port(int(s)) for s in steps], jax_lr, rtol=0, atol=1e-8)
    ours = SyntheticTextureDataset(num_samples=r.samples, image_size=pair.IMAGE_SIZE,
                                   num_classes=16)
    theirs = JaxTexture(num_samples=r.samples, image_size=pair.IMAGE_SIZE, num_classes=16)
    assert np.array_equal(ours.images, theirs.images)
    assert np.array_equal(np.asarray(ours.labels), np.asarray(theirs.labels))


def test_ladder_rungs():
    assert pair.schedule(pair.RUNGS["R1"]) == (64, 100, 6400)
    assert pair.schedule(pair.RUNGS["R2"]) == (64, 100, 6400)
    assert pair.schedule(pair.RUNGS["R3"]) == (64, 100, 6400)
    assert pair.schedule(pair.RUNGS["R4"]) == (64, 400, 25600)
    assert pair.RUNGS["R4"] == ("resnet18", 256, 16384, 25600)
    assert pair.schedule(pair.RUNGS["R5"]) == (64, 100, 6400)
    assert pair.RUNGS["R5"] == ("resnet18", 256, 16384, 6400)
    assert pair.schedule(pair.RUNGS["R6"]) == (64, 50, 3200)


PORT_LOG = """\
NVIDIA H100 80GB HBM3, 700.00 W
{"driver": "port", "rung": "R1", "seed": 0}
Epoch [-1] kNN(val) top-1 7.62% (UNTRAINED baseline; chance 6.25%)
step 1 loss 0.0986926 acc1 100 acc5 100 pos_sim 0.841432 neg_sim -0.001 logit_margin 0.84 lr 0.03 queue_ptr 64 step_s 3.6 imgs_s 7.2
onset_pair epoch 0 step 64 loss 6.5 pos_sim 0.25
Epoch [0] kNN(val) top-1 8.01%
step 65 loss 6.20322 acc1 14 acc5 31 pos_sim 0.524593 neg_sim 0.26 logit_margin 0.25 lr 0.0299 queue_ptr 128 step_s 0.06 imgs_s 4096.8
onset_pair epoch 1 step 128 loss 6.25 pos_sim 0.5
Epoch [1] kNN(val) top-1 50.00%
step 129 loss 6.0 acc1 13 acc5 21 pos_sim 0.59 neg_sim 0.42 logit_margin 0.16 lr 0.0299 queue_ptr 192 step_s 0.06 imgs_s 3944.9
onset_pair epoch 2 step 192 loss 5.5 pos_sim 0.6
Epoch [2] kNN(val) top-1 50.39%
step 193 loss 5.0 acc1 13 acc5 19 pos_sim 0.49 neg_sim 0.34 logit_margin 0.14 lr 0.0299 queue_ptr 256 step_s 0.07 imgs_s 3561.1
onset_pair epoch 3 step 256 loss 4.5 pos_sim 0.7
Epoch [3] kNN(val) top-1 49.00%
{"steps": 256, "final_loss": 5.0, "wall_s": 12.5}
"""

JAX_LOG = """\
{"driver": "jax", "rung": "R1", "seed": 0}
Epoch [-1] kNN(val) top-1 9.38% (UNTRAINED baseline; chance 6.25%)
Epoch: [0][ 0/64]\tTime  0.000 ( 0.000)\tData  0.047 ( 0.047)\tLoss 4.8744e-02 (4.8744e-02)\tAcc@1 100.00 (100.00)
Epoch [0] imgs/sec 299.2 (299.2/chip)
Epoch [0] kNN(val) top-1 7.23%
Epoch: [1][ 0/64]\tTime  0.000 ( 0.000)\tData  0.007 ( 0.007)\tLoss 6.1773e+00 (6.1773e+00)\tAcc@1  14.06 ( 14.06)
Epoch [1] imgs/sec 6971.3 (6971.2/chip)
Epoch [1] kNN(val) top-1 7.62%
Epoch: [2][ 0/64]\tTime  0.000 ( 0.000)\tData  0.001 ( 0.001)\tLoss 6.6789e+00 (6.6789e+00)\tAcc@1   8.20 (  8.20)
Epoch [2] kNN(val) top-1 8.79%
{"untrained_knn": 0.09375, "final_knn_top1": 0.0879, "split": "val", "wall_s": 1432.3}
"""


def _write(tmp_path, name, text):
    path = tmp_path / name
    path.write_text(text)
    return str(path)


def test_parser_reads_the_port_s_log_and_the_tool_s_rows(tmp_path):
    rec = pair.summarize(_write(tmp_path, "port.log", PORT_LOG))
    # 50.00% is not above 50%: the onset is the next epoch
    assert rec["onset"] == 2
    assert (rec["best"], rec["final"], rec["untrained"], rec["wall_s"]) == (
        50.39, 49.0, 7.62, 12.5)
    # the onset_pair rows win over the driver's own; the last epoch is kept
    assert rec["at_epoch"] == {3: (4.5, 0.7)}


def test_parser_reads_the_jax_driver_s_log_and_says_never(tmp_path):
    rec = pair.summarize(_write(tmp_path, "jax.log", JAX_LOG))
    assert rec["onset"] == "> 2"
    assert (rec["best"], rec["final"], rec["untrained"], rec["wall_s"]) == (
        8.79, 8.79, 9.38, 1432.3)
    # the driver's own rows: the first step of each epoch, no pos_sim
    assert rec["at_epoch"] == {2: (6.6789, None)}


def test_parser_native_port_rows_and_the_table(tmp_path):
    native = "\n".join(line for line in PORT_LOG.splitlines()
                       if not line.startswith("onset_pair"))
    rec = pair.summarize(_write(tmp_path, "native.log", native))
    assert rec["onset"] == 2
    assert rec["at_epoch"] == {3: (5.0, 0.49)}
    text = pair.table([{"name": "port s0", **rec}])
    assert "| port s0 | 2 | 50.39 | 49.0 | 7.62 |" in text
    assert "5 / 0.49 (ep 3)" in text


def test_epoch_end_rows(capsys):
    record = pair.epoch_end_recorder(3)
    for i in range(7):
        record({"loss": 7.0 - i, "pos_sim": 0.1 * i})
    out = capsys.readouterr().out.splitlines()
    assert out == ["onset_pair epoch 0 step 3 loss 5 pos_sim 0.2",
                   "onset_pair epoch 1 step 6 loss 2 pos_sim 0.5"]


def test_driver_specs_and_log_names():
    assert pair.parse_driver("port") == ("port", "port", ("float32", None))
    assert pair.parse_driver("port:bfloat16") == ("port", "port-bf16", ("bfloat16", None))
    assert pair.parse_driver("port:bfloat16+plain_bn") == (
        "port", "port-bf16-plain_bn", ("bfloat16", "plain_bn"))
    assert pair.parse_driver("port+jax_init") == (
        "port", "port-jax_init", ("float32", "jax_init"))
    assert pair.parse_driver("jax") == ("jax", "jax", (None,))
    assert pair.parse_driver("jax@aa2203d") == ("jax", "jax-aa2203d", ("aa2203d",))
    for bad in ("port:float16", "port+bf16", "torch", "jaxx"):
        with pytest.raises(ValueError):
            pair.parse_driver(bad)
    # a variant reaches the one-run command; jax_init with its seed's state
    cmd = pair.command("port", ("bfloat16", "jax_init"), "R4", 2, "cuda", "init")
    assert cmd[cmd.index("--variant") + 1] == "jax_init"
    assert cmd[cmd.index("--jax-init") + 1] == os.path.join("init", "jax_init_seed2.npz")
    assert "--variant" not in pair.command("port", ("float32", None), "R1", 0, "cpu", "init")
    assert pair.log_path("runs", "cpu", "jax-aa2203d", "R1", 2) == os.path.join(
        "runs", "onset_pair_cpu_jax-aa2203d_R1_seed2.log")
