"""The port's FSDP v3 step (`sharding="fsdp"|"fsdp_tp"`, `parallel/fsdp.py`)
at 4 gloo ranks, 3 steps of the JAX test's tiny ViT (patch 8, width 32,
depth 2, 2 heads; heads of 16 and 32) from the JAX package's initial
weights, 8 samples a rank, and the pretrain loop (`train.py`) around it.

Under jax 0.9 the JAX package's FSDP step does not run (`tests/test_fsdp.py`:
`test_fsdp_fused_bitwise_parity_with_dp`, `test_fsdp_params_actually_sharded`,
`test_fsdp_state_bytes_quarter_of_dp`, the bucketed, fsdp_tp, quantized,
multi-hop and demo parity tests, `test_fsdp_4_to_2_restore_rebuilds_ef_fresh_zero`
and the driver tests fail at `moco_tpu/parallel/gradsync.py:389`). What
takes their place, the JAX tests' gates on the port's own step:

- fsdp and fsdp_tp under the fused sync, and fsdp under the bucketed one,
  equal the port's dp step in the same sync bit for bit: losses, both
  models, AdamW's state, on every rank. (gloo's all-reduce adds in an order
  that depends on the buffer's size, so at 4 ranks dp bucketed and dp
  fused differ in the last bits; each fsdp run is held against dp in its
  own sync.) The dp runs placed through `place_state` equal dp as it was
  called before FSDP (no layout, no placement) bit for bit.
- quantized int8 (fsdp) and the two-hop reduce (fsdp_tp) within 5% of dp's
  losses, and demo (top-k 0.25) within 50%, each with nonzero
  accumulators: the JAX bands.
- LARS under fsdp within 1e-6 of the largest |p| of dp's parameters (its
  norms sum the shards' squares in another order).
- fsdp against the JAX package's dp step on the 4-device mesh, which runs:
  losses within rtol 2e-4 (the JAX step sums its devices' gradients where
  the port takes their mean; AdamW is invariant to that up to its eps).
- the bytes a rank holds against `fsdp.state_bytes_per_device` of the JAX
  fsdp state on the same mesh (`place_state`, which runs).
- dp -> fsdp, fsdp -> dp and 4 -> 2 ranks restores through the driver:
  parameters exact, accumulators zero, the `ckpt-dialect` event.
- `train.py`'s layout checks and telemetry, and a supervised resize request
  `sharding=fsdp` that relaunches.
"""

import importlib.util
import json
import os
import subprocess
import sys
import time

import jax
import numpy as np
import pytest
import torch

from moco_tpu.checkpoint import read_recorded_sharding as jax_read_recorded_sharding
from moco_tpu.config import PretrainConfig as JaxConfig
from moco_tpu.models.vit import ViT as JaxViT
from moco_tpu.parallel import fsdp as jfsdp
from moco_tpu.parallel.gradsync import GradSync as JaxGradSync
from moco_tpu.parallel.mesh import create_mesh, mesh_for_config
from moco_tpu.train_step import build_optimizer as jax_build_optimizer
from moco_tpu.train_step import build_train_step as jax_build_train_step
from moco_tpu.v3_step import V3Model as JaxV3Model
from moco_tpu.v3_step import create_v3_train_state
from moco_tpu_torch import train
from moco_tpu_torch.config import PretrainConfig
from moco_tpu_torch.resilience.resize import write_resize_request
from moco_tpu_torch.weights import params_from_jax
from torch_dist_worker import spawn

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD, IMG, B, STEPS, SPE = 4, 16, 32, 3, 4
TINY = dict(patch=8, width=32, depth=2, heads=2, image_size=IMG, embed_dim=16, hidden_dim=32)
CONFIG = dict(variant="v3", arch="vit_small", embed_dim=16, momentum_ema=0.99,
              momentum_ramp=True, temperature=0.2, optimizer="adamw", lr=1e-3,
              weight_decay=0.1, batch_size=B, epochs=2, warmup_epochs=0, image_size=IMG)
QUANT = dict(grad_sync="quantized", grad_sync_bucket_mb=0.05)
RUNS = [
    ("dp", {}),
    ("dp_plain", {}),
    ("fsdp", dict(sharding="fsdp")),
    ("fsdp_tp", dict(sharding="fsdp_tp")),
    ("dp_bucketed", dict(grad_sync="bucketed", grad_sync_bucket_mb=0.05)),
    ("fsdp_bucketed", dict(sharding="fsdp", grad_sync="bucketed", grad_sync_bucket_mb=0.05)),
    ("fsdp_quantized", dict(sharding="fsdp", **QUANT)),
    ("fsdp_tp_quantized", dict(sharding="fsdp_tp", **QUANT)),
    ("fsdp_demo", dict(sharding="fsdp", grad_sync="demo", grad_sync_topk=0.25)),
    ("dp_lars", dict(optimizer="lars", lr=0.5, weight_decay=1e-4)),
    ("fsdp_lars", dict(sharding="fsdp", optimizer="lars", lr=0.5, weight_decay=1e-4)),
    ("fsdp_chunks2", dict(sharding="fsdp", collective_chunks=2)),
    ("fsdp_tp_chunks2", dict(sharding="fsdp_tp", collective_chunks=2)),
]
# the R50 leg's structure (a ResNet backbone: BN in the backbone and the
# heads) at resnet_tiny's width, dp and fsdp at 2 ranks
R50 = dict(resnet="resnet_tiny", embed_dim=16, hidden_dim=32)
R50_RUNS = [("r50_dp", {}), ("r50_fsdp", dict(sharding="fsdp"))]
LARS_RTOL = 1e-6
# the driver legs: 16 a global batch, 3 steps an epoch, a checkpoint at step 3
DRIVER = dict(CONFIG, batch_size=16, steps_per_epoch=3, knn_monitor=False, print_freq=1,
              resilience_sync_steps=1, **QUANT)


@pytest.fixture(scope="module")
def jax_dp(mesh8):
    """The JAX package's dp v3 step on the 4-device mesh (3 steps), its
    initial weights, and the bytes a device holds of its dp and fsdp
    states."""
    devices = list(mesh8.devices.flat)[:WORLD]
    jcfg = JaxConfig(**{k: v for k, v in CONFIG.items() if k != "image_size"})
    model = JaxV3Model(JaxViT(patch_size=8, width=32, depth=2, num_heads=2, num_classes=None),
                       embed_dim=16, hidden_dim=32)
    tx, sched = jax_build_optimizer(jcfg, SPE)
    mesh = create_mesh(WORLD, devices=devices)
    state = create_v3_train_state(jax.random.key(0), model, tx, (B // WORLD, IMG, IMG, 3))
    init = jax.tree.map(np.array, (state.params_q, state.batch_stats_q))
    state = JaxGradSync(jcfg, WORLD).attach(state, mesh)
    dp_bytes = jfsdp.state_bytes_per_device(state)
    fcfg = jcfg.replace(sharding="fsdp")
    fmesh = mesh_for_config(fcfg, mesh)
    fstate = jfsdp.place_state(JaxGradSync.for_mesh(fcfg, fmesh).attach(
        create_v3_train_state(jax.random.key(0), model, tx, (B // WORLD, IMG, IMG, 3)), fmesh),
        fmesh, fcfg)
    fsdp_bytes = jfsdp.state_bytes_per_device(fstate)
    int_bytes = sum(leaf.nbytes for leaf in jax.tree.leaves(fstate.opt_state)
                    if not np.issubdtype(leaf.dtype, np.floating))
    del fstate
    images = [(np.asarray(jax.random.normal(jax.random.key(100 + i), (B, IMG, IMG, 3))),
               np.asarray(jax.random.normal(jax.random.key(200 + i), (B, IMG, IMG, 3))))
              for i in range(STEPS)]
    step = jax_build_train_step(jcfg, model, tx, mesh, SPE, sched)
    losses = []
    for x1, x2 in images:
        state, m = step(state, x1, x2)
        losses.append(float(m["loss"]))
    return dict(init=init, images=images, losses=losses, dp_bytes=dp_bytes,
                fsdp_bytes=fsdp_bytes, opt_int_bytes=int_bytes)


@pytest.fixture(scope="module")
def port(jax_dp, tmp_path_factory):
    """Every run of RUNS at 4 gloo ranks, then `train.py`'s checkpoint legs
    (dp -> fsdp, fsdp -> dp) at 4 and (4 -> 2, a telemetry run) at 2."""
    out = str(tmp_path_factory.mktemp("fsdp_step"))
    params, stats = (jax.tree.map(lambda a: np.asarray(a, np.float32), t)
                     for t in jax_dp["init"])
    ck_dp, ck_fsdp = os.path.join(out, "ck_dp"), os.path.join(out, "ck_fsdp")
    legs4 = [("save_dp", dict(DRIVER, ckpt_dir=ck_dp), 3, 64),
             ("dp_to_fsdp", dict(DRIVER, ckpt_dir=ck_dp, resume="auto", sharding="fsdp"), 3, 64),
             ("save_fsdp", dict(DRIVER, ckpt_dir=ck_fsdp, sharding="fsdp"), 3, 64),
             ("fsdp_to_dp", dict(DRIVER, ckpt_dir=ck_fsdp, resume="auto"), 3, 64)]
    inputs = os.path.join(out, "inputs.pt")
    torch.save({"config": CONFIG, "model": TINY, "state_dict": params_from_jax(params, stats),
                "images": [(torch.from_numpy(a.copy()), torch.from_numpy(b.copy()))
                           for a, b in jax_dp["images"]],
                "steps_per_epoch": SPE, "runs": RUNS, "legs": legs4}, inputs)
    spawn("run_fsdp_steps", WORLD, (inputs, out))
    tel = os.path.join(out, "tel")
    legs2 = [("fsdp_4_to_2", dict(DRIVER, ckpt_dir=ck_fsdp, resume="auto", sharding="fsdp"),
              3, 64),
             ("telemetry", dict(DRIVER, sharding="fsdp", grad_sync="fused", telemetry_dir=tel,
                                peak_flops_per_chip=1e12, telemetry_stride=1), 2, 64)]
    # the 2-rank group: the R50 leg's dp and fsdp steps, then the driver legs
    r50_inputs = os.path.join(out, "r50_inputs.pt")
    r50 = _r50_model()
    torch.save({"config": dict(CONFIG, arch="resnet50"), "model": R50,
                "state_dict": r50.state_dict(),
                "images": [(torch.from_numpy(a.copy()), torch.from_numpy(b.copy()))
                           for a, b in jax_dp["images"]],
                "steps_per_epoch": SPE, "runs": R50_RUNS, "legs": legs2, "legs_model": TINY},
               r50_inputs)
    spawn("run_fsdp_steps", 2, (r50_inputs, out))

    def load(name, world):
        return [torch.load(os.path.join(out, f"{name}_rank{r}.pt"), weights_only=False)
                for r in range(world)]

    runs = {name: load(name, WORLD) for name, _ in RUNS}
    runs.update({name: load(name, 2) for name, _ in R50_RUNS})
    legs = {name: load(name, WORLD) for name, *_ in legs4}
    legs.update({name: load(name, 2) for name, *_ in legs2})
    return dict(runs=runs, legs=legs, ck_dp=ck_dp, ck_fsdp=ck_fsdp, tel=tel)


def _r50_model():
    from moco_tpu_torch.models.resnet import build_resnet
    from moco_tpu_torch.v3_step import V3Model

    return V3Model(build_resnet(R50["resnet"], num_classes=None), embed_dim=R50["embed_dim"],
                   hidden_dim=R50["hidden_dim"])


def _losses(rank: dict) -> list[float]:
    return [m["loss"] for m in rank["metrics"]]


def _differ(a: dict, b: dict) -> list[str]:
    """What differs between two saved runs, bit for bit."""
    diff = [f"{w}.{k}" for w in ("q", "k") for k in b[w] if not torch.equal(a[w][k], b[w][k])]
    oa, ob = a["optimizer"]["state"], b["optimizer"]["state"]
    diff += [f"optimizer {i}.{k}" for i in ob for k in ob[i]
             if not torch.equal(torch.as_tensor(oa[i][k]), torch.as_tensor(ob[i][k]))]
    if oa.keys() != ob.keys() or not ob:
        diff.append("optimizer state")
    if _losses(a) != _losses(b):
        diff.append("losses")
    return diff


@pytest.mark.parametrize("name,ref", [("fsdp", "dp"), ("fsdp_tp", "dp"),
                                      ("fsdp_bucketed", "dp_bucketed"), ("dp", "dp_plain")])
def test_bit_for_bit_with_dp(port, name, ref):
    runs = port["runs"]
    for r in range(WORLD):
        assert _differ(runs[name][r], runs[ref][r]) == [], (name, r)
    # every rank ends with the same models
    for r in range(1, WORLD):
        assert _differ(runs[name][r], runs[name][0]) == []


@pytest.mark.parametrize("name,ref", [("fsdp_chunks2", "fsdp"),
                                      ("fsdp_tp_chunks2", "fsdp_tp")])
def test_collective_chunks_bit_for_bit(port, name, ref):
    """fsdp and fsdp_tp with the keys' all-gather in 2 chunks equal the
    same modes in one, bit for bit on every rank. It takes the place of
    `tests/test_fsdp.py::test_fsdp_chunked_gather_bitwise`, which fails
    under jax 0.9 at `moco_tpu/parallel/gradsync.py:389`."""
    runs = port["runs"]
    for r in range(WORLD):
        assert _differ(runs[name][r], runs[ref][r]) == [], (name, r)


def test_r50_leg_fsdp_bit_for_bit_with_dp(port):
    """The R50 leg's structure (a resnet_tiny backbone and the heads) at 2
    ranks: fsdp splits the backbone's and the heads' BN parameters, the
    step averages the BN running statistics over the group
    (`v3_step.py`'s `mean_tensors_` of `bn_buffers`), and the run equals
    dp bit for bit on both ranks: losses, both models with their running
    statistics, AdamW's state."""
    runs = port["runs"]
    dp, fsdp = runs["r50_dp"], runs["r50_fsdp"]
    bn = {n: a for n, a in fsdp[0]["axes"]["model_q"].items() if ".bn" in n or "_bn" in n}
    assert bn and all(a is not None for a in bn.values()), bn
    assert all(a is None for a in dp[0]["axes"]["model_q"].values())
    assert any("running_mean" in k for k in fsdp[0]["q"])
    for r in range(2):
        assert _differ(fsdp[r], dp[r]) == [], r
    assert _differ(fsdp[1], fsdp[0]) == []
    # the statistics moved from their initial values
    assert any(not torch.equal(v, torch.zeros_like(v))
               for k, v in fsdp[0]["q"].items() if k.endswith("running_mean"))


def test_the_split(port):
    """Every parameter of the tiny ViT splits at 4 (and at 2 under
    fsdp_tp's 2 x 2): a rank holds none of the query model's full storage
    between steps, and 1/K of the dp state's bytes; the dp runs split
    nothing and keep the plain optimizer."""
    runs = port["runs"]
    dp, fsdp, tp = runs["dp"][0], runs["fsdp"][0], runs["fsdp_tp"][0]
    assert all(a is None for m in dp["axes"].values() for a in m.values())
    assert all(a is not None for m in fsdp["axes"].values() for a in m.values())
    assert dp["optimizer_class"] == "AdamW" and fsdp["optimizer_class"] == "FSDPAdamW"
    assert fsdp["held_q_bytes"] == 0 and dp["held_q_bytes"] > 0
    for key in ("param_bytes_per_device", "opt_bytes_per_device", "state_bytes_per_device"):
        assert fsdp["bytes"][-1][key] * 4 == dp["bytes"][-1][key], key
        assert tp["bytes"][-1][key] * 2 == dp["bytes"][-1][key], key


def test_bytes_match_the_jax_states(port, jax_dp):
    """A rank's bytes against `fsdp.state_bytes_per_device` of the JAX
    dp and fsdp states on the 4-device mesh: the parameters equal; the
    optimizer's less the JAX state's integer step counts (optax keeps its
    count as an int32 array, the port as a number)."""
    for name, want in (("dp", jax_dp["dp_bytes"]), ("fsdp", jax_dp["fsdp_bytes"])):
        got = port["runs"][name][0]["bytes"][-1]
        assert got["param_bytes_per_device"] == want["param_bytes_per_device"], name
        assert got["opt_bytes_per_device"] == want["opt_bytes_per_device"] - \
            jax_dp["opt_int_bytes"], name


def test_compressed_syncs_stay_in_the_jax_bands(port):
    runs = port["runs"]
    dp = _losses(runs["dp"][0])
    for name, band in (("fsdp_quantized", 0.05), ("fsdp_tp_quantized", 0.05),
                       ("fsdp_demo", 0.5)):
        got = _losses(runs[name][0])
        assert all(np.isfinite(got)), name
        for a, b in zip(got, dp):
            assert abs(a - b) <= band * max(abs(b), 1.0), (name, got, dp)
        for r in range(WORLD):
            acc = runs[name][r]["gradsync"]
            assert acc and max(float(v.abs().max()) for v in acc.values()) > 0, (name, r)
    assert "multihop" in runs["fsdp_tp_quantized"][0]["describe"]
    assert "multihop" not in runs["fsdp_quantized"][0]["describe"]


def test_lars_within_rounding(port):
    runs = port["runs"]
    for r in range(WORLD):
        a, b = runs["fsdp_lars"][r]["q"], runs["dp_lars"][r]["q"]
        scale = max(float(v.abs().max()) for v in b.values())
        worst = max(float((a[k] - b[k]).abs().max()) for k in b)
        assert worst <= LARS_RTOL * scale, (r, worst, scale)


def test_fsdp_matches_the_jax_dp_step(port, jax_dp):
    np.testing.assert_allclose(_losses(port["runs"]["fsdp"][0]), jax_dp["losses"], rtol=2e-4)


@pytest.mark.parametrize("leg,saved,event", [
    ("dp_to_fsdp", "save_dp", "was saved under sharding='dp', this run uses 'fsdp'"),
    ("fsdp_to_dp", "save_fsdp", "was saved under sharding='fsdp', this run uses 'dp'"),
    ("fsdp_4_to_2", "save_fsdp", "was saved by 4 processes, this run has 2"),
])
def test_restores(port, leg, saved, event):
    """A checkpoint moves between the modes and from 4 ranks to 2: the
    parameters exact, the accumulators zero (the saved ones were not), the
    `ckpt-dialect` event on rank 0."""
    legs = port["legs"]
    src = legs[saved][0]
    assert max(float(v.abs().max()) for v in src["gradsync"].values()) > 0
    for r, got in enumerate(legs[leg]):
        assert got["step"] == 3 and src["step"] == 3
        for w in ("q", "k"):
            for k, v in src[w].items():
                assert torch.equal(got[w][k], v), (leg, r, w, k)
        assert all(not v.any() for v in got["gradsync"].values()), (leg, r)
    dialect = [m for kind, m in legs[leg][0]["events"] if kind == "ckpt-dialect"]
    assert len(dialect) == 1 and event in dialect[0], dialect


def test_sidecar_stamps_read_by_jax(port):
    assert jax_read_recorded_sharding(port["ck_dp"], 3) == "dp"
    assert jax_read_recorded_sharding(port["ck_fsdp"], 3) == "fsdp"


def test_telemetry_renders_the_sharding(port):
    """The 2-rank fsdp driver run's `sharding` event, rendered by
    `tools/telemetry_report.py` with the MFU labelled by the mode."""
    spec = importlib.util.spec_from_file_location(
        "telemetry_report", os.path.join(ROOT, "tools", "telemetry_report.py"))
    report = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(report)
    with open(os.path.join(port["tel"], "events.jsonl")) as f:
        records = [json.loads(line) for line in f if line.strip()]
    summary = report.summarize(records)
    sharding = summary["sharding"]
    assert sharding["mode"] == "fsdp" and sharding["mesh_shape"] == {"data": 1, "fsdp": 2}
    assert sharding["state_bytes_per_device"] == (sharding["param_bytes_per_device"]
                                                  + sharding["opt_bytes_per_device"])
    start = [r for r in records if r.get("kind") == "run_start"][0]
    assert start["sharding"] == "fsdp"
    sync = [r for r in records if r.get("event") == "grad_sync"][0]
    assert sync["sharding"] == "fsdp"
    text = report.render(summary)
    assert "sharding: fsdp" in text and "MFU [fsdp]:" in text


def test_zero_sharding_with_fsdp_exits_45(capsys):
    with pytest.raises(ValueError, match="zero_sharding"):
        PretrainConfig(**CONFIG, sharding="fsdp", zero_sharding=True)
    with pytest.raises(SystemExit) as e:
        train.main(["--preset", "imagenet-moco-v3-vits", "--sharding", "fsdp",
                    "--zero-sharding", "true", "--device", "cpu"])
    assert e.value.code == 45
    assert "mutually exclusive" in capsys.readouterr().out


def test_layout_checked_before_any_rendezvous(monkeypatch, capsys):
    """`--sharding fsdp_tp --sharding-axis-size 3 --num-devices 4` exits 45
    in `main`, before any rank is launched or any group joined."""
    def never(*a, **k):
        raise AssertionError("main went past the layout check")

    monkeypatch.setattr(train, "launch", never)
    monkeypatch.setattr(train, "init_distributed", never)
    with pytest.raises(SystemExit) as e:
        train.main(["--preset", "imagenet-moco-v3-vits", "--sharding", "fsdp_tp",
                    "--sharding-axis-size", "3", "--num-devices", "4", "--device", "cpu"])
    assert e.value.code == 45
    assert "must divide the device count 4" in capsys.readouterr().out


TINY_CLI = ["--preset", "imagenet-moco-v3-vits", "--dataset", "synthetic", "--arch",
            "vit_tiny", "--image-size", "16", "--batch-size", "8", "--embed-dim", "16",
            "--device", "cpu", "--knn-monitor", "false", "--print-freq", "1",
            "--heartbeat-secs", "0", "--telemetry-flush-steps", "1",
            "--resilience-sync-steps", "1", "--watchdog-secs", "0", "--steps-per-epoch", "2",
            "--epochs", "2"]
DRILL_LIMIT_S = 150.0


def test_supervised_resize_to_fsdp(tmp_path):
    """Under the supervisor, a one-process dp run takes the request
    `devices=2 sharding=fsdp`: its elastic checkpoint, exit 49, and the
    relaunch with `--num-devices 2 --sharding fsdp` (two gloo ranks) that
    restores it and runs to the end."""
    tdir, ck = tmp_path / "tel", tmp_path / "ck"
    tdir.mkdir()
    env = dict(os.environ, OMP_NUM_THREADS="1",
               MOCO_TPU_CHAOS="slow_at_step=2,slow_ms=2500",
               MOCO_TPU_CHAOS_STATE=str(tmp_path / "chaos"))
    for k in ("WORLD_SIZE", "RANK", "LOCAL_RANK"):
        env.pop(k, None)
    child = [sys.executable, "-m", "moco_tpu_torch.train", *TINY_CLI, "--telemetry-dir",
             str(tdir), "--ckpt-dir", str(ck), "--num-devices", "1"]
    sup = ["moco_tpu_torch.supervise", "--telemetry-dir", str(tdir), "--ckpt-dir", str(ck),
           "--max-restarts", "3", "--heartbeat-stale-secs", "60", "--startup-grace-secs",
           "90", "--term-grace-secs", "5", "--backoff-base-secs", "0.1",
           "--backoff-max-secs", "0.5", "--poll-secs", "0.1", "--", *child]
    deadline = time.monotonic() + DRILL_LIMIT_S
    with open(tmp_path / "sup.log", "w") as log:
        proc = subprocess.Popen([sys.executable, "-m", *sup], cwd=ROOT, env=env, stdout=log,
                                stderr=subprocess.STDOUT, start_new_session=True)
    try:
        # the request goes in while the one-process leg steps
        hb = tdir / "heartbeat.json"
        while True:
            assert proc.poll() is None and time.monotonic() < deadline, \
                (tmp_path / "sup.log").read_text()[-3000:]
            try:
                beat = json.loads(hb.read_text())
                if beat.get("phase") == "step" and int(beat.get("step", 0)) >= 1:
                    break
            except (OSError, ValueError):
                pass
            time.sleep(0.05)
        write_resize_request(str(tdir), devices=2, sharding="fsdp")
        code = proc.wait(timeout=max(deadline - time.monotonic(), 0.1))
    finally:
        try:
            os.killpg(proc.pid, 9)
        except OSError:
            pass
        proc.wait()
    assert code == 0, (tmp_path / "sup.log").read_text()[-3000:]
    with open(tdir / "events.jsonl") as f:
        records = [json.loads(line) for line in f if line.strip()]
    sup_events = [r for r in records if r.get("kind") == "supervisor"]
    exits = [r["classification"] for r in sup_events if r.get("event") == "exit"]
    assert exits == ["resize", "clean"], exits
    relaunch = [r for r in sup_events if r.get("event") == "resize_relaunch"]
    assert [(r["devices_to"], r.get("sharding")) for r in relaunch] == [(2, "fsdp")]
    launches = [r for r in sup_events if r.get("event") == "launch"]
    assert launches[-1]["argv"][-6:-2] == ["--num-devices", "2", "--sharding", "fsdp"]
    shardings = [r["mode"] for r in records if r.get("event") == "sharding"]
    assert shardings == ["dp", "fsdp"], shardings
    steps = [int(r["step"]) for r in records if r.get("kind") == "step"]
    assert steps[-1] == 4, steps
