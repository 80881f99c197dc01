"""The pretrain driver fed by the port's input service (`--input-service`),
on the CPU, against the same driver decoding in-process.

- one rank: `train.train` with `input_service` set builds no dataset (the
  length comes from the servers' meta answer) and its losses and final
  state equal the in-process run's bit for bit;
- `--num-devices 2` through `main`: the two ranks' clients each fetch their
  own shard, and the printed losses and the exported query encoder equal
  the in-process two-rank run's byte for byte;
- an unreachable pool ends `main` with exit 45 and nothing decoded
  in-process.

The servers are one module-scoped `LocalServerPool` serving the synthetic
dataset the driver's config names; every subprocess has its own time limit.
"""

from __future__ import annotations

import os
import re
import socket
import subprocess
import sys

import pytest
import torch

from moco_tpu_torch import train
from moco_tpu_torch.config import get_preset
from moco_tpu_torch.data.service.fleet import LocalServerPool
from moco_tpu_torch.serve.fleet import FleetPolicy

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
IMAGE = 16
# what `build_dataset("synthetic", image_size=16)` builds: 2048 samples, seed 0
WORKER_ARGS = ["--dataset", "synthetic", "--num-samples", "2048", "--image-size", str(IMAGE),
               "--seed", "0"]
FLAGS = ["--preset", "imagenet-moco-v2", "--dataset", "synthetic", "--arch", "resnet_tiny",
         "--image-size", str(IMAGE), "--batch-size", "8", "--num-negatives", "32",
         "--embed-dim", "16", "--max-steps", "3", "--print-freq", "1", "--device", "cpu"]
TIMEOUT = 240


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    pool = LocalServerPool(2, WORKER_ARGS, telemetry_root=str(tmp_path_factory.mktemp("pool")),
                           policy=FleetPolicy(probe_secs=0.2, startup_grace_secs=60.0))
    try:
        pool.start()
        assert pool.wait_healthy(60.0), "pool never became healthy"
        yield pool
    finally:
        pool.close_quietly()


def _config(**kw):
    return get_preset("imagenet-moco-v2").replace(
        dataset="synthetic", arch="resnet_tiny", image_size=IMAGE, batch_size=8,
        num_negatives=32, embed_dim=16, print_freq=1, staging_workers=2, **kw)


def test_one_rank_driver_on_the_service_equals_inprocess(pool, monkeypatch):
    local_state, local_history = train.train(_config(), max_steps=3, device="cpu",
                                             on_step=lambda *a: None)

    def no_local_dataset(*a, **kw):
        raise AssertionError("the driver built a dataset although the service serves it")

    monkeypatch.setattr(train, "build_dataset", no_local_dataset)
    state, history = train.train(_config(input_service=pool.endpoints_spec()), max_steps=3,
                                 device="cpu", on_step=lambda *a: None)
    assert [h["loss"] for h in history] == [h["loss"] for h in local_history]
    assert history == local_history
    for key, value in local_state.model_q.state_dict().items():
        assert torch.equal(state.model_q.state_dict()[key], value), key
    assert torch.equal(state.queue, local_state.queue)


def _main(args, tmp_path, name):
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-m", "moco_tpu_torch.train", *args], env=env,
                          cwd=REPO, capture_output=True, text=True, timeout=TIMEOUT)
    (tmp_path / f"{name}.log").write_text(proc.stdout + proc.stderr)
    return proc


def test_two_rank_driver_on_the_service_equals_inprocess(pool, tmp_path):
    runs = {}
    for name, extra in (("local", []), ("service", ["--input-service", pool.endpoints_spec()])):
        export = tmp_path / f"{name}.npz"
        proc = _main(FLAGS + ["--num-devices", "2", "--export-path", str(export)] + extra,
                     tmp_path, name)
        assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
        steps = re.findall(r"^step \d+ loss \S+", proc.stdout, re.M)
        assert len(steps) == 3, proc.stdout[-3000:]
        runs[name] = (steps, export.read_bytes())
    assert runs["service"][0] == runs["local"][0]
    assert runs["service"][1] == runs["local"][1]


def test_unreachable_pool_exits_45_without_decoding(monkeypatch, capsys):
    probe = socket.socket()
    probe.bind(("127.0.0.1", 0))
    dead = probe.getsockname()[1]
    probe.close()

    def no_local_dataset(*a, **kw):
        raise AssertionError("the driver fell back to decoding in-process")

    monkeypatch.setattr(train, "build_dataset", no_local_dataset)
    with pytest.raises(SystemExit) as e:
        train.main(FLAGS + ["--input-service", f"127.0.0.1:{dead}"])
    assert e.value.code == 45
    assert "no staging server answered a meta probe" in capsys.readouterr().out


def test_bad_endpoint_spec_is_a_config_error(capsys):
    with pytest.raises(SystemExit) as e:
        train.main(FLAGS + ["--input-service", "not-an-endpoint"])
    assert e.value.code == 45
    assert "not host:port" in capsys.readouterr().out
