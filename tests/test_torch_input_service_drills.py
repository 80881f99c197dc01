"""The port's input service with real staging-server processes
(`LocalServerPool`, `python -m moco_tpu_torch.staging_server`).

- one module-scoped pool of two servers: its epochs equal the in-process
  `epoch_loader`'s bit for bit, at one rank and for each rank of two with a
  resume skip; `/healthz` and `/stats` answer;
- a server started with `--prestage` serves the same bits;
- the wire against the reference: the port's `ServiceClient` fed by the
  JAX package's decode worker (`python -m moco_tpu.data.service.worker`)
  reads the same batches as when fed by the port's;
- the kill-one-server drill: `kill_at_shard` on one of two servers, the
  epoch bit for bit, the killed worker relaunched once (the fire-once
  marker), and `tools/telemetry_report.py` folds the servers' directories;
- the CLI: exit 50 on an occupied health port, 45 for a worker that cannot
  build its dataset, 0 after a SIGTERM drain.

Every subprocess and wait has its own time limit.
"""

from __future__ import annotations

import json
import os
import signal
import socket
import subprocess
import sys
import time
import urllib.request

import numpy as np
import pytest

from moco_tpu_torch.data.datasets import SyntheticDataset
from moco_tpu_torch.data.loader import epoch_loader
from moco_tpu_torch.data.service import protocol
from moco_tpu_torch.data.service.client import service_epoch_loader
from moco_tpu_torch.data.service.fleet import LocalServerPool
from moco_tpu_torch.data.service.prestage import write_prestage
from moco_tpu_torch.serve.fleet import FleetPolicy, pick_free_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_SAMPLES, IMAGE, GLOBAL_BATCH = 64, 32, 16
WORKER_ARGS = ["--dataset", "synthetic", "--num-samples", str(N_SAMPLES), "--image-size",
               str(IMAGE), "--seed", "0"]
POLICY = dict(probe_secs=0.2, startup_grace_secs=60.0, backoff_base_secs=0.1,
              backoff_max_secs=0.5)
WAIT_S = 60.0


def _dataset():
    return SyntheticDataset(num_samples=N_SAMPLES, image_size=IMAGE, seed=0)


def _drain(loader):
    try:
        return [tuple(np.array(t) for t in batch) for batch in loader]
    finally:
        loader.close_quietly()


def _assert_batches_equal(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


def _reference_epoch(epoch=1, **kw):
    return _drain(epoch_loader(_dataset(), epoch, 0, GLOBAL_BATCH, "cpu", workers=2, **kw))


def _service_epoch(spec, epoch=1, **kw):
    return _drain(service_epoch_loader(spec, N_SAMPLES, epoch, 0, GLOBAL_BATCH, "cpu",
                                       streams=2, backoff_secs=0.05, request_timeout_s=10.0,
                                       **kw))


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    pool = LocalServerPool(2, WORKER_ARGS, telemetry_root=str(tmp_path_factory.mktemp("pool")),
                           policy=FleetPolicy(**POLICY))
    try:
        pool.start()
        assert pool.wait_healthy(WAIT_S), "pool never became healthy"
        yield pool
    finally:
        pool.close_quietly()


@pytest.mark.parametrize("world, rank, skip", [(1, 0, 0), (1, 0, 2), (2, 0, 1), (2, 1, 1)])
def test_pool_epochs_equal_the_inprocess_loader(pool, world, rank, skip):
    want = _reference_epoch(skip_batches=skip, num_processes=world, process_index=rank)
    got = _service_epoch(pool.endpoints_spec(), skip_batches=skip, num_processes=world,
                         process_index=rank)
    _assert_batches_equal(got, want)


def test_pool_health_endpoint_and_stats(pool):
    _service_epoch(pool.endpoints_spec(), epoch=2)
    server = pool.servers[0]
    with urllib.request.urlopen(f"http://127.0.0.1:{server.health_port}/healthz",
                                timeout=5.0) as resp:
        body = json.load(resp)
    assert resp.status == 200 and body["status"] == "ok"
    assert body["data_port"] == server.data_port
    deadline = time.monotonic() + 10.0
    while time.monotonic() < deadline:  # the probe's pong carries the shards served
        with urllib.request.urlopen(f"http://127.0.0.1:{server.health_port}/stats",
                                    timeout=5.0) as resp:
            stats = json.load(resp)
        if stats["worker_stats"].get("shards", 0) >= 1:
            break
        time.sleep(0.2)
    assert stats["worker_stats"]["shards"] >= 1
    assert stats["worker"]["launches"] == 1 and stats["worker"]["healthy"]
    assert all(pid is not None for pid in pool.worker_pids())


def test_prestage_served_by_a_server_equals_the_inprocess_loader(tmp_path):
    root = str(tmp_path / "pre")
    write_prestage(_dataset(), root)
    pool = LocalServerPool(1, ["--prestage", root], telemetry_root=str(tmp_path),
                           policy=FleetPolicy(**POLICY))
    try:
        pool.start()
        assert pool.wait_healthy(WAIT_S)
        assert protocol.fetch_meta(*pool.endpoints()[0])["prestaged"] is True
        got = _service_epoch(pool.endpoints_spec())
    finally:
        pool.close_quietly()
    _assert_batches_equal(got, _reference_epoch())


def test_port_client_reads_the_reference_workers_frames(pool, tmp_path):
    """The JAX package's decode worker on its own port: the port's client
    reads the same batches from it as from the port's pool."""
    port = pick_free_port()
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu")
    with open(tmp_path / "jax_worker.log", "wb") as log:
        proc = subprocess.Popen([sys.executable, "-m", "moco_tpu.data.service.worker",
                                 *WORKER_ARGS, "--port", str(port)], env=env, cwd=REPO,
                                stdout=log, stderr=subprocess.STDOUT)
    try:
        deadline = time.monotonic() + WAIT_S
        while protocol.fetch_meta("127.0.0.1", port, timeout_s=1.0) is None:
            assert proc.poll() is None, (tmp_path / "jax_worker.log").read_text()
            assert time.monotonic() < deadline, "the reference worker never answered"
            time.sleep(0.2)
        got = _service_epoch(f"127.0.0.1:{port}")
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=15)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
    _assert_batches_equal(got, _service_epoch(pool.endpoints_spec()))
    _assert_batches_equal(got, _reference_epoch())


def test_kill_one_server_drill_keeps_the_epoch(tmp_path):
    """Server 0 SIGKILLs itself before answering its 2nd shard: every shard
    lands on server 1, the epoch is the in-process one bit for bit, and the
    supervisor relaunches the worker without firing the drill again."""
    from tools.telemetry_report import expand_events_arg, render, summarize

    chaos_state = tmp_path / "chaos_state"
    pool = LocalServerPool(2, WORKER_ARGS, telemetry_root=str(tmp_path),
                           policy=FleetPolicy(**POLICY),
                           per_server_env={0: {"MOCO_TPU_CHAOS": "kill_at_shard=2",
                                               "MOCO_TPU_CHAOS_STATE": str(chaos_state)}})
    try:
        pool.start()
        assert pool.wait_healthy(WAIT_S), "pool never became healthy"
        got = _service_epoch(pool.endpoints_spec())
        _assert_batches_equal(got, _reference_epoch())
        assert os.path.exists(chaos_state / "fired_kill_shard")
        server0 = pool.servers[0]
        deadline = time.monotonic() + 30.0
        while time.monotonic() < deadline:
            if server0.worker.launches >= 2 and server0.worker_healthy():
                break
            time.sleep(0.1)
        assert server0.worker.launches == 2, "server 0 was not relaunched exactly once"
        assert server0.worker_healthy()
        # the relaunched worker serves a whole epoch with no second kill
        _assert_batches_equal(_service_epoch(pool.endpoints_spec(), epoch=2),
                              _reference_epoch(epoch=2))
    finally:
        pool.close_quietly()
    with open(tmp_path / "staging_server0" / "events.jsonl", encoding="utf-8") as f:
        events = [json.loads(line) for line in f]
    exits = [e for e in events if e["event"] == "worker_exit"]
    assert any(e["returncode"] == -9 for e in exits)
    assert any(e["event"] == "launch" and e["attempt"] == 1 for e in events)
    # the report folds a port server's directory unchanged
    pairs = expand_events_arg(str(tmp_path))
    assert sorted(label for label, _ in pairs) == ["staging_server0", "staging_server1"]
    records = []
    for _label, path in pairs:
        with open(path, encoding="utf-8") as f:
            records += [json.loads(line) for line in f]
    isv = summarize(records)["input_servers"]
    assert isv["n_servers"] == 2 and isv["totals"]["shards"] >= 8
    assert "killed" in isv["servers"]["0"]["death_classes"] or \
        "native_crash" in isv["servers"]["0"]["death_classes"]
    assert "input service: 2 staging server(s)" in render(summarize(records))


def _cli(args, tmp_path, name):
    env = dict(os.environ, PYTHONPATH=REPO)
    log = open(tmp_path / f"{name}.log", "wb")
    return subprocess.Popen([sys.executable, "-m", "moco_tpu_torch.staging_server", *args],
                            env=env, cwd=REPO, stdout=log, stderr=subprocess.STDOUT), log


def test_staging_server_cli_exit_codes(tmp_path):
    """50 on an occupied health port (before any worker starts); 45 when the
    worker cannot build its dataset (a config class the supervisor gives up
    on); 0 after a SIGTERM drain of a healthy server."""
    from moco_tpu_torch.staging_server import main as cli_main

    blocker = socket.socket()
    blocker.bind(("127.0.0.1", 0))
    blocker.listen(1)
    try:
        rc = cli_main(["--health-port", str(blocker.getsockname()[1]), "--telemetry-dir",
                       str(tmp_path / "bind"), "--dataset", "synthetic"])
    finally:
        blocker.close()
    assert rc == 50
    assert not (tmp_path / "bind" / "worker.log").exists()

    bad, bad_log = _cli(["--telemetry-dir", str(tmp_path / "bad"), "--probe-secs", "0.2",
                         "--dataset", "imagefolder", "--data-dir",
                         str(tmp_path / "missing")], tmp_path, "bad")
    health = pick_free_port()
    good, good_log = _cli(["--telemetry-dir", str(tmp_path / "good"), "--health-port",
                           str(health), "--probe-secs", "0.2", *WORKER_ARGS], tmp_path, "good")
    try:
        assert bad.wait(timeout=WAIT_S) == 45
        deadline = time.monotonic() + WAIT_S
        while True:
            try:
                with urllib.request.urlopen(f"http://127.0.0.1:{health}/healthz",
                                            timeout=2.0) as resp:
                    if resp.status == 200:
                        break
            except OSError:
                pass
            assert good.poll() is None and time.monotonic() < deadline, \
                (tmp_path / "good.log").read_text()
            time.sleep(0.2)
        good.send_signal(signal.SIGTERM)
        assert good.wait(timeout=30) == 0
    finally:
        for proc in (bad, good):
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        bad_log.close()
        good_log.close()
    with open(tmp_path / "good" / "events.jsonl", encoding="utf-8") as f:
        events = [json.loads(line)["event"] for line in f]
    assert events[0] == "server_start" and "server_stop" in events
