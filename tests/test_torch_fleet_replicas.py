"""The port's fleet over REAL port replicas on the CPU: `python -m
moco_tpu_torch.serve_fleet` in front of two `python -m moco_tpu_torch.serve
--device cpu` processes serving a `resnet_tiny` export of the port.

- tier 1 (under 30 s): an embed through the router equals a lone
  `EmbedService`'s row bit for bit; a second export dropped into the watch
  directory with its manifest rolls across both replicas and the router
  then answers the new engine's row; SIGTERM drains and the exit is 0;
  `python -m moco_tpu_torch.obsd --once` over the fleet's telemetry
  directory finds the fleet's run and both replicas' streams.
- the soak (`slow`, as the reference marks its own): the in-process
  supervisor under 32 closed-loop clients through a replica SIGKILL, a
  truncated step quarantined, a valid step rolled under load, and the
  answers equal to a cold engine on the new export.
"""

from __future__ import annotations

import base64
import importlib.util
import json
import os
import shutil
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE = 32
BUCKETS = ("1", "4")
WAIT_S = 60.0


def _load_tool(name):
    spec = importlib.util.spec_from_file_location(
        f"_tool_{name}", os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def exports(tmp_path_factory):
    """Two `resnet_tiny` (cifar stem) exports of the port in the reference's
    torchvision dialect: the backbone's own initialization (the same for
    both) with every weight scaled by 1 + 0.5 N(0, 1) from seeds 0 and 1."""
    import torch

    from moco_tpu_torch.checkpoint import _save_flat, resnet_to_torchvision
    from moco_tpu_torch.models import build_backbone

    root = tmp_path_factory.mktemp("fleet_exports")
    paths = []
    for seed in (0, 1):
        model = build_backbone("resnet_tiny", cifar_stem=True)
        g = torch.Generator().manual_seed(seed)
        with torch.no_grad():
            for p in model.parameters():
                p.mul_(1.0 + 0.5 * torch.randn(p.shape, generator=g))
        paths.append(str(root / f"encoder_{seed}.npz"))
        _save_flat(resnet_to_torchvision(model.state_dict(), prefix="module.encoder_q."),
                   paths[-1])
    return paths


def _lone_rows(path, images):
    """Each image's row from a lone EmbedService (one request at a time)."""
    from moco_tpu_torch.serve import EmbeddingEngine, EmbedService

    engine = EmbeddingEngine.from_checkpoint(path, "resnet_tiny", image_size=SIZE,
                                             cifar_stem=True, buckets=(1, 4), device="cpu")
    service = EmbedService(engine, flush_ms=2.0, max_queue=16, request_deadline_ms=10_000.0,
                           cache_mb=0)
    try:
        return [service.embed(im)[0] for im in images]
    finally:
        service.drain(timeout_s=10.0)


def _imgs(n, seed):
    return np.random.RandomState(seed).randint(0, 256, (n, SIZE, SIZE, 3)).astype(np.uint8)


def _body(im):
    return {"image_b64": base64.b64encode(im.tobytes()).decode("ascii"),
            "shape": list(im.shape)}


def _post(url, body, timeout=30.0):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"}, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _get(url, timeout=10.0):
    with urllib.request.urlopen(url, timeout=timeout) as resp:
        return json.loads(resp.read())


def _wait(cond, timeout_s=WAIT_S, msg="condition"):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if cond():
            return
        time.sleep(0.05)
    raise AssertionError(f"timed out after {timeout_s} s waiting for {msg}")


def _replica_cmd(path):
    return [sys.executable, "-u", "-m", "moco_tpu_torch.serve", "--pretrained", path,
            "--arch", "resnet_tiny", "--image-size", str(SIZE), "--cifar-stem", "true",
            "--buckets", *BUCKETS, "--flush-ms", "2.0", "--embed-cache-mb", "0",
            "--snapshot-every", "1", "--device", "cpu"]


def _events(path):
    try:
        with open(path) as f:
            return [json.loads(ln) for ln in f if ln.strip()]
    except OSError:
        return []


def test_fleet_of_real_replicas_embeds_rolls_and_drains(exports, tmp_path):
    from moco_tpu_torch.resilience.integrity import write_manifest

    t_start = time.monotonic()
    path_a, path_b = exports
    watch = tmp_path / "export"
    watch.mkdir()
    tel = tmp_path / "fleet_t"
    env = {**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1"}
    proc = subprocess.Popen(
        [sys.executable, "-u", "-m", "moco_tpu_torch.serve_fleet", "--replicas", "2",
         "--port", "0", "--telemetry-dir", str(tel), "--watch-dir", str(watch),
         "--probe-secs", "0.2", "--probe-timeout-s", "5", "--health-stale-secs", "30",
         "--startup-grace-secs", "60", "--watch-poll-secs", "0.2", "--stats-every-secs", "1",
         "--", *_replica_cmd(path_a)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, cwd=REPO, env=env)
    try:
        url = None
        deadline = time.monotonic() + WAIT_S
        while time.monotonic() < deadline and url is None:
            line = proc.stdout.readline()
            if not line:
                break
            if "fleet serving on http://" in line:
                url = "http://" + line.split("http://")[1].split()[0]
        assert url, "the fleet never announced its router"
        threading.Thread(target=proc.stdout.read, daemon=True).start()  # drain the pipe
        images = _imgs(3, seed=4)
        rows = {}

        def lone():  # the lone service's rows, one thread as the replicas
            import torch

            threads = torch.get_num_threads()
            torch.set_num_threads(1)
            try:
                rows["a"] = _lone_rows(path_a, images)
                rows["b"] = _lone_rows(path_b, images)
            finally:
                torch.set_num_threads(threads)

        lone_t = threading.Thread(target=lone)
        lone_t.start()  # while the replicas start
        _wait(lambda: _healthy_count(url) == 2, msg="both replicas healthy")
        lone_t.join(timeout=WAIT_S)
        assert not any(np.array_equal(a, b) for a, b in zip(rows["a"], rows["b"]))
        for im, want in zip(images, rows["a"]):
            status, resp = _post(url + "/v1/embed", _body(im))
            assert status == 200, resp
            assert np.array_equal(np.asarray(resp["embedding"], np.float32), want)
        # a second export rolls across both replicas through the watch dir
        (watch / "2").mkdir()
        shutil.copy(path_b, watch / "2" / "encoder.npz")
        write_manifest(str(watch), 2)
        fleet_events = str(tel / "events.jsonl")
        _wait(lambda: any(e.get("event") == "reload_done" and e.get("step") == 2
                          for e in _events(fleet_events)), msg="reload roll done")
        rolled = [e["replica"] for e in _events(fleet_events)
                  if e.get("event") == "reload_replica" and e.get("status") == "ok"]
        assert sorted(rolled) == [0, 1]
        stats = _get(url + "/stats")
        assert [r["deployed_step"] for r in stats["replicas"]] == [2, 2]
        for _ in range(2):  # both replicas answer the new engine's rows
            for im, want in zip(images, rows["b"]):
                status, resp = _post(url + "/v1/embed", _body(im))
                assert status == 200
                assert np.array_equal(np.asarray(resp["embedding"], np.float32), want)
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=WAIT_S) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)
    events = [e.get("event") for e in _events(str(tel / "events.jsonl"))]
    assert "fleet_stop" in events and "router_stats" in events
    assert time.monotonic() - t_start < 30.0

    # obsd --once over the fleet's directory: the fleet's run, its replicas
    out = subprocess.run([sys.executable, "-m", "moco_tpu_torch.obsd", str(tel), "--once"],
                         capture_output=True, text=True, timeout=60, cwd=REPO, env=env)
    assert out.returncode == 0, out.stderr
    snap = json.loads(out.stdout.strip().splitlines()[-1])
    assert snap["streams"] == 3  # the fleet's own and replica0/, replica1/
    (run,) = [r for r in snap["runs"] if "fleet" in r["kinds"]]
    assert {os.path.basename(s) for s in run["srcs"]} >= {"replica0", "replica1"}
    assert run["kinds"]["serve"] > 0 and run["kinds"]["fleet"] > 0
    assert run["events"]["reload_done"] == 1


def _healthy_count(url):
    try:
        return _get(url + "/healthz", timeout=5.0)["healthy"]
    except urllib.error.HTTPError as e:
        return json.loads(e.read())["healthy"]  # 503: no healthy backend yet
    except OSError:
        return -1


@pytest.mark.slow
@pytest.mark.chaos
def test_fleet_soak_real_replicas_kill_and_hot_reload(exports, tmp_path):
    """Two real replicas under the in-process supervisor: 32 closed-loop
    clients survive a replica SIGKILL with zero lost; a truncated step is
    quarantined and never loaded; a valid step rolls under load with zero
    lost, and the fleet then answers like a cold engine on it."""
    from moco_tpu_torch.resilience.chaos import truncate_checkpoint
    from moco_tpu_torch.resilience.integrity import manifest_path, write_manifest
    from moco_tpu_torch.serve import EmbeddingEngine
    from moco_tpu_torch.serve.fleet import FleetPolicy, FleetSupervisor

    serve_bench = _load_tool("serve_bench")
    path_a, path_b = exports
    watch = tmp_path / "export"
    watch.mkdir()

    def child_argv(index, port, tdir, pretrained):
        return _replica_cmd(pretrained or path_a) + ["--port", str(port),
                                                      "--telemetry-dir", tdir]

    fleet = FleetSupervisor(
        child_argv, replicas=2, telemetry_dir=str(tmp_path / "fleet_t"),
        watch_dir=str(watch), env={**os.environ, "PYTHONPATH": REPO},
        policy=FleetPolicy(probe_secs=0.2, probe_timeout_s=2.0, health_stale_secs=10.0,
                           startup_grace_secs=240.0, term_grace_secs=5.0,
                           backoff_base_secs=0.2, backoff_max_secs=1.0, watch_poll_secs=0.2,
                           reload_timeout_s=240.0), seed=0)
    fleet.start()
    try:
        _wait(lambda: fleet.healthy_count() == 2, timeout_s=240.0, msg="2 replicas healthy")
        victim = fleet.replicas[0].pid
        done = threading.Event()

        def killer():
            _wait(lambda: fleet.r_ok >= 16 or done.is_set(), timeout_s=240.0, msg="load")
            if not done.is_set():
                os.kill(victim, signal.SIGKILL)

        kt = threading.Thread(target=killer)
        kt.start()
        summary = serve_bench.run_load(fleet.router.url, concurrency=32, total_requests=256,
                                       image_size=SIZE, pool=8, timeout_s=60.0)
        done.set()
        kt.join()
        assert summary["lost"] == 0, summary["lost_detail"]
        _wait(lambda: fleet.healthy_count() == 2, timeout_s=240.0, msg="killed replica back")

        # made whole and torn in a staging directory, then moved in, its
        # manifest last: the watcher never sees the step before the tear
        stage = tmp_path / "stage"
        (stage / "50").mkdir(parents=True)
        shutil.copy(path_b, stage / "50" / "encoder.npz")
        write_manifest(str(stage), 50)
        truncate_checkpoint(str(stage), 50)
        os.rename(stage / "50", watch / "50")
        os.makedirs(os.path.dirname(manifest_path(str(watch), 50)), exist_ok=True)
        os.rename(manifest_path(str(stage), 50), manifest_path(str(watch), 50))
        _wait(lambda: any(e["event"] == "reload_quarantine" for e in fleet.incidents),
              timeout_s=30.0, msg="truncated step quarantined")
        assert all(r.deployed_step == -1 for r in fleet.replicas)

        (watch / "60").mkdir()
        shutil.copy(path_b, watch / "60" / "encoder.npz")
        write_manifest(str(watch), 60)
        result = {}
        loader = threading.Thread(target=lambda: result.update(serve_bench.run_load(
            fleet.router.url, concurrency=8, total_requests=128, image_size=SIZE, pool=8,
            timeout_s=60.0)))
        loader.start()
        _wait(lambda: all(r.deployed_step == 60 for r in fleet.replicas), timeout_s=240.0,
              msg="reload rolled across the fleet")
        loader.join(timeout=120.0)
        assert result["lost"] == 0, result["lost_detail"]

        img = _imgs(1, seed=3)[0]
        status, resp = _post(fleet.router.url + "/v1/embed", _body(img), timeout=60.0)
        assert status == 200
        cold = EmbeddingEngine.from_checkpoint(path_b, "resnet_tiny", image_size=SIZE,
                                               cifar_stem=True, buckets=(1, 4), device="cpu")
        cold.warmup()
        assert np.array_equal(np.asarray(resp["embedding"], np.float32),
                              cold.embed(img[None])[0])
        assert "reload_done" in [e["event"] for e in fleet.incidents]
    finally:
        fleet.stop()
