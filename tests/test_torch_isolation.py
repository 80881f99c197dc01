"""Rules every slice of the port keeps: it imports neither JAX nor the JAX
package, it never runs on the CPU unless asked to, and each entry point sets
the package's f32 precision policy (`utils/device.py`)."""

import pkgutil
import subprocess
import sys
import textwrap

import pytest
import torch

import moco_tpu_torch
from moco_tpu_torch import train

# Runs in a fresh interpreter: block jax and moco_tpu at import, then import
# every module of the port and check what got loaded.
_PROBE = textwrap.dedent("""
    import importlib, pkgutil, sys

    def banned(name):
        return (name == "jax" or name.startswith(("jax.", "jaxlib", "flax", "optax"))
                or name == "moco_tpu" or name.startswith("moco_tpu."))

    class Block:
        def find_spec(self, name, path=None, target=None):
            if banned(name):
                raise ImportError(f"the port imported {name}")
            return None

    sys.meta_path.insert(0, Block())
    import moco_tpu_torch
    names = [m.name for m in pkgutil.walk_packages(moco_tpu_torch.__path__, "moco_tpu_torch.")]
    for name in names:
        importlib.import_module(name)
    loaded = sorted(m for m in sys.modules if banned(m))
    assert not loaded, loaded
    print(len(names))
""")


def test_port_imports_no_jax_and_nothing_of_moco_tpu():
    proc = subprocess.run([sys.executable, "-c", _PROBE], capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    expected = list(pkgutil.walk_packages(moco_tpu_torch.__path__, "moco_tpu_torch."))
    assert int(proc.stdout.strip()) == len(expected) >= 15
    # the checkpoint, evaluation, data-parallel (ZeRO-1 included), prestage
    # and export modules are among those probed
    assert {"moco_tpu_torch.checkpoint", "moco_tpu_torch.resilience.integrity",
            "moco_tpu_torch.ops.knn", "moco_tpu_torch.utils.meters",
            "moco_tpu_torch.evals.knn", "moco_tpu_torch.evals.lincls",
            "moco_tpu_torch.parallel.mesh", "moco_tpu_torch.parallel.collectives",
            "moco_tpu_torch.parallel.gradsync", "moco_tpu_torch.parallel.zero",
            "moco_tpu_torch.data.service.prestage",
            "moco_tpu_torch.export_detectron2", "moco_tpu_torch.v3_step",
            "moco_tpu_torch.models.vit", "moco_tpu_torch.models.heads",
            "moco_tpu_torch.ops.optim"} <= {m.name for m in expected}
    # the run telemetry, its logging and the learning-health sentinel
    assert {"moco_tpu_torch.telemetry", "moco_tpu_torch.telemetry.registry",
            "moco_tpu_torch.telemetry.trace", "moco_tpu_torch.telemetry.timing",
            "moco_tpu_torch.telemetry.device", "moco_tpu_torch.telemetry.mfu",
            "moco_tpu_torch.telemetry.pod", "moco_tpu_torch.telemetry.health",
            "moco_tpu_torch.telemetry.run", "moco_tpu_torch.utils.logging",
            "moco_tpu_torch.resilience.errors",
            "moco_tpu_torch.resilience.sentinel"} <= {m.name for m in expected}
    # the resilience slice: exit codes, preemption, the watchdog, chaos; the
    # supervisor, the elastic resize, the rank launcher and the CLI
    assert {"moco_tpu_torch.resilience", "moco_tpu_torch.resilience.exitcodes",
            "moco_tpu_torch.resilience.preemption", "moco_tpu_torch.resilience.watchdog",
            "moco_tpu_torch.resilience.chaos", "moco_tpu_torch.resilience.supervisor",
            "moco_tpu_torch.resilience.resize", "moco_tpu_torch.parallel.launch",
            "moco_tpu_torch.supervise"} <= {m.name for m in expected}
    # the input service: its protocol, decode worker, staging supervisor,
    # client and pool, the serving fleet's pieces, the staging server's CLI
    assert {"moco_tpu_torch.data.service.protocol", "moco_tpu_torch.data.service.worker",
            "moco_tpu_torch.data.service.server", "moco_tpu_torch.data.service.client",
            "moco_tpu_torch.data.service.fleet", "moco_tpu_torch.serve",
            "moco_tpu_torch.serve.fleet",
            "moco_tpu_torch.staging_server"} <= {m.name for m in expected}
    # the replicated fleet's CLI, and obsd: its aggregator and its CLI
    assert {"moco_tpu_torch.serve_fleet", "moco_tpu_torch.telemetry.aggregate",
            "moco_tpu_torch.obsd"} <= {m.name for m in expected}
    # the learning horizon's entry point
    assert "moco_tpu_torch.horizon" in {m.name for m in expected}


def test_span_layer_imports_without_torch_or_numpy():
    """`telemetry/trace.py` and `telemetry/registry.py` stay stdlib-only (an
    out-of-process supervisor imports them), as the JAX package's do."""
    probe = textwrap.dedent("""
        import sys

        class Block:
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in ("torch", "numpy", "jax", "moco_tpu"):
                    raise ImportError(f"imported {name}")
                return None

        sys.meta_path.insert(0, Block())
        from moco_tpu_torch.telemetry import trace, registry
        from moco_tpu_torch.telemetry import Tracer, MetricsRegistry
        print(trace.SPANS_FILENAME, registry.EVENTS_FILENAME)
    """)
    proc = subprocess.run([sys.executable, "-c", probe], capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split() == ["spans.jsonl", "events.jsonl"]


@pytest.mark.parametrize("module", ["moco_tpu_torch.resilience.supervisor",
                                    "moco_tpu_torch.resilience.resize",
                                    "moco_tpu_torch.supervise",
                                    "moco_tpu_torch.parallel.launch"])
def test_supervisor_side_imports_without_torch_or_numpy(module):
    """The supervisor stays small and alive while its child runs the host or
    the card out of memory: it, the resize, its CLI and the rank launcher
    import the standard library alone, through the lazy `resilience`
    package."""
    probe = textwrap.dedent(f"""
        import importlib, sys
        importlib.import_module({module!r})
        print(sorted(m for m in ("torch", "numpy", "jax", "moco_tpu") if m in sys.modules))
    """)
    proc = subprocess.run([sys.executable, "-c", probe], capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split() == ["[]"]


STAGING_CONTROL_PLANE = ["moco_tpu_torch.data.service.protocol",
                         "moco_tpu_torch.data.service.server",
                         "moco_tpu_torch.data.service.fleet", "moco_tpu_torch.serve.fleet",
                         "moco_tpu_torch.staging_server"]


@pytest.mark.parametrize("module", STAGING_CONTROL_PLANE)
def test_staging_control_plane_imports_only_the_stdlib(module):
    """The staging server's supervisor half, its pool, the frame protocol
    and the fleet's pieces load the standard library and the port's own
    stdlib modules alone, transitively (the JAX package's
    `staging-server-stdlib-only` rule): a wedged numpy worker must leave a
    live supervisor."""
    probe = textwrap.dedent(f"""
        import importlib, sys
        before = set(sys.modules)
        importlib.import_module({module!r})
        new = {{m.split(".")[0] for m in set(sys.modules) - before}}
        print(sorted(m for m in new if m not in sys.stdlib_module_names
                     and m != "moco_tpu_torch"))
    """)
    proc = subprocess.run([sys.executable, "-c", probe], capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split() == ["[]"]


FLEET_AND_OBSD = ["moco_tpu_torch.serve.fleet", "moco_tpu_torch.serve_fleet",
                  "moco_tpu_torch.telemetry.aggregate", "moco_tpu_torch.obsd"]


@pytest.mark.parametrize("module", FLEET_AND_OBSD)
def test_fleet_and_obsd_import_only_the_stdlib(module):
    """The fleet's router and supervisor, its CLI, obsd's aggregator and
    obsd's CLI load the standard library and the port's own stdlib modules
    alone, transitively (the JAX package's `fleet-stdlib-only` and
    `obsd-stdlib-only` rules): the routing tier and the watcher outlive
    replicas that run the card out of memory. torch and numpy are blocked
    at import, so not even a lazy path may reach them."""
    probe = textwrap.dedent(f"""
        import importlib, sys

        class Block:
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in ("torch", "numpy", "jax", "moco_tpu"):
                    raise ImportError(f"imported {{name}}")
                return None

        before = set(sys.modules)
        sys.meta_path.insert(0, Block())
        mod = importlib.import_module({module!r})
        new = {{m.split(".")[0] for m in set(sys.modules) - before}}
        print(sorted(m for m in new if m not in sys.stdlib_module_names
                     and m != "moco_tpu_torch"))
    """)
    proc = subprocess.run([sys.executable, "-c", probe], capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split() == ["[]"]


def test_serve_package_stays_lazy_with_the_fleet():
    """Importing `moco_tpu_torch.serve.fleet` runs the `serve` package's
    body and loads neither torch nor numpy; the fleet's names resolve
    through the lazy `_EXPORTS` on first access."""
    probe = textwrap.dedent("""
        import sys
        import moco_tpu_torch.serve.fleet
        import moco_tpu_torch.serve as serve
        heavy = sorted(m for m in ("torch", "numpy") if m in sys.modules)
        names = [serve.FleetSupervisor.__name__, serve.FleetRouter.__name__,
                 serve.CheckpointWatcher.__name__, serve.FleetPolicy.__name__]
        heavy_after = sorted(m for m in ("torch", "numpy") if m in sys.modules)
        print(heavy, heavy_after, names)
    """)
    proc = subprocess.run([sys.executable, "-c", probe], capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == ("[] [] ['FleetSupervisor', 'FleetRouter', "
                                   "'CheckpointWatcher', 'FleetPolicy']")


SERVE_MODULES = ["moco_tpu_torch.serve", "moco_tpu_torch.serve.batcher",
                 "moco_tpu_torch.serve.cache", "moco_tpu_torch.serve.engine",
                 "moco_tpu_torch.serve.service", "moco_tpu_torch.serve.http",
                 "moco_tpu_torch.serve.bankbuild", "moco_tpu_torch.serve.ann",
                 "moco_tpu_torch.serve.fleet", "moco_tpu_torch.serve.__main__",
                 "moco_tpu_torch.bank_build", "moco_tpu_torch.serve_fleet"]


def test_serve_package_is_train_free():
    """The serving side (every module of `serve/`, its CLI, the bank
    builder's CLI, and the checkpoint surgery the engine loads through)
    never imports the training stack, directly or transitively: no
    `train`, `train_step`, `v3_step`, `train_state` or `ops/optim.py`."""
    probe = textwrap.dedent(f"""
        import importlib, sys
        for name in {SERVE_MODULES + ["moco_tpu_torch.checkpoint"]!r}:
            importlib.import_module(name)
        train = ("moco_tpu_torch.train", "moco_tpu_torch.train_step",
                 "moco_tpu_torch.v3_step", "moco_tpu_torch.train_state",
                 "moco_tpu_torch.ops.optim")
        print(sorted(m for m in sys.modules if m in train))
    """)
    proc = subprocess.run([sys.executable, "-c", probe], capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split() == ["[]"]
    expected = {m.name for m in pkgutil.walk_packages(moco_tpu_torch.__path__,
                                                      "moco_tpu_torch.")}
    assert set(SERVE_MODULES) <= expected


@pytest.mark.parametrize("module", ["moco_tpu_torch.serve.bankbuild",
                                    "moco_tpu_torch.serve.ann",
                                    "moco_tpu_torch.serve.batcher",
                                    "moco_tpu_torch.serve.cache"])
def test_serve_numpy_modules_import_no_torch(module):
    """The batcher, the cache, the bank builder and the ANN index are numpy
    and the standard library (the bank builder's batch lane runs without
    torch), as in the JAX package."""
    probe = textwrap.dedent(f"""
        import importlib, sys
        importlib.import_module({module!r})
        print(sorted(m for m in ("torch", "jax", "moco_tpu") if m in sys.modules))
    """)
    proc = subprocess.run([sys.executable, "-c", probe], capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split() == ["[]"]


def test_decode_worker_imports_no_torch():
    """The decode worker pays numpy's start-up, not torch's: no torch,
    directly or through a package `__init__`."""
    probe = textwrap.dedent("""
        import sys
        import moco_tpu_torch.data.service.worker
        import moco_tpu_torch.data.service.prestage
        print(sorted(m for m in ("torch", "jax", "moco_tpu") if m in sys.modules))
    """)
    proc = subprocess.run([sys.executable, "-c", probe], capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split() == ["[]"]


def test_lazy_service_package_exports_its_names():
    import importlib

    service = importlib.import_module("moco_tpu_torch.data.service")
    assert service.__all__ == sorted([
        "DecodeWorker", "FrameError", "LocalServerPool", "PrestageError", "PrestagedDataset",
        "RemoteShardError", "ServiceClient", "ServiceConfigError", "StagingServer",
        "parse_endpoints", "service_epoch_loader", "write_prestage"])
    for name in service.__all__:
        assert getattr(service, name).__module__.startswith("moco_tpu_torch.data.service.")
    serve = importlib.import_module("moco_tpu_torch.serve")
    assert serve.FleetPolicy().max_restarts == 5
    with pytest.raises(AttributeError):
        service.not_a_name  # noqa: B018


# the names `moco_tpu_torch.resilience` exported before it became lazy
RESILIENCE_EXPORTS = [
    "ChaosPlan", "CollapseError", "CollapseSentinel", "DataQualityError", "EXIT_CODE_NAMES",
    "EXIT_CONFIG_ERROR", "EXIT_DATA_QUALITY", "EXIT_OK", "EXIT_PREEMPTED", "EXIT_RESIZE",
    "EXIT_ROLLBACK_EXHAUSTED", "NaNSentinel", "NonFiniteLossError", "PreemptionHandler",
    "RollbackExhaustedError", "StepWatchdog", "TransientDataError", "active_chaos",
    "chaos_context", "clear_chaos", "install_chaos", "manifest_path", "parse_chaos_spec",
    "truncate_checkpoint", "verify_step", "write_manifest"]


def test_lazy_resilience_package_exports_the_same_names():
    import importlib

    resilience = importlib.import_module("moco_tpu_torch.resilience")
    assert sorted(resilience.__all__) == RESILIENCE_EXPORTS
    for name in RESILIENCE_EXPORTS:
        value = getattr(resilience, name)
        owner = getattr(value, "__module__", None)
        assert owner is None or owner.startswith("moco_tpu_torch.resilience."), (name, owner)
    from moco_tpu_torch.resilience import EXIT_RESIZE, StepWatchdog  # noqa: F401
    with pytest.raises(AttributeError):
        resilience.not_a_name  # noqa: B018


TINY = ["--preset", "imagenet-moco-v2", "--dataset", "synthetic", "--arch", "resnet_tiny",
        "--image-size", "32", "--batch-size", "8", "--num-negatives", "32",
        "--embed-dim", "16", "--max-steps", "1"]


def test_driver_runs_one_step_on_the_cpu_when_asked(capsys):
    train.main(TINY + ["--device", "cpu"])
    out = capsys.readouterr().out
    assert "step 1 loss" in out and "queue_ptr 8" in out


def test_driver_without_a_card_raises_instead_of_using_the_cpu(monkeypatch, capsys):
    """`main` ends as a config error (exit 45: the same argv can never
    succeed here) instead of running on the CPU; `train` itself raises."""
    from moco_tpu_torch.config import get_preset

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        train.main(TINY)
    assert e.value.code == 45
    assert "CUDA was requested" in capsys.readouterr().out
    with pytest.raises(RuntimeError, match="CUDA was requested"):
        train.train(get_preset("imagenet-moco-v2").replace(dataset="synthetic"), max_steps=1)


V3_TINY = ["--dataset", "synthetic", "--image-size", "32", "--batch-size", "8",
           "--embed-dim", "16", "--max-steps", "1"]
V3_ARCHS = {"imagenet-moco-v3-vits": "vit_tiny", "imagenet-moco-v3-vitb": "vit_tiny",
            "imagenet-moco-v3-r50": "resnet_tiny"}


@pytest.mark.parametrize("preset", sorted(V3_ARCHS))
def test_v3_presets_run_on_the_cpu_when_asked_and_set_the_policy(preset, capsys):
    """Each v3 preset through `main` (the arch cut to a tiny one): a step on
    the CPU with `--device cpu`, the precision policy set, and a raise
    without it where there is no card."""
    argv = ["--preset", preset, "--arch", V3_ARCHS[preset]] + V3_TINY
    _tf32_on()
    train.main(argv + ["--device", "cpu"])
    assert _policy_set()
    out = capsys.readouterr().out
    assert "step 1 loss" in out and "momentum" in out and "queue_ptr" not in out


@pytest.mark.parametrize("preset", sorted(V3_ARCHS))
def test_v3_presets_without_a_card_raise(preset, monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        train.main(["--preset", preset, "--arch", V3_ARCHS[preset]] + V3_TINY)
    assert e.value.code == 45
    assert "CUDA was requested" in capsys.readouterr().out


def test_kernel_wrappers_refuse_other_devices():
    from moco_tpu_torch.ops import blur, stats

    meta = torch.zeros(16, 8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        stats.channel_sums(meta)
    with pytest.raises(ValueError, match="unsupported device"):
        blur.gaussian_blur_batch(torch.zeros(1, 4, 4, 3, device="meta"),
                                 torch.zeros(1, 3, device="meta"), 1)


def _tf32_on():
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True


def _policy_set() -> bool:
    return (torch.backends.cudnn.allow_tf32 is False
            and torch.backends.cuda.matmul.allow_tf32 is False)


def test_driver_sets_the_precision_policy(capsys):
    """A real step through `main`, and `train` itself."""
    from moco_tpu_torch.config import get_preset

    _tf32_on()
    train.main(TINY + ["--device", "cpu"])
    assert _policy_set()
    _tf32_on()
    config = get_preset("imagenet-moco-v2").replace(
        dataset="synthetic", arch="resnet_tiny", image_size=32, batch_size=8,
        num_negatives=32, embed_dim=16)
    train.train(config, max_steps=1, device="cpu", on_step=lambda *a: None)
    assert _policy_set()


@pytest.mark.parametrize("entry", ["lincls.train_lincls", "lincls.main", "knn.run_knn",
                                   "knn.main"])
def test_eval_entry_points_set_the_precision_policy(entry, tmp_path):
    """Each sets the policy first: the flags are set even when the run then
    fails on a checkpoint that is not there."""
    from moco_tpu_torch.config import EvalConfig
    from moco_tpu_torch.evals import knn, lincls

    module, name = entry.split(".")
    fn = getattr({"lincls": lincls, "knn": knn}[module], name)
    missing = str(tmp_path / "missing.npz")
    _tf32_on()
    # a tiny arch and 32 px synthetic images: the probe builds its dataset
    # and every entry point its backbone before it reads the checkpoint, and
    # neither size is what is checked here
    with pytest.raises((FileNotFoundError, OSError)):
        if name == "main":
            fn(["--pretrained", missing, "--dataset", "synthetic", "--arch", "resnet_tiny",
                "--image-size", "32", "--device", "cpu"])
        else:
            fn(EvalConfig(pretrained=missing, dataset="synthetic", arch="resnet_tiny",
                          image_size=32), device="cpu")
    assert _policy_set()
