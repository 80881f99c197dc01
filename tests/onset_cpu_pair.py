"""The learning onset, driver against driver and seed for seed: one texture
horizon per (driver, seed) at a rung of the ladder below, each in its own
process with its own log, and a table of when each run starts learning.

Drivers:

- `port[:DTYPE][+VARIANT]`: `moco_tpu_torch.train.train` with the config
  of `moco_tpu_torch/horizon.py::horizon_config` for the rung, the seed and
  DTYPE (`float32`, the default, or `bfloat16`). Torch only, so the same
  runner trains on the CPU (`--device cpu`) and on the card (`--device
  cuda`). A VARIANT changes one thing by patching a module attribute
  before the run (nothing in the package knows of them):
  - `plain_bn`: the BN pair's wrappers (`ops/stats.py`) replaced by their
    plain PyTorch versions inside `models/fast_bn.py`, so that no BN
    kernel runs on the card;
  - `jax_init`: both encoders and the queue start from the JAX driver's
    initial state for the seed, `<--jax-init-dir>/jax_init_seed<S>.npz`
    (written on the CPU by `tests/onset_jax_init.py --rung RUNG`);
  - `bf16_logits`: the InfoNCE logits' two dot products take operands
    rounded to bf16 and accumulate in f32, forward and backward, as XLA's
    DEFAULT precision computes an f32 dot on a TPU;
  - `bf16_dots`: `bf16_logits` and the embedding head's `nn.Linear`
    (forward and both backward products) so.
- `jax[@COMMIT]`: `moco_tpu.train.train(jcfg, create_mesh(1), ...)` on the
  CPU, with `jcfg` built as `tools/_horizon_run.py` builds it. `jax` is the
  package of this tree; `jax@COMMIT` imports the package of a read-only
  `git archive COMMIT moco_tpu tools native pyproject.toml` extracted into
  `runs/_onset_ref_<COMMIT>/` (made on first use, ignored by git). The JAX
  runner never runs on the card.

Every rung keeps the horizon's K=4096, m=0.99, lr 0.03 cosine over the
rung's epochs, 16 classes, a kNN bank of 2048 and the monitor every 2
epochs, resnet at 32 px with the CIFAR stem, f32 unless asked:

    R1  resnet_tiny  B=64   4096 samples   6400 steps (100 epochs)
    R2  resnet_tiny  B=256  16384 samples  6400 steps (100 epochs)
    R3  resnet18     B=64   4096 samples   6400 steps (100 epochs)
    R4  resnet18     B=256  16384 samples  25600 steps (400 epochs: the horizon)
    R5  resnet18     B=256  16384 samples  6400 steps (R2 with R4's model)
    R6  resnet18     B=256  16384 samples  3200 steps (50 epochs: the TPU
        run of `runs/horizon_tpu_r5_3200steps.log`)

and R0, a smoke run (resnet_tiny, B=32, 256 samples, 64 steps).

Both runners print, besides each driver's own rows, one line at the end of
every epoch, `onset_pair epoch E step S loss L pos_sim P`, the metrics of
that epoch's last step, and a last JSON line with the run's wall time.

    python tests/onset_cpu_pair.py run --rung R1 --device cpu \
        --runs port=0,1,2 jax=0,1,2 jax@aa2203d=0,1,2 --cores-per-run 2 --slots 3
    python tests/onset_cpu_pair.py run --rung R1 --device cuda \
        --runs port=0,1,2 port:bfloat16=0,1,2 port:bfloat16+plain_bn=0,1,2
    python tests/onset_cpu_pair.py one port --rung R1 --seed 0 --device cpu
    python tests/onset_cpu_pair.py summarize runs/onset_pair_*.log

`run` keeps `--slots` runs going at once; with `--cores-per-run N` slot j
holds cores [F+jN, F+(j+1)N) (F: `--first-core`, 0 by default) through
`taskset` and `OMP_NUM_THREADS=N`. Logs go
to `<out>/onset_pair_<device>_<driver>_<rung>_seed<S>.log` (driver tokens:
`port`, `port-bf16`, `port-bf16-<VARIANT>`, `jax`, `jax-<COMMIT>`), one
JSON record a run as it
ends and the table at the end to stdout. The onset is the first
epoch whose val kNN is above 50% ("> last" when none is). Not collected by
pytest; `tests/test_torch_onset_pair.py` tests its pure parts.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import signal
import subprocess
import sys
import time
from collections import deque
from typing import NamedTuple

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
IMAGE_SIZE = 32
KNN_EVERY = 2
ONSET_KNN = 50.0             # percent
VARIANTS = ("plain_bn", "jax_init", "bf16_logits", "bf16_dots")
TABLE_EPOCHS = (10, 25, 50)  # and the last


class Rung(NamedTuple):
    arch: str
    batch: int
    samples: int
    steps: int


RUNGS = {
    "R0": Rung("resnet_tiny", 32, 256, 64),  # a smoke run: 8 epochs of 8 steps
    "R1": Rung("resnet_tiny", 64, 4096, 6400),
    "R2": Rung("resnet_tiny", 256, 16384, 6400),
    "R3": Rung("resnet18", 64, 4096, 6400),
    "R4": Rung("resnet18", 256, 16384, 25600),
    "R5": Rung("resnet18", 256, 16384, 6400),
    "R6": Rung("resnet18", 256, 16384, 3200),
}


def schedule(rung: Rung) -> tuple[int, int, int]:
    """(steps_per_epoch, epochs, total_steps) of `rung`, whole epochs only
    (as `horizon.schedule`)."""
    steps_per_epoch = rung.samples // rung.batch
    epochs = max(rung.steps // steps_per_epoch, 1)
    return steps_per_epoch, epochs, epochs * steps_per_epoch


def horizon_flags(rung: Rung) -> list[str]:
    """The rung as `python -m moco_tpu_torch.horizon` flags."""
    return ["--arch", rung.arch, "--image-size", str(IMAGE_SIZE), "--batch", str(rung.batch),
            "--samples", str(rung.samples), "--steps", str(rung.steps),
            "--knn-every", str(KNN_EVERY)]


def port_config(rung_name: str, seed: int, dtype: str = "float32"):
    """The port's config for the rung: `horizon_config` with the seed and
    the compute dtype replaced."""
    from moco_tpu_torch import horizon

    args = horizon.build_parser(False).parse_args(horizon_flags(RUNGS[rung_name]))
    _, steps_per_epoch, epochs, _ = horizon.schedule(args.batch, args.samples, args.steps)
    return horizon.horizon_config(args, epochs, steps_per_epoch, on_card=False).replace(
        seed=seed, compute_dtype=dtype)


def jax_config(rung_name: str, seed: int):
    """The JAX driver's config for the rung, the fields of
    `tools/_horizon_run.py`'s on the CPU, from whichever `moco_tpu` is
    imported."""
    from moco_tpu.config import get_preset

    rung = RUNGS[rung_name]
    steps_per_epoch, epochs, _ = schedule(rung)
    return get_preset("cifar10-moco-v1").replace(
        arch=rung.arch, cifar_stem=True, dataset="synthetic_texture", image_size=IMAGE_SIZE,
        batch_size=rung.batch, num_negatives=4096, embed_dim=128, lr=0.03, momentum_ema=0.99,
        cos=True, epochs=epochs, steps_per_epoch=None, knn_monitor=True,
        knn_every_epochs=KNN_EVERY, knn_bank_size=2048, num_classes=16, ckpt_dir="",
        ckpt_every_epochs=4, resume="", tb_dir="", print_freq=steps_per_epoch,
        num_workers=1, compute_dtype="float32", seed=seed)


def epoch_end_recorder(steps_per_epoch: int):
    """A `metrics -> None` that prints the `onset_pair` line of each epoch's
    last step (the one host read an epoch it adds)."""
    count = [0]

    def record(metrics) -> None:
        count[0] += 1
        if count[0] % steps_per_epoch == 0:
            loss, pos_sim = float(metrics["loss"]), float(metrics["pos_sim"])
            print(f"onset_pair epoch {count[0] // steps_per_epoch - 1} step {count[0]} "
                  f"loss {loss:.6g} pos_sim {pos_sim:.6g}", flush=True)

    return record


def smi_line() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True,
                              text=True).stdout.strip()
    except FileNotFoundError:
        return ""


def _bf16(x):
    import torch

    return x.to(torch.bfloat16).to(torch.float32)


def _tpu_default_logits():
    """`infonce_logits` with XLA's DEFAULT-precision dots of a TPU: each
    operand rounded to bf16, products accumulated in f32, the cotangent
    rounded the same way in the backward (the transpose of a DEFAULT dot is
    a DEFAULT dot)."""
    import torch

    class Logits(torch.autograd.Function):
        @staticmethod
        def forward(ctx, q, k, queue):
            qb, kb, queue_b = _bf16(q), _bf16(k), _bf16(queue)
            ctx.save_for_backward(kb, queue_b)
            return torch.cat([(qb * kb).sum(dim=1, keepdim=True), qb @ queue_b.t()], dim=1)

        @staticmethod
        def backward(ctx, g):
            kb, queue_b = ctx.saved_tensors
            gb = _bf16(g)
            return gb[:, :1] * kb + gb[:, 1:] @ queue_b, None, None

    def infonce_logits(q, k, queue, temperature):
        logits = Logits.apply(q.float(), k.float(), queue.float()) / temperature
        return logits, torch.zeros(q.shape[0], dtype=torch.int64, device=q.device)

    return infonce_logits


def _tpu_default_linear():
    """`F.linear` with XLA's DEFAULT-precision dots of a TPU (see
    `_tpu_default_logits`): y = bf16(x) @ bf16(W)^T + b, dx = bf16(g) @
    bf16(W), dW = bf16(g)^T @ bf16(x), all accumulated in f32."""
    import torch

    class Linear(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, weight, bias):
            xb, wb = _bf16(x), _bf16(weight)
            ctx.save_for_backward(xb, wb)
            return xb @ wb.t() + bias

        @staticmethod
        def backward(ctx, g):
            xb, wb = ctx.saved_tensors
            gb = _bf16(g)
            return gb @ wb, gb.t() @ xb, g.sum(dim=0)

    def forward(self, x):
        return Linear.apply(x.float(), self.weight, self.bias)

    return forward


def apply_variant(variant: str | None, jax_init: str | None) -> None:
    """Patch the port for `variant` (see the module docstring); `jax_init`
    is the `jax_init` variant's state (.npz)."""
    import numpy as np
    import torch

    from moco_tpu_torch import train, train_step
    from moco_tpu_torch.models import fast_bn
    from moco_tpu_torch.ops import stats

    if variant == "plain_bn":
        fast_bn.channel_sums = stats.channel_sums_plain
        fast_bn.channel_grad_sums = stats.channel_grad_sums_plain
    elif variant == "jax_init":
        with np.load(jax_init) as z:
            sd = {k[len("sd/"):]: torch.from_numpy(z[k]) for k in z.files if k.startswith("sd/")}
            queue = torch.from_numpy(z["queue"])
        create = train.create_train_state

        def create_from_jax(*a, **kw):
            state = create(*a, **kw)
            state.model_q.load_state_dict(sd)
            state.model_k.load_state_dict(sd)
            state.queue.copy_(queue)
            print(f"jax_init: both encoders ({len(sd)} tensors) and the queue from "
                  f"{jax_init}", flush=True)
            return state

        train.create_train_state = create_from_jax
    elif variant == "bf16_logits":
        train_step.infonce_logits = _tpu_default_logits()
    elif variant == "bf16_dots":
        train_step.infonce_logits = _tpu_default_logits()
        torch.nn.Linear.forward = _tpu_default_linear()
    elif variant is not None:
        raise ValueError(f"unknown variant {variant!r}; choose from {VARIANTS}")


def run_port(rung_name: str, seed: int, device: str, dtype: str, variant: str | None = None,
             jax_init: str | None = None) -> None:
    sys.path.insert(0, ROOT)
    import torch

    from moco_tpu_torch import train
    from moco_tpu_torch.data.datasets import SyntheticTextureDataset
    from moco_tpu_torch.ops import stats

    rung = RUNGS[rung_name]
    cfg = port_config(rung_name, seed, dtype)
    steps_per_epoch, _, _ = schedule(rung)
    record = epoch_end_recorder(steps_per_epoch)
    build = train.build_train_step

    def recording_build(*a, **kw):
        step = build(*a, **kw)

        def recorded(state, im_q, im_k):
            metrics = step(state, im_q, im_k)
            record(metrics)
            return metrics
        return recorded

    train.build_train_step = recording_build
    apply_variant(variant, jax_init)
    print(json.dumps({"driver": "port", "rung": rung_name, "seed": seed, "device": device,
                      "compute_dtype": dtype, "variant": variant, "arch": cfg.arch, "batch": cfg.batch_size,
                      "epochs": cfg.epochs, "torch": torch.__version__,
                      "threads": torch.get_num_threads()}), flush=True)
    data = SyntheticTextureDataset(num_samples=rung.samples, image_size=IMAGE_SIZE,
                                   num_classes=16)
    t0 = time.time()
    state, history = train.train(cfg, device=device, dataset=data)
    losses = [h["loss"] for h in history if "loss" in h]
    print(json.dumps({"steps": int(state.step), "final_loss": losses[-1] if losses else None,
                      "launches": {"channel_sums": stats.channel_sums.launches,
                                   "channel_grad_sums": stats.channel_grad_sums.launches},
                      "wall_s": round(time.time() - t0, 1)}), flush=True)


def run_jax(rung_name: str, seed: int, jax_root: str) -> None:
    sys.path.insert(0, jax_root)
    os.environ["JAX_PLATFORMS"] = "cpu"
    from moco_tpu.parallel.mesh import create_mesh, force_cpu_devices

    force_cpu_devices(1)
    import jax

    import moco_tpu
    from moco_tpu import train as jtrain
    from moco_tpu import train_step as jstep
    from moco_tpu.data.datasets import SyntheticTextureDataset

    rung = RUNGS[rung_name]
    jcfg = jax_config(rung_name, seed)
    steps_per_epoch, _, _ = schedule(rung)
    record = epoch_end_recorder(steps_per_epoch)
    build = jstep.build_fused_step

    def recording_build(*a):
        fused = build(*a)

        def step(*b):
            state, metrics = fused(*b)
            record(metrics)
            return state, metrics
        return step

    jstep.build_fused_step = recording_build
    package = os.path.relpath(os.path.dirname(moco_tpu.__file__), ROOT)
    print(json.dumps({"driver": "jax", "rung": rung_name, "seed": seed, "device": "cpu",
                      "package": package, "jax": jax.__version__,
                      "backend": jax.default_backend(), "arch": jcfg.arch,
                      "batch": jcfg.batch_size, "epochs": jcfg.epochs}), flush=True)
    data = SyntheticTextureDataset(num_samples=rung.samples, image_size=IMAGE_SIZE,
                                   num_classes=16)
    t0 = time.time()
    state, metrics = jtrain.train(jcfg, create_mesh(1), dataset=data)
    loss = metrics.get("loss")
    print(json.dumps({"steps": int(state.step), "final_loss": None if loss is None
                      else float(loss), "wall_s": round(time.time() - t0, 1)}), flush=True)


# ---- logs ------------------------------------------------------------------

_KNN_ROW = re.compile(r"^Epoch \[(-?\d+)\] kNN\(val\) top-1 ([0-9.]+)%")
_PAIR_ROW = re.compile(r"^onset_pair epoch (\d+) step (\d+) loss (\S+) pos_sim (\S+)")
# each driver's own print row, at the first step of every epoch
_PORT_ROW = re.compile(r"^step (\d+) loss (\S+) .*pos_sim (\S+)")
_JAX_ROW = re.compile(r"^Epoch: \[(\d+)\]\[\s*0/\s*\d+\].*Loss (\S+)")


def summarize(path: str) -> dict:
    """The onset record of one log, in either driver's format.

    `onset`: the first epoch whose val kNN is above 50%, or "> E" with E the
    last epoch scored; `best`, `final`, `untrained`: val kNN (%);
    `at_epoch`: {epoch: (loss, pos_sim)} at the end of epochs 10, 25, 50
    and the last, from the `onset_pair` rows, or else from the drivers'
    own rows (the first step of the next epoch; the last epoch's own first
    step; `pos_sim` None in the JAX driver's); `wall_s` from the last JSON
    line that has it."""
    knn, pair, native, wall = {}, {}, [], None
    with open(path, errors="replace") as f:
        for line in f:
            m = _KNN_ROW.match(line)
            if m:
                knn[int(m.group(1))] = float(m.group(2))
                continue
            m = _PAIR_ROW.match(line)
            if m:
                pair[int(m.group(1))] = (float(m.group(3)), float(m.group(4)))
                continue
            m = _PORT_ROW.match(line)
            if m:
                native.append((float(m.group(2)), float(m.group(3))))
                continue
            m = _JAX_ROW.match(line)
            if m:
                native.append((float(m.group(2)), None))
                continue
            if line.startswith("{") and '"wall_s"' in line:
                try:
                    wall = json.loads(line)["wall_s"]
                except (ValueError, KeyError):
                    pass
    scored = sorted(e for e in knn if e >= 0)
    onset = next((e for e in scored if knn[e] > ONSET_KNN), None)
    if pair:
        last = max(pair)
        at = {e: pair[e] for e in TABLE_EPOCHS + (last,) if e in pair}
    elif native:
        last = len(native) - 1
        at = {e: native[min(e + 1, last)] for e in TABLE_EPOCHS + (last,) if e <= last}
    else:
        at = {}
    return {"onset": onset if onset is not None else (f"> {scored[-1]}" if scored else None),
            "best": max((knn[e] for e in scored), default=None),
            "final": knn[scored[-1]] if scored else None, "untrained": knn.get(-1),
            "at_epoch": at, "wall_s": wall}


def table(rows: list[dict]) -> str:
    """A markdown table of `summarize` records (with `name`)."""
    head = ("| run | onset | best | final | untrained | "
            + " | ".join(f"loss / pos_sim @{e}" for e in TABLE_EPOCHS)
            + " | loss / pos_sim @last | wall s |")
    lines = [head, "|" + "---|" * (head.count("|") - 1)]

    def cell(v):
        if v is None:
            return "–"
        loss, pos = v
        return f"{loss:.4g} / {'–' if pos is None else f'{pos:.4g}'}"

    for r in rows:
        at = {int(k): v for k, v in r["at_epoch"].items()}
        last = max(at) if at else None
        lines.append(f"| {r['name']} | {r['onset']} | {r['best']} | {r['final']} | "
                     f"{r['untrained']} | "
                     + " | ".join(cell(at.get(e)) for e in TABLE_EPOCHS)
                     + f" | {cell(at.get(last)) if last is not None else '–'}"
                     + (f" (ep {last})" if last is not None else "")
                     + f" | {r['wall_s']} |")
    return "\n".join(lines)


# ---- runs ------------------------------------------------------------------

def parse_driver(spec: str) -> tuple[str, str, tuple]:
    """`port[:DTYPE][+VARIANT]` or `jax[@COMMIT]` -> (kind, file token,
    (dtype, variant or None) or (commit or None,))."""
    if spec == "port" or spec.startswith(("port:", "port+")):
        head, _, variant = spec.partition("+")
        dtype = head.split(":", 1)[1] if ":" in head else "float32"
        if dtype not in ("float32", "bfloat16"):
            raise ValueError(f"unknown dtype in {spec!r}")
        if variant and variant not in VARIANTS:
            raise ValueError(f"unknown variant in {spec!r}; choose from {VARIANTS}")
        token = "port" if dtype == "float32" else "port-bf16"
        return "port", f"{token}-{variant}" if variant else token, (dtype, variant or None)
    if spec == "jax" or spec.startswith("jax@"):
        commit = spec.split("@", 1)[1] if "@" in spec else None
        return "jax", "jax" if commit is None else f"jax-{commit}", (commit,)
    raise ValueError(f"unknown driver {spec!r}: port[:DTYPE][+VARIANT] or jax[@COMMIT]")


def log_path(out: str, device: str, token: str, rung: str, seed: int) -> str:
    return os.path.join(out, f"onset_pair_{device}_{token}_{rung}_seed{seed}.log")


def ref_root(commit: str) -> str:
    """`runs/_onset_ref_<commit>/`, extracted read-only from git on first use."""
    root = os.path.join(ROOT, "runs", f"_onset_ref_{commit}")
    if not os.path.isdir(os.path.join(root, "moco_tpu")):
        os.makedirs(root, exist_ok=True)
        archive = subprocess.run(["git", "-C", ROOT, "archive", commit, "moco_tpu", "tools",
                                  "native", "pyproject.toml"], capture_output=True, check=True)
        subprocess.run(["tar", "-x", "-C", root], input=archive.stdout, check=True)
    return root


def command(kind: str, arg: tuple, rung: str, seed: int, device: str,
            jax_init_dir: str) -> list[str]:
    cmd = [sys.executable, os.path.abspath(__file__), "one", kind, "--rung", rung,
           "--seed", str(seed)]
    if kind == "port":
        dtype, variant = arg
        cmd += ["--device", device, "--dtype", dtype]
        if variant:
            cmd += ["--variant", variant]
        if variant == "jax_init":
            cmd += ["--jax-init", os.path.join(jax_init_dir, f"jax_init_seed{seed}.npz")]
    elif arg[0]:
        cmd += ["--jax-root", ref_root(arg[0])]
    return cmd


def shown(cmd: list[str]) -> list[str]:
    """`cmd` as a log shows it: the interpreter as `python`, paths from the
    root of the checkout."""
    return ["python" if c == sys.executable else
            os.path.relpath(c, ROOT) if os.path.isabs(c) and c.startswith(ROOT) else c
            for c in cmd]


def run(args) -> int:
    os.makedirs(args.out, exist_ok=True)
    smi = smi_line() if args.device == "cuda" else ""
    if smi:
        print(smi, flush=True)
    jobs = deque()
    for spec in args.runs:
        driver, seeds = spec.rsplit("=", 1)
        kind, token, arg = parse_driver(driver)
        if kind == "jax" and args.device != "cpu":
            raise SystemExit("the JAX runner runs on the CPU only")
        for seed in [int(s) for s in seeds.split(",")]:
            jobs.append((token, seed, command(kind, arg, args.rung, seed, args.device,
                                              args.jax_init_dir)))
    t0 = time.time()
    if args.device == "cuda":
        # once, before the processes start, which then load the library
        sys.path.insert(0, ROOT)
        from moco_tpu_torch.ops._build import build

        print(f"kernels built: {build()[0]} ({time.time() - t0:.1f} s)", flush=True)
    slots = args.slots or len(jobs)
    free = list(range(slots))
    running, done = {}, []
    deadline = t0 + args.timeout
    try:
        while jobs or running:
            while jobs and free:
                slot = free.pop(0)
                token, seed, cmd = jobs.popleft()
                env = dict(os.environ)
                if args.cores_per_run:
                    first = args.first_core + slot * args.cores_per_run
                    cores = f"{first}-{first + args.cores_per_run - 1}"
                    cmd = ["taskset", "-c", cores] + cmd
                    env["OMP_NUM_THREADS"] = str(args.cores_per_run)
                log = log_path(args.out, args.device, token, args.rung, seed)
                f = open(log, "w")
                if smi:
                    f.write(smi + "\n")
                f.write(" ".join(shown(cmd)) + "\n")
                f.flush()
                proc = subprocess.Popen(cmd, stdout=f, stderr=subprocess.STDOUT, cwd=ROOT,
                                        env=env, start_new_session=True)
                running[proc] = (slot, token, seed, log, f)
            time.sleep(1.0)
            if time.time() > deadline:
                raise TimeoutError(f"runs still going after {args.timeout} s")
            for proc in [p for p in running if p.poll() is not None]:
                slot, token, seed, log, f = running.pop(proc)
                f.close()
                free.append(slot)
                done.append({"name": f"{token} s{seed}", "driver": token, "seed": seed,
                             "rc": proc.returncode, "log": os.path.relpath(log, ROOT),
                             **summarize(log)})
                print(json.dumps(done[-1]), flush=True)
    finally:
        for proc, (_, _, _, _, f) in running.items():
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
            f.close()
    done.sort(key=lambda r: (r["driver"], r["seed"]))
    print(f"wall {time.time() - t0:.1f} s, {len(done)} runs, rung {args.rung}, "
          f"device {args.device}", flush=True)
    print(table(done), flush=True)
    return 0 if all(r["rc"] == 0 for r in done) else 1


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    p = argparse.ArgumentParser(prog="python tests/onset_cpu_pair.py")
    sub = p.add_subparsers(dest="mode", required=True)
    one = sub.add_parser("one", help="one run in this process")
    one.add_argument("driver", choices=["port", "jax"])
    one.add_argument("--rung", choices=sorted(RUNGS), default="R1")
    one.add_argument("--seed", type=int, default=0)
    one.add_argument("--device", default="cpu", help="the port's: cpu or cuda")
    one.add_argument("--dtype", choices=["float32", "bfloat16"], default="float32")
    one.add_argument("--variant", choices=VARIANTS, default=None, help="the port's")
    one.add_argument("--jax-init", default=None, help="the jax_init variant's state (.npz)")
    one.add_argument("--jax-root", default=ROOT, help="the tree whose moco_tpu the JAX runs")
    many = sub.add_parser("run", help="runs at once, each in its own process, and a table")
    many.add_argument("--rung", choices=sorted(RUNGS), default="R1")
    many.add_argument("--device", default="cpu")
    many.add_argument("--runs", nargs="+", required=True,
                      help="DRIVER=SEED[,SEED...] ...; DRIVER is port[:DTYPE][+VARIANT] or "
                      "jax[@COMMIT]")
    many.add_argument("--slots", type=int, default=0, help="runs at once (0: all)")
    many.add_argument("--cores-per-run", type=int, default=0,
                      help="pin slot j to cores [F+jN, F+(j+1)N) (0: no pinning)")
    many.add_argument("--first-core", type=int, default=0, help="F above")
    many.add_argument("--jax-init-dir", default=os.path.join(ROOT, "runs", "_onset_init"),
                      help="port+jax_init starts from <dir>/jax_init_seed<S>.npz")
    many.add_argument("--out", default=os.path.join(ROOT, "runs"))
    many.add_argument("--timeout", type=float, default=6 * 3600.0)
    summ = sub.add_parser("summarize", help="the table of existing logs")
    summ.add_argument("logs", nargs="+")
    a = p.parse_args(argv)
    if a.mode == "one":
        if (a.variant == "jax_init") != bool(a.jax_init):
            p.error("--variant jax_init and --jax-init NPZ go together")
        if a.driver == "port":
            run_port(a.rung, a.seed, a.device, a.dtype, a.variant, a.jax_init)
        else:
            run_jax(a.rung, a.seed, os.path.abspath(a.jax_root))
        return 0
    if a.mode == "run":
        return run(a)
    print(table([{"name": os.path.basename(path), **summarize(path)} for path in a.logs]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
