"""The learning-onset probe and its one-change variants, for the card
bisection of why the port's horizon starts learning late (PERF.md, "the
onset").

The probe is `python -m moco_tpu_torch.train` with the horizon's recipe
stopped at step 3072 (48 epochs of 64 steps). Each variant changes exactly
one thing, by patching a module attribute before `train.main()`; nothing in
the package knows of them:

- `base`: the CLI unchanged;
- `plain_bn`: the BN pair's wrappers (`ops/stats.py`) replaced by their plain
  PyTorch versions inside `models/fast_bn.py`, so that no BN kernel runs on
  the card;
- `jax_init`: both encoders and the queue start from the JAX driver's
  initial state for the same seed, read from `--init NPZ` (written on the
  CPU by `tests/onset_jax_init.py`);
- `bf16_logits`: the InfoNCE logits' two dot products take operands rounded
  to bf16 and accumulate in f32, in the forward and in the backward, as
  XLA's DEFAULT precision computes an f32 dot on a TPU;
- `bf16_dots`: every f32 dot of the step so: the logits' and the embedding
  head's (`nn.Linear`, forward and both backward products).

Torch only: the JAX package never runs on the card.

    python tests/onset_probe.py one VARIANT [--init NPZ] -- <train flags>
    python tests/onset_probe.py run --runs base=0,1,2 plain_bn=0,1,2 \
        [--out DIR] [--init-dir DIR] [--max-steps 3072]

`run` starts every (variant, seed) process of `--runs` at once on one card
(`VARIANT@FLAG:VALUE=SEEDS` also replaces a probe flag's value, as in
`base@lr:0.015=0,1,2`), each with its own log, waits for all of them, and prints a table: the first epoch
whose val kNN is above 50% and the best val kNN through epoch 47.
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

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VARIANTS = ("base", "plain_bn", "jax_init", "bf16_logits", "bf16_dots")
PROBE_FLAGS = [
    "--preset", "cifar10-moco-v1", "--arch", "resnet18", "--cifar-stem", "true",
    "--dataset", "synthetic_texture", "--image-size", "32", "--batch-size", "256",
    "--num-negatives", "4096", "--embed-dim", "128", "--lr", "0.03",
    "--momentum-ema", "0.99", "--cos", "true", "--epochs", "400", "--knn-monitor", "true",
    "--knn-every-epochs", "1", "--knn-bank-size", "2048", "--num-classes", "16",
    "--print-freq", "64", "--compute-dtype", "bfloat16",
]
ONSET_KNN = 50.0     # percent
ONSET_BY_EPOCH = 47  # the last epoch of a 3072-step probe
_KNN_ROW = re.compile(r"^Epoch \[(\d+)\] kNN\(val\) top-1 ([0-9.]+)%")


def init_path(init_dir: str, seed: int) -> str:
    return os.path.join(init_dir, f"jax_init_seed{seed}.npz")


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


def apply_variant(variant: str, init: str | None) -> None:
    """Patch the port for `variant` (see the module docstring)."""
    import numpy as np
    import torch

    from moco_tpu_torch import train, train_step
    from moco_tpu_torch.models import fast_bn
    from moco_tpu_torch.ops import stats

    if variant == "plain_bn":
        fast_bn.channel_sums = stats.channel_sums_plain
        fast_bn.channel_grad_sums = stats.channel_grad_sums_plain
    elif variant == "jax_init":
        with np.load(init) as z:
            sd = {k[len("sd/"):]: torch.from_numpy(z[k]) for k in z.files if k.startswith("sd/")}
            queue = torch.from_numpy(z["queue"])
        create = train.create_train_state

        def create_from_jax(*a, **kw):
            state = create(*a, **kw)
            state.model_q.load_state_dict(sd)
            state.model_k.load_state_dict(sd)
            state.queue.copy_(queue)
            print(f"jax_init: both encoders ({len(sd)} tensors) and the queue from {init}",
                  flush=True)
            return state

        train.create_train_state = create_from_jax
    elif variant == "bf16_logits":
        train_step.infonce_logits = _tpu_default_logits()
    elif variant == "bf16_dots":
        train_step.infonce_logits = _tpu_default_logits()
        torch.nn.Linear.forward = _tpu_default_linear()
    elif variant != "base":
        raise SystemExit(f"unknown variant {variant!r}; choose from {VARIANTS}")


def one(variant: str, init: str | None, flags: list[str]) -> None:
    sys.path.insert(0, ROOT)
    apply_variant(variant, init)
    from moco_tpu_torch import train
    from moco_tpu_torch.ops import stats

    print(f"variant {variant}", flush=True)
    train.main(flags)
    print("launches " + json.dumps({"channel_sums": stats.channel_sums.launches,
                                    "channel_grad_sums": stats.channel_grad_sums.launches}),
          flush=True)


def summarize(path: str) -> dict:
    """{first_above_50, best_to_47, rows, last_loss} of one probe log."""
    first, best, rows, loss = None, None, 0, None
    with open(path, errors="replace") as f:
        for line in f:
            m = _KNN_ROW.match(line)
            if m:
                epoch, acc = int(m.group(1)), float(m.group(2))
                rows += 1
                if first is None and acc > ONSET_KNN:
                    first = epoch
                if epoch <= ONSET_BY_EPOCH:
                    best = acc if best is None else max(best, acc)
            elif line.startswith("step "):
                loss = float(line.split()[3])
    return {"first_above_50": first, "best_to_47": best, "knn_rows": rows, "last_loss": loss}


def run(args) -> int:
    os.makedirs(args.out, exist_ok=True)
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True).stdout
    except FileNotFoundError:
        smi = "nvidia-smi: not found\n"
    print(smi.strip(), flush=True)
    t0 = time.time()
    runs = [(v, int(seed)) for spec in args.runs
            for v, seeds in [spec.rsplit("=", 1)] for seed in seeds.split(",")]
    sys.path.insert(0, ROOT)
    import torch

    if torch.cuda.is_available() and any(not v.startswith("plain_bn") for v, _ in runs):
        # once, before the processes start, which then load the library
        from moco_tpu_torch.ops._build import build

        print(f"kernels built: {build()[0]} ({time.time() - t0:.1f} s)", flush=True)
    procs = {}
    try:
        for spec, seed in runs:
            # VARIANT[@FLAG:VALUE...]: the probe's flags with those values
            variant, *changed = spec.split("@")
            flags = list(PROBE_FLAGS)
            for change in changed:
                flag, value = change.split(":")
                flags[flags.index(f"--{flag}") + 1] = value
            name = "_".join([variant] + [c.replace(":", "") for c in changed])
            log = os.path.join(args.out, f"{name}_seed{seed}.log")
            cmd = [sys.executable, os.path.abspath(__file__), "one", variant]
            if variant == "jax_init":
                cmd += ["--init", init_path(args.init_dir, seed)]
            cmd += ["--"] + flags + ["--max-steps", str(args.max_steps), "--seed", str(seed)]
            with open(log, "w") as f:
                f.write(smi)
                f.write(" ".join(cmd[1:]) + "\n")
                f.flush()
                procs[(name, seed)] = (subprocess.Popen(
                    cmd, stdout=f, stderr=subprocess.STDOUT, cwd=ROOT,
                    start_new_session=True), log)
        deadline = t0 + args.timeout
        for p, _ in procs.values():
            p.wait(timeout=max(1.0, deadline - time.time()))
    finally:
        for p, _ in procs.values():
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
                p.wait()
    print(f"wall {time.time() - t0:.1f} s, {len(procs)} processes", flush=True)
    table = []
    for (variant, seed), (p, log) in procs.items():
        table.append({"variant": variant, "seed": seed, "rc": p.returncode, **summarize(log)})
        print(json.dumps(table[-1]), flush=True)
    with open(os.path.join(args.out, "summary.json"), "w") as f:
        json.dump(table, f, indent=1)
    return 0 if all(r["rc"] == 0 for r in table) else 1


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["one"]:
        head, flags = (argv[:argv.index("--")], argv[argv.index("--") + 1:]) \
            if "--" in argv else (argv, [])
        p = argparse.ArgumentParser()
        p.add_argument("variant", choices=VARIANTS)
        p.add_argument("--init", default=None)
        a = p.parse_args(head[1:])
        one(a.variant, a.init, flags)
        return 0
    p = argparse.ArgumentParser()
    p.add_argument("mode", choices=["run"])
    p.add_argument("--runs", nargs="+", default=[f"{v}=0,1,2" for v in VARIANTS[:4]],
                   help="VARIANT[@FLAG:VALUE...]=SEED[,SEED...] ...")
    p.add_argument("--out", default=os.path.join(ROOT, "runs", "_onset"))
    p.add_argument("--init-dir", default=os.path.join(ROOT, "runs", "_onset_init"))
    p.add_argument("--max-steps", type=int, default=3072)
    p.add_argument("--timeout", type=float, default=1500.0)
    return run(p.parse_args(argv))


if __name__ == "__main__":
    sys.exit(main())
