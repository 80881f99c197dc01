"""The learning horizon: a config-1-shaped MoCo-v1 pretrain with the
per-epoch kNN monitor, on a dataset an untrained network cannot solve,
gated on the trained features beating the random-init baseline by a wide
margin (the port's counterpart of `tools/_horizon_run.py`).

    python -m moco_tpu_torch.horizon [--lr L] [--batch B] [--momentum M]
        [--steps N] [--knn-every E] [--samples S] [--arch A] [--image-size P]
        [--ckpt-dir DIR] [--export-path enc.npz] [--device cuda|cpu]

`SyntheticTextureDataset` splits the class signal (an augmentation-
invariant texture) from the dominant pixel variance (an augmentation-
destroyed color cast): random features score near chance (1/16), so any
kNN gain is learning. The driver prints the untrained baseline as an
`Epoch [-1]` row, and this entry point exits 1 unless the final kNN beats
that baseline by more than 0.15 and the loss ends more than 1.0 below the
(K+1)-way chance level log(K+1).

On the card (the default) it runs the recipe at batch 256 in bf16 with the
monitor every epoch; with `--device cpu` at batch 64 in f32, the monitor
every 2 epochs. resnet18 with the CIFAR stem at 32 px, K=4096, m=0.99,
lr 0.03 cosine, 16384 samples (batch * 128, capped). `--steps` defaults to
the tool's 3200, a budget the gate refuses; the horizon is `--steps 25600`
(400 epochs of 64 steps at batch 256).

With `--ckpt-dir` the run checkpoints every 4 epochs and resumes from the
directory's latest step. A resume must continue the same run: the flags
are kept in `horizon_args.json` on a fresh start and a resume with other
flags, no fingerprint or an unreadable untrained-baseline sidecar exits 4
before any step. A resume after the final step exits 3 (nothing ran to
gate; the first run's log has the verdict). Exits 45 when CUDA is asked
for and absent, as the pretrain CLI does.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time

from moco_tpu_torch.config import get_preset
from moco_tpu_torch.data.datasets import SyntheticTextureDataset
from moco_tpu_torch.resilience.exitcodes import EXIT_CONFIG_ERROR
from moco_tpu_torch.train import train
from moco_tpu_torch.utils.device import resolve_device, set_precision_policy
from moco_tpu_torch.utils.logging import log_event

EXIT_GATE_FAILED = 1
EXIT_ALREADY_COMPLETE = 3
EXIT_RESUME_REFUSED = 4
KNN_MARGIN = 0.15        # the final kNN must beat the untrained one by more
LOSS_DEPARTURE = 1.0     # the loss must end this far below log(K+1)
NUM_NEGATIVES = 4096
NUM_CLASSES = 16


def build_parser(on_card: bool) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m moco_tpu_torch.horizon",
                                description="MoCo-v1 learning horizon with its gates")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--lr", type=float, default=0.03)
    p.add_argument("--batch", type=int, default=256 if on_card else 64)
    p.add_argument("--momentum", type=float, default=0.99)
    p.add_argument("--steps", type=int, default=3200)
    p.add_argument("--knn-every", type=int, default=1 if on_card else 2)
    p.add_argument("--samples", type=int, default=0,
                   help="dataset size (0 = batch*128 capped at 16384)")
    p.add_argument("--arch", default="resnet18")
    p.add_argument("--image-size", type=int, default=32)
    p.add_argument("--ckpt-dir", default="",
                   help="checkpoint dir ('' = off): a killed run resumes from it")
    p.add_argument("--export-path", default="",
                   help="write the query encoder here at the run's end (.npz)")
    return p


def schedule(batch: int, samples: int, steps: int) -> tuple[int, int, int, int]:
    """(samples, steps_per_epoch, epochs, total_steps): at least one full
    batch an epoch, whole epochs only."""
    samples = max(samples or min(batch * 128, 16384), batch)
    steps_per_epoch = samples // batch
    epochs = max(steps // steps_per_epoch, 1)
    return samples, steps_per_epoch, epochs, epochs * steps_per_epoch


def horizon_config(args, epochs: int, steps_per_epoch: int, on_card: bool):
    """The port's `cifar10-moco-v1` preset with the horizon's fields."""
    return get_preset("cifar10-moco-v1").replace(
        arch=args.arch, cifar_stem=True, dataset="synthetic_texture",
        image_size=args.image_size, batch_size=args.batch, num_negatives=NUM_NEGATIVES,
        embed_dim=128, lr=args.lr, momentum_ema=args.momentum, cos=True, epochs=epochs,
        steps_per_epoch=None, knn_monitor=True, knn_every_epochs=args.knn_every,
        knn_bank_size=2048, num_classes=NUM_CLASSES, ckpt_dir=args.ckpt_dir,
        ckpt_every_epochs=4, resume="auto" if args.ckpt_dir else "", tb_dir="",
        print_freq=steps_per_epoch, num_workers=1, export_path=args.export_path,
        compute_dtype="bfloat16" if on_card else "float32")


def check_resume(ckpt_dir: str, run_args: dict) -> None:
    """On a fresh `ckpt_dir`, record `run_args`; on one holding a
    checkpoint, exit 4 unless its fingerprint equals `run_args` and its
    untrained-baseline sidecar is readable."""
    args_path = os.path.join(ckpt_dir, "horizon_args.json")
    baseline_path = os.path.join(ckpt_dir, "untrained_baseline.json")
    has_ckpt = os.path.isdir(ckpt_dir) and any(n.isdigit() for n in os.listdir(ckpt_dir))
    if not has_ckpt:
        os.makedirs(ckpt_dir, exist_ok=True)
        tmp = args_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(run_args, f)
        os.replace(tmp, args_path)
        return
    try:
        with open(args_path) as f:
            prev = json.load(f)
    except (OSError, json.JSONDecodeError):
        print(f"resume refused: {args_path} missing/corrupt — cannot prove the resumed "
              "flags match the original run", flush=True)
        sys.exit(EXIT_RESUME_REFUSED)
    # kept only for parity with tools/_horizon_run.py, whose fingerprints
    # from before its --arch/--image-size flags lack the two keys (those runs
    # were resnet18 at 32 px); every fingerprint this module writes has them
    prev.setdefault("arch", "resnet18")
    prev.setdefault("image_size", 32)
    if prev != run_args:
        print(f"resume refused: flags changed {prev} -> {run_args}", flush=True)
        sys.exit(EXIT_RESUME_REFUSED)
    try:
        with open(baseline_path) as f:
            side = json.load(f)
        ok = (isinstance(side, dict) and len(side) >= 1 and all(
            k.startswith("knn_") and k.endswith("_untrained") and isinstance(v, float)
            for k, v in side.items()))
    except (OSError, json.JSONDecodeError):
        ok = False
    if not ok:
        print(f"resume refused: {baseline_path} missing/corrupt — the gate would have "
              "nothing honest to compare against", flush=True)
        sys.exit(EXIT_RESUME_REFUSED)


def _last(history: list[dict], *keys: str):
    """The newest value of the first of `keys` the history holds, or None."""
    for key in keys:
        values = [h[key] for h in history if key in h]
        if values:
            return values[-1]
    return None


def main(argv=None) -> None:
    set_precision_policy()
    # the device picks the other flags' defaults
    try:
        dev = resolve_device(build_parser(True).parse_known_args(argv)[0].device)
    except (RuntimeError, ValueError) as e:
        log_event("exit", f"device config error: {e}", code=EXIT_CONFIG_ERROR)
        sys.exit(EXIT_CONFIG_ERROR)
    on_card = dev.type == "cuda"
    args = build_parser(on_card).parse_args(argv)
    samples, steps_per_epoch, epochs, total_steps = schedule(args.batch, args.samples,
                                                             args.steps)
    backend = dev.type
    cfg = horizon_config(args, epochs, steps_per_epoch, on_card)
    if args.ckpt_dir:
        # a resume continues the same run: the step budget (the cosine decays
        # over `epochs`), batch, samples, lr, m, and the numerics (a CPU f32
        # run must not resume on the card in bf16)
        check_resume(args.ckpt_dir, {
            "steps": total_steps, "batch": args.batch, "samples": samples,
            "arch": args.arch, "image_size": args.image_size, "lr": args.lr,
            "momentum_ema": args.momentum, "backend": backend,
            "compute_dtype": cfg.compute_dtype})
    data = SyntheticTextureDataset(num_samples=samples, image_size=args.image_size,
                                   num_classes=NUM_CLASSES)
    chance_loss = math.log(cfg.num_negatives + 1)
    print(json.dumps({"lr": args.lr, "batch": args.batch, "momentum_ema": args.momentum,
                      "backend": backend,
                      "config": f"horizon ({args.arch} {args.image_size}px K="
                                f"{cfg.num_negatives}, B={args.batch}, m={args.momentum}, "
                                f"{samples}-sample synthetic_texture/{NUM_CLASSES}-class, "
                                f"{total_steps} steps)",
                      "chance_knn": 1.0 / data.num_classes,
                      "chance_loss": round(chance_loss, 3)}), flush=True)
    t0 = time.time()
    state, history = train(cfg, device=dev, dataset=data)
    # the monitor scores a real val split for synthetic_texture (a held-out
    # draw of the same classes); the train-holdout tags are the fallback
    baseline = _last(history, "knn_val_top1_untrained", "knn_train_top1_untrained")
    final_knn = _last(history, "knn_val_top1", "knn_train_top1")
    final_loss = _last(history, "loss")
    if state.step >= total_steps and final_loss is None:
        # resumed after the final checkpoint: no step ran, nothing to gate
        print(json.dumps({"already_complete": True, "steps": int(state.step),
                          "ckpt_dir": args.ckpt_dir}), flush=True)
        sys.exit(EXIT_ALREADY_COMPLETE)
    if baseline is None:
        # falling back to chance would quietly lower the gate
        print("no untrained baseline available (resume without sidecar?) — cannot gate "
              "honestly", flush=True)
        sys.exit(EXIT_RESUME_REFUSED)
    split = "val" if any("knn_val_top1" in h for h in history) else "train-holdout"
    print(json.dumps({"untrained_knn": baseline, "final_knn_top1": final_knn,
                      "split": split, "final_loss": final_loss, "lr": args.lr,
                      "momentum_ema": args.momentum, "batch": args.batch,
                      "steps": int(state.step), "wall_s": round(time.time() - t0, 1),
                      "backend": backend}, default=float), flush=True)
    failed = []
    if final_knn is None or not final_knn > baseline + KNN_MARGIN:
        failed.append(f"kNN gain over the untrained baseline is not convincing: {final_knn} "
                      f"vs baseline {baseline} (margin {KNN_MARGIN})")
    if final_loss is None or not final_loss < chance_loss - LOSS_DEPARTURE:
        failed.append(f"loss {final_loss} has not departed the chance level "
                      f"log(K+1)={chance_loss:.2f}")
    if failed:
        for msg in failed:
            print(f"HORIZON GATE FAILED: {msg}", flush=True)
        sys.exit(EXIT_GATE_FAILED)
    print("HORIZON GATES PASSED", flush=True)


if __name__ == "__main__":
    main()
