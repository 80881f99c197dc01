"""Pretraining driver of the port (port of `moco_tpu/train.py`'s main path).

    python -m moco_tpu_torch.train --preset imagenet-moco-v2 --dataset synthetic \\
        --max-steps 5 [--batch-size B] [--device cpu]

Builds the state, then runs steps: stage a uint8 batch through pinned
memory, draw the two views on the device, run the train step, print the
step's metrics. It runs on the card unless `--device cpu` is given, and
raises if CUDA is asked for and absent. No checkpointing, resilience or
telemetry yet.
"""

from __future__ import annotations

import argparse
import time
from typing import Callable

import torch

from moco_tpu_torch.config import PRESETS, PretrainConfig, add_config_flags, \
    collect_overrides, get_preset
from moco_tpu_torch.data.augment import aug_config_for, two_crops
from moco_tpu_torch.data.datasets import SyntheticDataset, epoch_permutation, stage
from moco_tpu_torch.train_state import TrainState, create_train_state
from moco_tpu_torch.train_step import build_encoder, build_train_step

METRIC_NAMES = ("loss", "acc1", "acc5", "pos_sim", "neg_sim", "logit_margin", "lr",
                "queue_ptr")


def resolve_device(device: str | torch.device) -> torch.device:
    """The requested device; CUDA that is absent is an error, never a quiet
    fall back to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA was requested but torch.cuda.is_available() is False; "
            "pass --device cpu to run the plain PyTorch versions on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def print_step(step: int, metrics: dict, seconds: float, batch: int) -> None:
    shown = " ".join(f"{k} {metrics[k]:.6g}" for k in METRIC_NAMES)
    print(f"step {step} {shown} step_s {seconds:.4f} imgs_s {batch / seconds:.1f}",
          flush=True)


def train(config: PretrainConfig, max_steps: int | None = None, device="cuda",
          dataset=None,
          on_step: Callable[[int, dict, float], None] | None = None
          ) -> tuple[TrainState, list[dict]]:
    """Run `max_steps` steps (default: the whole schedule). Returns the state
    and each step's metrics as host numbers. `on_step(step, metrics,
    seconds)` sees every step (default: print it); `seconds` is host time
    from staging to the metrics on the host, which waits for the device."""
    dev = resolve_device(device)
    if dataset is None:
        dataset = SyntheticDataset(image_size=config.image_size)
    available = max(len(dataset) // config.batch_size, 1)
    steps_per_epoch = min(config.steps_per_epoch or available, available)
    total = config.epochs * steps_per_epoch if max_steps is None else max_steps
    if on_step is None:
        def on_step(step, metrics, seconds):
            print_step(step, metrics, seconds, config.batch_size)

    state = create_train_state(config, build_encoder(config), dev, seed=config.seed)
    step_fn = build_train_step(config, steps_per_epoch)
    aug_cfg = aug_config_for(config)
    data_gen = torch.Generator(device=dev).manual_seed(config.seed + 1)
    history = []
    epoch = 0
    while state.step < total:
        order = epoch_permutation(len(dataset), epoch, config.seed, config.batch_size)
        for i in range(min(steps_per_epoch, total - state.step)):
            t0 = time.perf_counter()
            idx = order[i * config.batch_size:(i + 1) * config.batch_size]
            images, _labels = dataset.get_batch(idx)
            im_q, im_k = two_crops(stage(images, dev), aug_cfg, data_gen)
            metrics = {k: float(v) for k, v in step_fn(state, im_q, im_k).items()}
            seconds = time.perf_counter() - t0
            history.append(metrics)
            on_step(state.step, metrics, seconds)
        epoch += 1
    return state, history


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="moco_tpu_torch pretraining")
    parser.add_argument("--preset", default="imagenet-moco-v2", choices=sorted(PRESETS))
    parser.add_argument("--max-steps", type=int, default=None)
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    add_config_flags(parser)
    args = parser.parse_args(argv)
    config = get_preset(args.preset).replace(**collect_overrides(args))
    dev = resolve_device(args.device)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"config: {config}\ndevice: {dev} ({name})", flush=True)
    train(config, max_steps=args.max_steps, device=dev)


if __name__ == "__main__":
    main()
