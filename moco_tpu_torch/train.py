"""Pretraining driver of the port (port of `moco_tpu/train.py`'s main path).

    python -m moco_tpu_torch.train --preset imagenet-moco-v2 --data-dir /data/imagenet \\
        --max-steps 5 [--batch-size B] [--device cpu]

Builds the dataset the config names (wrapped in the decode-once cache when
`input_cache_mb` > 0) and the state, then runs epochs: an `epoch_loader`
stages each epoch's batches ahead of the step on worker threads and copies
them to the device on a side stream; the step draws the two views on the
device from each batch's staging extents and trains. The step's metrics
stay on the device except on print steps (`print_freq`), where they reach
the host in one transfer. It runs on the card unless `--device cpu` is
given, and raises if CUDA is asked for and absent. No checkpointing,
resilience or telemetry yet.
"""

from __future__ import annotations

import argparse
import time
from typing import Callable

import torch

from moco_tpu_torch.config import PRESETS, PretrainConfig, add_config_flags, \
    collect_overrides, get_preset
from moco_tpu_torch.data.augment import aug_config_for, two_crops
from moco_tpu_torch.data.canvas_cache import CachedDataset
from moco_tpu_torch.data.datasets import build_dataset
from moco_tpu_torch.data.loader import epoch_loader
from moco_tpu_torch.train_state import TrainState, create_train_state
from moco_tpu_torch.train_step import build_encoder, build_train_step

METRIC_NAMES = ("loss", "acc1", "acc5", "pos_sim", "neg_sim", "logit_margin", "lr",
                "queue_ptr")


class DataQualityError(RuntimeError):
    """The decode-failure rate crossed `decode_abort_rate`: enough zero
    canvases to poison training, so going on would waste the run."""


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


def host_metrics(metrics: dict) -> dict:
    """A step's metrics as host numbers, the device ones in one transfer."""
    names = [k for k, v in metrics.items() if isinstance(v, torch.Tensor)]
    values = dict(zip(names, torch.stack([metrics[k].float() for k in names]).cpu().tolist()))
    return {k: values.get(k, v) for k, v in metrics.items()}


def print_step(step: int, metrics: dict, seconds: float, batch: int) -> None:
    shown = " ".join(f"{k} {metrics[k]:.6g}" for k in METRIC_NAMES)
    print(f"step {step} {shown} step_s {seconds:.4f} imgs_s {batch / seconds:.1f}",
          flush=True)


def check_decode_rate(dataset, config: PretrainConfig) -> None:
    """Raise `DataQualityError` once the cumulative decode-failure rate
    exceeds `decode_abort_rate` (after at least one batch's worth)."""
    failed = getattr(dataset, "decode_failures", 0)
    total = getattr(dataset, "decode_total", 0)
    if config.decode_abort_rate and total >= config.batch_size \
            and failed / total > config.decode_abort_rate:
        raise DataQualityError(
            f"decode-failure rate {failed}/{total} = {failed / total:.1%} exceeds "
            f"decode_abort_rate={config.decode_abort_rate:.1%}: training on zero "
            "canvases would silently waste the run")


def train(config: PretrainConfig, max_steps: int | None = None, device="cuda",
          dataset=None, on_step: Callable[[int, dict, float], None] | None = None,
          stats=None) -> tuple[TrainState, list[dict]]:
    """Run `max_steps` steps (default: the whole schedule) on `dataset`
    (default: the one the config names). Returns the state and the metrics
    of each print step as host numbers. `on_step(step, metrics, seconds)`
    sees every print step (default: print it); `seconds` is the host time
    per step since the previous print, ending with the metrics on the host,
    which waits for the device. `stats` is an optional
    `InputPipelineStats` the input pipeline reports to."""
    dev = resolve_device(device)
    if dataset is None:
        dataset = build_dataset(config.dataset, config.data_dir, image_size=config.image_size,
                                stage_size=config.stage_size, num_workers=config.num_workers)
    if config.input_cache_mb:
        dataset = CachedDataset(dataset, config.input_cache_mb, stats=stats)
    if len(dataset) < config.batch_size:
        raise ValueError(f"the dataset holds {len(dataset)} samples, fewer than one batch "
                         f"of {config.batch_size}")
    steps_per_epoch = min(config.steps_per_epoch or len(dataset) // config.batch_size,
                          len(dataset) // config.batch_size)
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
    since, t_last = 0, time.perf_counter()
    while state.step < total:
        loader = epoch_loader(dataset, epoch, config.seed, config.batch_size, dev,
                              depth=config.prefetch_depth, workers=config.staging_workers,
                              stats=stats, trim_h2d=config.h2d_trim)
        try:
            for i, (images, _labels, extents) in enumerate(loader):
                if i >= steps_per_epoch or state.step >= total:
                    break
                im_q, im_k = two_crops(images, aug_cfg, data_gen, extents)
                metrics = step_fn(state, im_q, im_k)
                since += 1
                check_decode_rate(dataset, config)
                if i % config.print_freq == 0:
                    metrics = host_metrics(metrics)
                    seconds = (time.perf_counter() - t_last) / since
                    history.append(metrics)
                    on_step(state.step, metrics, seconds)
                    since, t_last = 0, time.perf_counter()
        finally:
            loader.close_quietly()
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
