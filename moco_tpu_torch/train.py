"""Pretraining driver of the port (port of `moco_tpu/train.py`'s main path).

    python -m moco_tpu_torch.train --preset imagenet-moco-v2 --data-dir /data/imagenet \\
        --max-steps 5 [--batch-size B] [--ckpt-dir DIR [--resume auto]] \\
        [--export-path encoder.npz] [--knn-monitor true] [--device cpu]

Builds the dataset the config names (wrapped in the decode-once cache when
`input_cache_mb` > 0) and the state, then runs epochs: an `epoch_loader`
stages each epoch's batches ahead of the step on worker threads and copies
them to the device on a side stream; the step draws the two views on the
device from each batch's staging extents and trains. The step's metrics
stay on the device except on print steps (`print_freq`), where they reach
the host in one transfer. It runs on the card unless `--device cpu` is
given, and raises if CUDA is asked for and absent.

With `ckpt_dir` the whole state is checkpointed every `ckpt_every_epochs`
epochs (and when `max_steps` ends the run on such an epoch) with the
data-stream position it resumes at; `resume` restores it (`"auto"`, a step
number, or `<ckpt_dir>/<step>`), and the resumed epoch skips the batches it
already used, so a resumed run is the uninterrupted one. `export_path`
writes the query encoder in the reference's checkpoint dialect at the end.
`knn_monitor` scores a kNN top-1 of the query encoder's embedding at step 0
and every `knn_every_epochs` epochs (and at the run's last). Telemetry,
preemption and rollback are not ported yet.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Callable

import numpy as np
import torch

from moco_tpu_torch.checkpoint import checkpoint_manager, export_encoder_q, maybe_resume, \
    read_position, resume_dir, save_checkpoint
from moco_tpu_torch.config import PretrainConfig, add_config_flags, collect_overrides, \
    get_preset, preset_names
from moco_tpu_torch.data.augment import aug_config_for, two_crops
from moco_tpu_torch.data.canvas_cache import CachedDataset
from moco_tpu_torch.data.datasets import build_dataset
from moco_tpu_torch.data.loader import epoch_loader
from moco_tpu_torch.evals.knn import build_feature_fn, encode_dataset
from moco_tpu_torch.ops.knn import knn_accuracy
from moco_tpu_torch.train_state import TrainState, create_train_state
from moco_tpu_torch.train_step import build_encoder, build_train_step
from moco_tpu_torch.utils.device import resolve_device

METRIC_NAMES = ("loss", "acc1", "acc5", "pos_sim", "neg_sim", "logit_margin", "lr",
                "queue_ptr")


class DataQualityError(RuntimeError):
    """The decode-failure rate crossed `decode_abort_rate`: enough zero
    canvases to poison training, so going on would waste the run."""


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


def make_feature_fn(model):
    """The kNN monitor's embedding: the query encoder's L2-normalized output
    in eval mode (BN on its running statistics), without autograd; the
    encoder goes back to train mode after each batch."""
    return build_feature_fn(model)


def knn_monitor(config, feature_fn, state: TrainState, dataset,
                val_dataset=None) -> tuple[float, bool]:
    """kNN top-1 at monitoring scale: the bank is a `knn_bank_size` subset
    of the train set; the queries come from `val_dataset` where there is
    one (a real val metric), else from a held-out 20% of that subset.
    Returns (accuracy, is_real_val)."""
    n = min(len(dataset), config.knn_bank_size)
    rng = np.random.RandomState(config.seed)
    idx = rng.permutation(len(dataset))[:n]
    if val_dataset is not None:
        bank_idx = idx
        q_set = val_dataset
        q_idx = rng.permutation(len(val_dataset))[:max(n // 4, 1)]
    else:
        split = int(n * 0.8)
        bank_idx, q_idx = idx[:split], idx[split:]
        q_set = dataset
    bank, bank_labels = encode_dataset(state.model_q, dataset, config, indices=bank_idx,
                                       feature_fn=feature_fn)
    val, val_labels = encode_dataset(state.model_q, q_set, config, indices=q_idx,
                                     feature_fn=feature_fn)
    acc = knn_accuracy(val, val_labels, bank, bank_labels, num_classes=dataset.num_classes,
                       k=min(200, len(bank_idx)), temperature=0.07)
    return acc, val_dataset is not None


def _monitor_val_split(config, train_dataset):
    """A real validation split for the kNN monitor where the dataset has
    one (imagefolder `val/` with the train split's classes, the CIFAR-10
    test batch, a held-out synthetic texture draw), else None."""
    if config.dataset == "imagefolder":
        val_dir = os.path.join(config.data_dir, "val")
        if os.path.isdir(val_dir):
            try:
                val = build_dataset("imagefolder", val_dir, image_size=config.image_size,
                                    stage_size=config.stage_size,
                                    num_workers=config.num_workers)
            except FileNotFoundError:
                return None  # an empty val/ placeholder
            if val.class_to_idx != getattr(train_dataset, "class_to_idx", None):
                print("kNN monitor: val/ class directories differ from train/; labels "
                      "would misalign, so the monitor holds out train data", flush=True)
                return None
            return val
    if config.dataset == "cifar10":
        try:
            return build_dataset("cifar10", config.data_dir, train=False)
        except FileNotFoundError:
            return None
    if config.dataset == "synthetic_texture":
        from moco_tpu_torch.data.datasets import SyntheticTextureDataset

        # the same classes (fixed-seed tiles), another draw, the train
        # split's distribution knobs
        return SyntheticTextureDataset(
            num_samples=2048, image_size=config.image_size, num_classes=config.num_classes,
            seed=getattr(train_dataset, "seed", 0) + 10007,
            texture_amp=getattr(train_dataset, "texture_amp", 0.4),
            cast_strength=getattr(train_dataset, "cast_strength", 0.5))
    return None


def _write_json(path: str, payload: dict) -> None:
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(payload, f)
    os.replace(tmp, path)


def train(config: PretrainConfig, max_steps: int | None = None, device="cuda",
          dataset=None, on_step: Callable[[int, dict, float], None] | None = None,
          stats=None) -> tuple[TrainState, list[dict]]:
    """Run up to step `max_steps` (default: the whole schedule) on `dataset`
    (default: the one the config names), resuming first if the config says
    so. Returns the state and a history: the metrics of each print step as
    host numbers, and `{"step", "knn_*_top1"}` for each kNN monitor run.
    `on_step(step, metrics, seconds)` sees every print step (default: print
    it); `seconds` is the host time per step since the previous print,
    ending with the metrics on the host, which waits for the device.
    `stats` is an optional `InputPipelineStats` the input pipeline reports
    to."""
    dev = resolve_device(device)
    if config.knn_monitor and config.knn_every_epochs < 1:
        raise ValueError(f"knn_every_epochs must be >= 1 (got {config.knn_every_epochs}); "
                         "disable the monitor with knn_monitor=False instead")
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
    mgr = checkpoint_manager(config.ckpt_dir) if config.ckpt_dir else None
    state = maybe_resume(mgr, state, config.resume)
    # the data-stream position: the sidecar of the restored step, else step
    # arithmetic; the resumed epoch skips the batches it already used (the
    # epoch permutation is deterministic, so batch i is the interrupted
    # run's batch i)
    pos = None
    if state.step:
        pos = read_position(resume_dir(mgr, config.resume), state.step)
        print(f"resumed at step {state.step}", flush=True)
    epoch, skip = pos if pos is not None else divmod(state.step, steps_per_epoch)

    step_fn = build_train_step(config, steps_per_epoch)
    aug_cfg = aug_config_for(config)
    history = []
    feature_fn = monitor_val = None
    if config.knn_monitor:
        feature_fn = make_feature_fn(state.model_q)
        monitor_val = _monitor_val_split(config, dataset)
    baseline_path = os.path.join(mgr.directory, "untrained_baseline.json") if mgr else None
    if config.knn_monitor and state.step == 0:
        # what random features score on the same data, before any step
        acc0, is_val = knn_monitor(config, feature_fn, state, dataset, monitor_val)
        tag0 = "knn_val_top1_untrained" if is_val else "knn_train_top1_untrained"
        history.append({"step": 0, tag0: acc0})
        print(f"Epoch [-1] kNN({'val' if is_val else 'train'}) top-1 {100 * acc0:.2f}% "
              f"(UNTRAINED baseline; chance {100.0 / dataset.num_classes:.2f}%)", flush=True)
        if baseline_path:
            _write_json(baseline_path, {tag0: acc0})  # a resumed run cannot measure it
    elif config.knn_monitor and baseline_path and os.path.exists(baseline_path):
        try:
            with open(baseline_path) as f:
                baseline = dict(json.load(f))
        except (OSError, ValueError, TypeError):
            baseline = {}  # unreadable: the history carries no baseline
        if baseline:
            history.append({"step": 0, **baseline})
            print(f"kNN untrained baseline {baseline}, restored from {baseline_path}",
                  flush=True)
    since, t_last = 0, time.perf_counter()
    while state.step < total:
        epoch_start_step = state.step
        loader = epoch_loader(dataset, epoch, config.seed, config.batch_size, dev,
                              skip_batches=skip, depth=config.prefetch_depth,
                              workers=config.staging_workers, stats=stats,
                              trim_h2d=config.h2d_trim)
        next_batch = skip
        try:
            for i, (images, _labels, extents) in enumerate(loader, start=skip):
                if i >= steps_per_epoch or state.step >= total:
                    break
                im_q, im_k = two_crops(images, aug_cfg, state.data_generator, extents)
                metrics = step_fn(state, im_q, im_k)
                next_batch = i + 1
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
        finished = state.step >= total
        t_pause = time.perf_counter()
        # epochs with no step (a resume at an epoch's end) report and save nothing
        if config.knn_monitor and state.step > epoch_start_step and (
                (epoch + 1) % config.knn_every_epochs == 0 or epoch == config.epochs - 1
                or finished):
            acc, is_val = knn_monitor(config, feature_fn, state, dataset, monitor_val)
            tag = "knn_val_top1" if is_val else "knn_train_top1"
            history.append({"step": state.step, tag: acc})
            print(f"Epoch [{epoch}] kNN({'val' if is_val else 'train'}) top-1 "
                  f"{100 * acc:.2f}%", flush=True)
        if mgr is not None and state.step > epoch_start_step \
                and (epoch + 1) % config.ckpt_every_epochs == 0:
            position = (epoch + 1, 0) if next_batch >= steps_per_epoch else (epoch, next_batch)
            save_checkpoint(mgr, state, state.step, position=position)
        epoch, skip = epoch + 1, 0
        t_last += time.perf_counter() - t_pause  # the printed step time leaves these out
    if config.export_path:
        export_encoder_q(state, config.export_path)
        print(f"exported encoder -> {config.export_path}", flush=True)
    return state, history


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="moco_tpu_torch pretraining")
    parser.add_argument("--preset", default="imagenet-moco-v2",
                        choices=preset_names(PretrainConfig))
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
