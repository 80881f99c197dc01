"""Linear probe on frozen features (port of `moco_tpu/evals/lincls.py`, the
reference's `main_lincls.py`: the program behind the 67.5% top-1).

    python -m moco_tpu_torch.evals.lincls --pretrained encoder.npz --data-dir DIR \\
        [--ckpt-dir DIR --resume auto] [--evaluate true] [--max-steps N] [--device cpu]

The reference's semantics:
- checkpoint surgery: keep the backbone of `module.encoder_q.*` (or of a
  v3 export: the `backbone/` tree of a ResNet, the timm dialect of a ViT,
  `--arch vit_*`), drop the contrastive head, and require that exactly the
  backbone is left (`checkpoint.load_for_inference`);
- the classifier `fc.weight ~ N(0, 0.01)`, `fc.bias = 0`, drawn from a
  seeded generator;
- only the classifier trains: SGD lr 30, momentum 0.9, wd 0, x0.1 at
  epochs 60/80 (or cosine), 100 epochs;
- the frozen backbone runs in eval mode even on training batches (BN on its
  running statistics, `model.eval()`), without autograd, in f32;
- the train transform is RandomResizedCrop(0.08-1) + flip, drawn per epoch
  from a generator seeded by (seed, epoch), so an epoch-granular resume
  replays the same crops; validation is the center crop, acc@1/acc@5;
- `sanity_check`: after training, the backbone reloaded FROM THE FILE must
  equal the one that ran, bit for bit;
- probe checkpoints (classifier, its momentum, best acc@1) at every
  epoch's end, `--resume auto` from the start of the newest one's epoch,
  and `--evaluate`.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch
from torch import nn

from moco_tpu_torch.checkpoint import checkpoint_manager, cpu_copy, load_for_inference, \
    load_pretrained_backbone
from moco_tpu_torch.config import EvalConfig
from moco_tpu_torch.data.augment import augment_batch, default_eval_crop_frac, \
    eval_aug_config, v1_aug_config
from moco_tpu_torch.data.datasets import build_dataset
from moco_tpu_torch.data.loader import epoch_loader, stage_eval_batch
from moco_tpu_torch.ops.losses import contrastive_accuracy, softmax_cross_entropy
from moco_tpu_torch.ops.schedules import cosine_lr, step_lr
from moco_tpu_torch.utils.device import resolve_device, set_precision_policy
from moco_tpu_torch.utils.meters import AverageMeter, ProgressMeter


def load_frozen_backbone(config: EvalConfig, device="cuda") -> nn.Module:
    """The feature-mode backbone with the pretrained weights, by checkpoint
    surgery, frozen and in eval mode on `device`."""
    return load_for_inference(config.pretrained, config.arch, cifar_stem=config.cifar_stem,
                              device=device, image_size=config.image_size)


def init_classifier(generator: torch.Generator, feat_dim: int, num_classes: int) -> nn.Linear:
    """`fc.weight ~ N(0, 0.01)` drawn from `generator` (on the CPU), zero bias."""
    fc = nn.Linear(feat_dim, num_classes)
    with torch.no_grad():
        fc.weight.copy_(0.01 * torch.randn(num_classes, feat_dim, generator=generator))
        fc.bias.zero_()
    return fc


def build_lincls_steps(model: nn.Module, fc: nn.Linear, optimizer: torch.optim.Optimizer):
    """`train_step(images, labels, lr) -> metrics` (one SGD step of `fc`)
    and `eval_step(images, labels) -> (correct@1, correct@5)`; the backbone
    runs in eval mode without autograd in both. Metrics stay on the
    device."""

    def features(images):
        with torch.no_grad():
            return model(images)

    def train_step(images, labels, lr: float) -> dict:
        logits = fc(features(images))
        loss = softmax_cross_entropy(logits, labels)
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        for group in optimizer.param_groups:
            group["lr"] = lr
        optimizer.step()
        acc1, acc5 = contrastive_accuracy(logits.detach(), labels)
        return {"loss": loss.detach(), "acc1": acc1, "acc5": acc5}

    def eval_step(images, labels):
        with torch.no_grad():
            acc1, acc5 = contrastive_accuracy(fc(features(images)), labels)
        n = labels.shape[0]
        return acc1 * n / 100.0, acc5 * n / 100.0

    return train_step, eval_step


def validate(eval_step, dataset, config: EvalConfig, device) -> tuple[float, float]:
    """Center-crop validation: acc@1 and acc@5 (%) over every image of
    `dataset`; the label tail of the last batch is padded with -1, which
    never matches."""
    cfg = eval_aug_config(config.image_size,
                          crop_frac=default_eval_crop_frac(config.image_size))
    n, b = len(dataset), config.batch_size
    correct = torch.zeros(2, device=device)
    for start in range(0, n, b):
        idx = np.arange(start, min(start + b, n))
        imgs, labels, extents = stage_eval_batch(dataset.get_batch(idx), b, device,
                                                 pad_label=-1)
        correct += torch.stack(eval_step(augment_batch(imgs, None, cfg, extents), labels))
    c1, c5 = correct.cpu().tolist()
    return 100.0 * c1 / max(n, 1), 100.0 * c5 / max(n, 1)


def sanity_check(state_after: dict, state_pretrained: dict) -> None:
    """Every backbone weight and BN statistic must be bit-identical to the
    pretrained checkpoint's after probe training. The names must be the
    same set, so an empty or partial reload fails instead of comparing
    nothing."""
    if not state_pretrained:
        raise AssertionError("sanity_check got an empty pretrained state")
    if state_after.keys() != state_pretrained.keys():
        raise AssertionError(f"backbone names differ: "
                             f"{sorted(state_after.keys() ^ state_pretrained.keys())[:5]}")
    for name, ref in state_pretrained.items():
        if not torch.equal(state_after[name].detach().cpu(), ref.cpu()):
            raise AssertionError(f"backbone weight changed during linear probe: {name}")


def _epoch_generator(seed: int, epoch: int, device) -> torch.Generator:
    """The train transform's draws for one epoch."""
    return torch.Generator(device=device).manual_seed(((seed + 1) * 100003 + epoch) % 2**63)


def train_aug_config(image_size: int):
    """The reference's supervised train transform: RandomResizedCrop with
    scale 0.08-1 and a horizontal flip, nothing else."""
    return v1_aug_config(image_size)._replace(
        min_scale=0.08, jitter_prob=0.0, grayscale_prob=0.0,
        brightness=0.0, contrast=0.0, saturation=0.0, hue=0.0)


def train_lincls(config: EvalConfig, max_steps: int | None = None, device="cuda",
                 dataset=None, val_dataset=None, on_step=None):
    """Train the probe; returns (fc, best acc@1). `dataset`/`val_dataset`
    replace the ones the config names. `on_step(step, metrics)` sees the
    metrics (host numbers) of every print step."""
    set_precision_policy()
    dev = resolve_device(device)
    if config.resume not in ("", "auto"):
        raise ValueError(f"the probe resumes with '' or 'auto', got {config.resume!r}")
    if config.resume and not config.ckpt_dir:
        raise ValueError("--resume requires a ckpt_dir to resume from")
    train_set = dataset if dataset is not None else build_dataset(
        config.dataset, config.data_dir, image_size=config.image_size,
        stage_size=config.stage_size, num_workers=config.num_workers)
    val_set = val_dataset if val_dataset is not None else _val_split(config, train_set)
    if len(train_set) < config.batch_size:
        raise ValueError(f"the dataset holds {len(train_set)} samples, fewer than one batch "
                         f"of {config.batch_size}")
    model = load_frozen_backbone(config, dev)
    fc = init_classifier(torch.Generator().manual_seed(config.seed), model.feature_dim,
                         config.num_classes).to(dev)
    optimizer = torch.optim.SGD(fc.parameters(), lr=config.effective_lr,
                                momentum=config.sgd_momentum,
                                weight_decay=config.weight_decay)
    train_step, eval_step = build_lincls_steps(model, fc, optimizer)
    steps_per_epoch = max(len(train_set) // config.batch_size, 1)
    lr = config.effective_lr

    def sched(step: int) -> float:
        epoch = step // steps_per_epoch
        if config.cos:
            return cosine_lr(lr, epoch, config.epochs)
        return step_lr(lr, epoch, config.schedule)

    best_acc1, step, start_epoch = 0.0, 0, 0
    total = max_steps or config.epochs * steps_per_epoch
    mgr = checkpoint_manager(config.ckpt_dir) if config.ckpt_dir else None
    if mgr is not None and config.resume == "auto" and mgr.latest_step() is not None:
        saved = mgr.restore(mgr.latest_step())
        fc.load_state_dict(saved["fc"])
        optimizer.load_state_dict(saved["optimizer"])
        best_acc1 = float(saved["best_acc1"])
        # epoch-granular, as the reference: a mid-epoch save (a max_steps
        # break) resumes from the start of its epoch
        start_epoch = mgr.latest_step() // steps_per_epoch
        step = start_epoch * steps_per_epoch

    if config.evaluate:
        acc1, acc5 = validate(eval_step, val_set, config, dev)
        print(f"Evaluate: val Acc@1 {acc1:.2f} Acc@5 {acc5:.2f}", flush=True)
        return fc, acc1

    aug = train_aug_config(config.image_size)
    for epoch in range(start_epoch, config.epochs):
        losses = AverageMeter("Loss", ":.4e")
        top1 = AverageMeter("Acc@1", ":6.2f")
        progress = ProgressMeter(steps_per_epoch, [losses, top1], f"Epoch: [{epoch}]")
        gen = _epoch_generator(config.seed, epoch, dev)
        loader = epoch_loader(train_set, epoch, config.seed, config.batch_size, dev,
                              depth=config.prefetch_depth, workers=config.staging_workers)
        try:
            for i, (imgs, labels, extents) in enumerate(loader):
                images = augment_batch(imgs, gen, aug, extents)
                metrics = train_step(images, labels.long(), sched(step))
                step += 1
                if i % config.print_freq == 0:
                    host = dict(zip(metrics, torch.stack(list(metrics.values())).cpu().tolist()))
                    losses.update(host["loss"], config.batch_size)
                    top1.update(host["acc1"], config.batch_size)
                    progress.display(i)
                    if on_step is not None:
                        on_step(step, host)
                if step >= total:
                    break
        finally:
            loader.close_quietly()
        acc1, acc5 = validate(eval_step, val_set, config, dev)
        best_acc1 = max(best_acc1, acc1)
        print(f"Epoch [{epoch}] val Acc@1 {acc1:.2f} Acc@5 {acc5:.2f} (best {best_acc1:.2f})",
              flush=True)
        if mgr is not None:
            mgr.save(step, {"fc": cpu_copy(fc.state_dict()),
                            "optimizer": cpu_copy(optimizer.state_dict()),
                            "best_acc1": best_acc1})
        if step >= total:
            break
    # the reference's sanity check, against the file on disk
    sanity_check(model.state_dict(), load_pretrained_backbone(
        config.pretrained, num_heads=getattr(model, "num_heads", 12)))
    return fc, best_acc1


def _val_split(config: EvalConfig, train_set=None):
    """The validation set: `val/` for imagefolder, the test split for
    CIFAR-10, else a held-out draw of the same synthetic kind (the class
    patterns come from a fixed seed, so a different `seed` is a held-out
    split of the same classes)."""
    if config.dataset == "imagefolder":
        return build_dataset("imagefolder", os.path.join(config.data_dir, "val"),
                             image_size=config.image_size, stage_size=config.stage_size,
                             num_workers=config.num_workers)
    if config.dataset == "cifar10":
        return build_dataset("cifar10", config.data_dir, train=False)
    if config.dataset == "synthetic_texture":
        from moco_tpu_torch.data.datasets import SyntheticTextureDataset

        # the train split's label space, not config.num_classes
        train_nc = getattr(train_set, "num_classes", None)
        kw = {"num_classes": train_nc} if train_nc else {}
        return SyntheticTextureDataset(num_samples=512, image_size=config.image_size,
                                       seed=999, **kw)
    from moco_tpu_torch.data.datasets import SyntheticDataset

    return SyntheticDataset(num_samples=512, image_size=config.image_size, seed=999)


def main(argv=None):
    from moco_tpu_torch.config import add_config_flags, collect_overrides, get_preset, \
        preset_names

    set_precision_policy()
    parser = argparse.ArgumentParser(description="moco_tpu_torch linear probe")
    parser.add_argument("--preset", default="imagenet-lincls",
                        choices=preset_names(EvalConfig))
    parser.add_argument("--max-steps", type=int, default=None)
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    add_config_flags(parser, EvalConfig)
    args = parser.parse_args(argv)
    config = get_preset(args.preset).replace(**collect_overrides(args, EvalConfig))
    print(f"config: {config}", flush=True)
    _, best = train_lincls(config, max_steps=args.max_steps, device=args.device)
    print(f"best val Acc@1: {best:.2f}", flush=True)
    return best


if __name__ == "__main__":
    main()
