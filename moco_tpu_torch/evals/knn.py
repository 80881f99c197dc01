"""kNN evaluation on frozen features (port of `moco_tpu/evals/knn.py`; the
InstDisc protocol: top-200 cosine neighbours, votes weighted exp(sim/0.07)).

    python -m moco_tpu_torch.evals.knn --pretrained encoder.npz --data-dir DIR \\
        [--dataset imagefolder] [--device cpu]

Encodes the whole train set with the frozen backbone (eval-mode BN, the
center-crop eval transform, f32) into an L2-normalized bank on the device,
then scores every val image against it (`ops/knn.py`). No trainable
parameters.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from moco_tpu_torch.config import EvalConfig
from moco_tpu_torch.data.augment import augment_batch, default_eval_crop_frac, \
    eval_aug_config
from moco_tpu_torch.data.datasets import build_dataset
from moco_tpu_torch.data.loader import stage_eval_batch
from moco_tpu_torch.evals.lincls import _val_split, load_frozen_backbone
from moco_tpu_torch.ops.knn import knn_accuracy
from moco_tpu_torch.ops.losses import l2_normalize
from moco_tpu_torch.utils.device import resolve_device, set_precision_policy


def build_feature_fn(model):
    """`images -> L2-normalized features` of `model` in eval mode, without
    autograd; a model in train mode is switched back after each call (the
    pretrain loop's kNN monitor passes its training encoder)."""

    def feature_fn(images: torch.Tensor) -> torch.Tensor:
        was_training = model.training
        model.eval()
        try:
            with torch.no_grad():
                return l2_normalize(model(images).float())
        finally:
            model.train(was_training)

    return feature_fn


def encode_dataset(model, dataset, config, batch: int = 256,
                   indices: np.ndarray | None = None, feature_fn=None):
    """L2-normalized frozen-encoder features [N, D] and labels [N] (int64)
    of `dataset` (or the `indices` subset) on the model's device, through
    the center-crop eval transform; the ragged last batch is padded to
    `batch` rows and its padding dropped. `feature_fn` defaults to
    `build_feature_fn(model)`."""
    device = next(model.parameters()).device
    cfg = eval_aug_config(config.image_size,
                          crop_frac=default_eval_crop_frac(config.image_size))
    if feature_fn is None:
        feature_fn = build_feature_fn(model)
    if indices is None:
        indices = np.arange(len(dataset))
    feats, labels = [], []
    for start in range(0, len(indices), batch):
        idx = indices[start:start + batch]
        imgs, lbls, extents = stage_eval_batch(dataset.get_batch(idx), batch, device)
        images = augment_batch(imgs, None, cfg, extents)
        feats.append(feature_fn(images)[:len(idx)])
        labels.append(lbls)
    return torch.cat(feats), torch.cat(labels)


def run_knn(config: EvalConfig, device="cuda") -> float:
    """kNN top-1 of the frozen backbone `config.pretrained`: the train split
    as the bank, the val split as the queries."""
    set_precision_policy()
    dev = resolve_device(device)
    model = load_frozen_backbone(config, dev)
    train_set = build_dataset(config.dataset, config.data_dir, image_size=config.image_size,
                              stage_size=config.stage_size, num_workers=config.num_workers)
    val_set = _val_split(config, train_set)
    bank, bank_labels = encode_dataset(model, train_set, config)
    queries, qlabels = encode_dataset(model, val_set, config)
    acc = knn_accuracy(queries, qlabels, bank, bank_labels, num_classes=config.num_classes,
                       k=config.knn_k, temperature=config.knn_temperature,
                       bank_chunk=config.knn_bank_chunk or None)
    print(f"kNN top-1: {100 * acc:.2f}% (k={config.knn_k}, T={config.knn_temperature})",
          flush=True)
    return acc


def main(argv=None) -> float:
    from moco_tpu_torch.config import add_config_flags, collect_overrides, get_preset, \
        preset_names

    set_precision_policy()
    parser = argparse.ArgumentParser(description="moco_tpu_torch kNN evaluation")
    parser.add_argument("--preset", default="imagenet-lincls",
                        choices=preset_names(EvalConfig))
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    add_config_flags(parser, EvalConfig)
    args = parser.parse_args(argv)
    config = get_preset(args.preset).replace(**collect_overrides(args, EvalConfig))
    return run_knn(config, device=args.device)


if __name__ == "__main__":
    main()
