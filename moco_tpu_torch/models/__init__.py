"""ResNet encoders with the port's train-mode BatchNorm."""

from moco_tpu_torch.models.resnet import ARCHS, build_resnet


def build_backbone(arch: str, *, cifar_stem: bool = False, num_classes=None):
    """Feature-mode encoder for the consumers that do not train it (the
    linear probe, the kNN eval): f32, and with `num_classes=None` the
    pooled backbone features. ResNet archs only; the ViT goes with the v3
    path."""
    if arch not in ARCHS:
        raise ValueError(f"arch {arch!r} is not ported; choose from {sorted(ARCHS)}")
    return build_resnet(arch, num_classes=num_classes, cifar_stem=cifar_stem)
