"""ResNet and ViT encoders of the port, and the MoCo-v3 heads."""

from moco_tpu_torch.models.resnet import ARCHS, build_resnet
from moco_tpu_torch.models.vit import VIT_ARCHS, build_vit


def build_backbone(arch: str, *, cifar_stem: bool = False, num_classes=None,
                   image_size: int = 224):
    """Feature-mode encoder for the consumers that do not train it (the
    linear probe, the kNN eval): f32, and with `num_classes=None` the
    backbone features (`feature_dim` wide): a ResNet's pooled features or a
    ViT's class token."""
    if arch in VIT_ARCHS:
        return build_vit(arch, num_classes=num_classes, image_size=image_size)
    if arch not in ARCHS:
        raise ValueError(f"arch {arch!r} is not ported; choose from "
                         f"{sorted(ARCHS) + sorted(VIT_ARCHS)}")
    return build_resnet(arch, num_classes=num_classes, cifar_stem=cifar_stem)
