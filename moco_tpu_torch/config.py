"""Pretraining config of the port: the fields the v1/v2 step and its input
pipeline read, the presets, and the flag surface of `train.py`.

The port's own copy of the relevant part of `moco_tpu/config.py`
(`PretrainConfig`, the `imagenet-moco-v1`, `imagenet-moco-v2` and
`cifar10-moco-v1` presets, `effective_lr`); field names, defaults and
validation are the same.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

VARIANTS = ("v1", "v2")
DATASETS = ("synthetic", "synthetic_texture", "cifar10", "imagefolder")


@dataclass
class PretrainConfig:
    # experiment
    name: str = "moco"
    variant: str = "v2"               # "v1" | "v2"
    seed: int = 0
    # model (reference flags -a/--arch, --moco-dim/k/m/t, --mlp)
    arch: str = "resnet50"
    embed_dim: int = 128              # --moco-dim
    num_negatives: int = 65536        # --moco-k
    momentum_ema: float = 0.999       # --moco-m
    temperature: float = 0.07         # --moco-t (v2 runs use 0.2)
    mlp_head: bool = False            # --mlp
    cifar_stem: bool = False
    compute_dtype: str = "float32"    # "bfloat16" for the ImageNet presets
    fused_bn_conv: bool = False       # blocks' bn->relu->conv through the fused kernels
    # data
    dataset: str = "synthetic"        # synthetic | synthetic_texture | cifar10 | imagefolder
    data_dir: str = ""
    image_size: int = 224
    aug_plus: bool = False            # --aug-plus (v2 augmentation stack)
    num_workers: int = 0              # ImageFolder decode threads (-j); 0 = its default (8)
    stage_size: int = 0               # ImageFolder canvas shorter side; 0 = its default (512)
    # input pipeline (data/loader.py)
    prefetch_depth: int = 2           # device batches staged ahead of the consumer
    staging_workers: int = 4          # staging threads, each decoding a sub-slice of a batch
    input_cache_mb: int = 0           # decode-once canvas cache budget in MiB (0 = off)
    h2d_trim: bool = False            # copy only the canvas prefix the extents cover
    decode_abort_rate: float = 0.5    # DataQualityError past this decode-failure rate (0 = never)
    # optimization (reference: SGD momentum .9, wd 1e-4, lr .03, batch 256)
    lr: float = 0.03                  # absolute lr; 0.0 = derive from base_lr
    base_lr: float = 0.0              # lr per 256 samples
    batch_size: int = 256
    epochs: int = 200
    warmup_epochs: int = 0
    schedule: tuple[int, ...] = (120, 160)  # step-lr milestones (epochs)
    cos: bool = False                 # --cos
    sgd_momentum: float = 0.9
    weight_decay: float = 1e-4
    print_freq: int = 10              # -p: metrics reach the host on these steps only
    steps_per_epoch: int | None = None  # derived from the dataset unless set

    def __post_init__(self):
        if self.variant not in VARIANTS:
            raise ValueError(f"variant {self.variant!r} is not ported; choose from {VARIANTS}")
        if self.dataset not in DATASETS:
            raise ValueError(f"dataset {self.dataset!r} is not ported; choose from {DATASETS}")
        if self.compute_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"unknown compute_dtype {self.compute_dtype!r}")
        # a bad depth or worker count fails where it was written, not as a
        # wedged queue half an epoch into a run
        if self.prefetch_depth < 1:
            raise ValueError(f"prefetch_depth must be >= 1, got {self.prefetch_depth}")
        if self.staging_workers < 1:
            raise ValueError(f"staging_workers must be >= 1, got {self.staging_workers}")
        if self.input_cache_mb < 0:
            raise ValueError(f"input_cache_mb must be >= 0, got {self.input_cache_mb}")
        if self.print_freq < 1:
            raise ValueError(f"print_freq must be >= 1, got {self.print_freq}")

    def replace(self, **kw) -> "PretrainConfig":
        return dataclasses.replace(self, **kw)

    @property
    def effective_lr(self) -> float:
        """`lr` if set, else `base_lr * batch / 256`."""
        if self.lr:
            return self.lr
        if not self.base_lr:
            raise ValueError("config needs lr or base_lr (both are 0)")
        return self.base_lr * self.batch_size / 256


PRESETS: dict[str, PretrainConfig] = {
    # MoCo-v1 ResNet-18 CIFAR-10, K=4096
    "cifar10-moco-v1": PretrainConfig(
        name="cifar10-moco-v1",
        variant="v1",
        arch="resnet18",
        num_negatives=4096,
        temperature=0.07,
        cifar_stem=True,
        dataset="cifar10",
        image_size=32,
        batch_size=256,
        epochs=200,
        cos=False,
    ),
    # MoCo-v1 ResNet-50 ImageNet-1k, the reference's default run (no MLP,
    # no aug+, no cosine; T=0.07, milestones 120/160)
    "imagenet-moco-v1": PretrainConfig(
        name="imagenet-moco-v1",
        variant="v1",
        arch="resnet50",
        dataset="imagefolder",
        compute_dtype="bfloat16",
    ),
    # MoCo-v2 ResNet-50, K=65536, MLP head, cosine LR, aug+ (ImageNet recipe)
    "imagenet-moco-v2": PretrainConfig(
        name="imagenet-moco-v2",
        variant="v2",
        arch="resnet50",
        num_negatives=65536,
        temperature=0.2,
        mlp_head=True,
        aug_plus=True,
        cos=True,
        dataset="imagefolder",
        compute_dtype="bfloat16",
    ),
}


def get_preset(name: str) -> PretrainConfig:
    if name not in PRESETS:
        raise ValueError(f"unknown preset {name!r}; choose from {sorted(PRESETS)}")
    return PRESETS[name]


def add_config_flags(parser) -> None:
    """Every field as a `--flag` (None = keep the preset's value)."""
    for f in dataclasses.fields(PretrainConfig):
        name = "--" + f.name.replace("_", "-")
        if isinstance(f.default, bool):
            parser.add_argument(name, type=lambda s: s.lower() in ("1", "true", "yes"),
                                default=None)
        elif isinstance(f.default, tuple):
            parser.add_argument(name, type=int, nargs="*", default=None)
        elif f.default is None:
            parser.add_argument(name, type=int, default=None)
        else:
            parser.add_argument(name, type=type(f.default), default=None)


def collect_overrides(args) -> dict:
    """Parsed flags that were given -> `replace()` keyword arguments."""
    out = {}
    for f in dataclasses.fields(PretrainConfig):
        value = getattr(args, f.name, None)
        if value is not None:
            out[f.name] = tuple(value) if isinstance(f.default, tuple) else value
    return out
