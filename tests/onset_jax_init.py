"""The JAX driver's initial state for the onset pair tool's `jax_init`
variant (`tests/onset_cpu_pair.py`, `port+jax_init`), built on the CPU.

For each seed: the state `moco_tpu.train.train` starts from with the
horizon tool's config (`tools/_horizon_run.py`: the CIFAR stem, 32 px,
K=4096, embed 128, bf16) at the rung's arch and batch (R4, the horizon's
resnet18 at B=256, by default), made with the driver's own init key, model
and input shape, carried over to the port's names by
`moco_tpu_torch/weights.py::params_from_jax` and written with the queue to
`<out>/jax_init_seed<S>.npz` (about 47 MB each at resnet18).

    python tests/onset_jax_init.py --rung R4 --seeds 0,1,2 --out runs/_onset_init
"""

from __future__ import annotations

import argparse
import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import jax  # noqa: E402
import numpy as np  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import onset_cpu_pair as pair  # noqa: E402
from moco_tpu.config import get_preset  # noqa: E402
from moco_tpu.train_state import create_train_state  # noqa: E402
from moco_tpu.train_step import build_encoder, build_optimizer  # noqa: E402
from moco_tpu_torch.weights import params_from_jax  # noqa: E402


def horizon_config(seed: int, batch: int = 256, image_size: int = 32, arch: str = "resnet18"):
    """The tool's config at its card defaults (400 epochs of 64 steps)."""
    return get_preset("cifar10-moco-v1").replace(
        arch=arch, cifar_stem=True, dataset="synthetic_texture", image_size=image_size,
        batch_size=batch, num_negatives=4096, embed_dim=128, lr=0.03, momentum_ema=0.99,
        cos=True, epochs=400, steps_per_epoch=None, knn_monitor=True, knn_every_epochs=1,
        knn_bank_size=2048, num_classes=16, num_workers=1, compute_dtype="bfloat16",
        seed=seed)


def initial_state(seed: int, **kw) -> tuple[dict, np.ndarray]:
    """(the port's state dict as numpy, the queue) of the JAX driver's
    initial state for `seed`."""
    cfg = horizon_config(seed, **kw)
    state = create_train_state(
        jax.random.key(cfg.seed), build_encoder(cfg), build_optimizer(cfg, 64)[0],
        (cfg.batch_size, cfg.image_size, cfg.image_size, 3), cfg.num_negatives, cfg.embed_dim)
    sd = params_from_jax(jax.tree.map(np.asarray, state.params_q),
                         jax.tree.map(np.asarray, state.batch_stats_q))
    return {k: v.numpy() for k, v in sd.items()}, np.asarray(state.queue, np.float32)


def main(argv=None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--seeds", default="0,1,2")
    p.add_argument("--out", default="runs/_onset_init")
    p.add_argument("--rung", choices=sorted(pair.RUNGS), default="R4")
    args = p.parse_args(argv)
    rung = pair.RUNGS[args.rung]
    os.makedirs(args.out, exist_ok=True)
    for seed in [int(s) for s in args.seeds.split(",")]:
        sd, queue = initial_state(seed, batch=rung.batch, arch=rung.arch)
        path = os.path.join(args.out, f"jax_init_seed{seed}.npz")
        np.savez(path, queue=queue, **{f"sd/{k}": v for k, v in sd.items()})
        print(path, len(sd), os.path.getsize(path), flush=True)


if __name__ == "__main__":
    main()
