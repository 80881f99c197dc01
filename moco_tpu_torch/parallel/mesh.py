"""Process topology of the data-parallel pretrain (port of
`moco_tpu/parallel/mesh.py`'s `distributed_init`, `local_batch_size`).

The JAX package runs one controller per host over a device mesh. The port
takes PyTorch's idiom, the reference's `mp.spawn`: one process per card,
joined in a `torch.distributed` process group. The world size takes the
place of the mesh size, and each process's BatchNorm over its local batch
takes the place of per-device BN.

- `init_distributed` joins the group: NCCL for `cuda`, gloo for `cpu`, the
  rendezvous `env://` (torchrun's `MASTER_ADDR`/`MASTER_PORT`) or any
  `init_method` such as `file://<path>` (a `FileStore`). Nothing needs a
  network beyond localhost.
- A world size of 1 with no `init_method` creates no group: the plain
  one-process path.
"""

from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist

from moco_tpu_torch.utils.device import resolve_device


def process_group():
    """The default group when this process joined one, else None."""
    if dist.is_available() and dist.is_initialized():
        return dist.group.WORLD
    return None


def world_size(group) -> int:
    """Processes in `group`; 1 for None (one process)."""
    return 1 if group is None else dist.get_world_size(group)


def rank(group) -> int:
    """This process's rank in `group`; 0 for None (one process)."""
    return 0 if group is None else dist.get_rank(group)


def local_batch_size(global_batch: int, world: int) -> int:
    """Per-process batch (the reference's `batch_size / ngpus_per_node`).
    The global batch must divide: the queue's ring update needs
    `K % global_batch == 0`, and every process holds an equal slice."""
    if global_batch % world:
        raise ValueError(f"global batch {global_batch} not divisible by world size {world}")
    return global_batch // world


def topology(device: str | torch.device = "cuda", *, rank: int | None = None,
             world_size: int | None = None,
             local_rank: int | None = None) -> tuple[torch.device, int, int]:
    """This process's device, rank and world size, from the arguments or
    torchrun's `RANK`, `WORLD_SIZE` and `LOCAL_RANK` (`local_rank` then
    defaults to `rank`): `cuda:LOCAL_RANK` on the card, else the CPU.
    Raises RuntimeError or ValueError for what the host can never satisfy
    (CUDA asked for and absent, a `LOCAL_RANK` with no card, a rank outside
    the world); nothing here touches a process group."""
    env = os.environ
    world = world_size if world_size is not None else int(env.get("WORLD_SIZE", "1"))
    dev = resolve_device(device)
    if rank is not None:
        r = rank
    elif "RANK" in env:
        r = int(env["RANK"])
    elif world == 1:
        r = 0
    else:
        raise ValueError(f"a world of {world} processes but RANK is not set")
    local = local_rank if local_rank is not None else int(env.get("LOCAL_RANK", r))
    if not 0 <= r < world:
        raise ValueError(f"rank {r} outside a world of {world}")
    if dev.type == "cuda":
        cards = torch.cuda.device_count()
        if not 0 <= local < cards:
            raise ValueError(f"LOCAL_RANK {local} names no card: this host has {cards}")
        dev = torch.device("cuda", local)
    return dev, r, world


def init_distributed(device: str | torch.device = "cuda", *, rank: int | None = None,
                     world_size: int | None = None, local_rank: int | None = None,
                     init_method: str | None = None,
                     timeout_s: float = 600.0) -> torch.device:
    """Join the data-parallel process group and return this process's
    device: `cuda:LOCAL_RANK` (made current) or the CPU (`topology` names
    it and raises for a host that cannot satisfy it).

    `init_method` defaults to `env://`. With a world size of 1 and no
    `init_method` no group is made and the device is returned as
    `resolve_device` gives it."""
    env = os.environ
    world = world_size if world_size is not None else int(env.get("WORLD_SIZE", "1"))
    if world == 1 and init_method is None:
        return resolve_device(device)
    if dist.is_initialized():
        raise RuntimeError("this process already joined a process group")
    dev, r, world = topology(device, rank=rank, world_size=world, local_rank=local_rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            init_method=init_method or "env://", rank=r, world_size=world,
                            timeout=datetime.timedelta(seconds=timeout_s))
    return dev


def shutdown_distributed() -> None:
    """Leave the process group, if this process joined one."""
    if process_group() is not None:
        dist.destroy_process_group()
