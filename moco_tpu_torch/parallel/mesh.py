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


def init_distributed(device: str | torch.device = "cuda", *, rank: int | None = None,
                     world_size: int | None = None, local_rank: int | None = None,
                     init_method: str | None = None,
                     timeout_s: float = 600.0) -> torch.device:
    """Join the data-parallel process group and return this process's
    device: `cuda:LOCAL_RANK` (made current) or the CPU.

    `rank`/`world_size`/`local_rank` default to torchrun's `RANK`,
    `WORLD_SIZE` and `LOCAL_RANK` (`local_rank` then to `rank`);
    `init_method` to `env://`. With a world size of 1 and no `init_method`
    no group is made and the device is returned as `resolve_device` gives
    it."""
    env = os.environ
    world = world_size if world_size is not None else int(env.get("WORLD_SIZE", "1"))
    dev = resolve_device(device)
    if world == 1 and init_method is None:
        return dev
    if dist.is_initialized():
        raise RuntimeError("this process already joined a process group")
    r = rank if rank is not None else int(env["RANK"])
    local = local_rank if local_rank is not None else int(env.get("LOCAL_RANK", r))
    if not 0 <= r < world:
        raise ValueError(f"rank {r} outside a world of {world}")
    if dev.type == "cuda":
        dev = torch.device("cuda", local)
        torch.cuda.set_device(dev)
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            init_method=init_method or "env://", rank=r, world_size=world,
                            timeout=datetime.timedelta(seconds=timeout_s))
    return dev


def shutdown_distributed() -> None:
    """Leave the process group, if this process joined one."""
    if process_group() is not None:
        dist.destroy_process_group()
