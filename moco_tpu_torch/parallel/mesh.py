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

The 2-D layout of `sharding="fsdp"|"fsdp_tp"` (the JAX package's
`create_mesh_2d`, `default_fsdp_size`, `mesh_for_config`): the world's n
ranks form M data replicas of K ranks each (M * K = n). Rank r sits at
`(r // K, r % K)`, the order in which `create_mesh_2d` reshapes the flat
device list, so a `(1, n)` layout reduces over the same ranks in the same
order as the 1-D group. `layout_for_config` gives `(M, K)` and raises the
JAX package's errors; `build_layout` makes the subgroups of a process
group: the fsdp group (K consecutive ranks, over which parameters are
split and gathered) and the data group (ranks `f, f + K, ...`, the
replicas of one shard).
"""

from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist

from moco_tpu_torch.utils.device import resolve_device

SHARDING_MODES = ("dp", "fsdp", "fsdp_tp")


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


def default_fsdp_size(sharding: str, n_devices: int) -> int:
    """The fsdp group's size a `sharding_axis_size=0` config resolves to:
    every rank for fsdp; for fsdp_tp the largest proper divisor (4 ranks ->
    data 2 x fsdp 2, 8 -> 2 x 4), a placeholder for the real intra-node
    group size that `sharding_axis_size` pins."""
    if sharding == "fsdp":
        return n_devices
    for d in range(n_devices // 2, 0, -1):
        if n_devices % d == 0:
            return d
    return 1


def layout_for_config(config, world: int) -> tuple[int, int]:
    """`(data, fsdp)`: the replicas and the ranks a parameter is split over
    that `config.sharding` asks of `world` ranks; dp is `(world, 1)`.
    Raises ValueError, with the JAX package's messages, for an fsdp request
    of a sub-group and for a group size that does not divide `world`."""
    mode = config.sharding
    if mode == "dp":
        return world, 1
    fsdp_size = int(config.sharding_axis_size) or default_fsdp_size(mode, world)
    if mode == "fsdp" and fsdp_size != world:
        raise ValueError(
            f"sharding='fsdp' shards over ALL {world} devices; "
            f"sharding_axis_size={fsdp_size} asks for a sub-group — that "
            "is the fsdp_tp hybrid, say so explicitly")
    if fsdp_size < 1 or world % fsdp_size != 0:
        raise ValueError(f"fsdp axis size {fsdp_size} must divide the device count {world}")
    return world // fsdp_size, fsdp_size


class Layout:
    """The 2-D layout of one process group: `data` replicas of `fsdp`
    ranks. `fsdp_group` and `data_group` are this rank's subgroups (None
    where one has a single rank, `group` itself where it spans it);
    `fsdp_rank` is this rank's index in its fsdp group."""

    def __init__(self, data: int, fsdp: int, fsdp_group, data_group, fsdp_rank: int):
        self.data, self.fsdp = data, fsdp
        self.fsdp_group, self.data_group, self.fsdp_rank = fsdp_group, data_group, fsdp_rank


def build_layout(config, group) -> Layout | None:
    """The layout of `config.sharding` over `group`, its subgroups made
    (None for dp, or with no group: the one-process step). Every rank
    creates every subgroup, in the same order (`dist.new_group` is a
    collective of the whole world), on gloo and on NCCL."""
    if config.sharding == "dp" or group is None:
        return None
    n, r = world_size(group), rank(group)
    data, fsdp = layout_for_config(config, n)

    def subgroups(members: list[list[int]], size: int):
        mine = None
        for ranks in members:
            g = group if size == n else dist.new_group(ranks) if size > 1 else None
            if r in ranks:
                mine = g
        return mine

    fsdp_group = subgroups([list(range(d * fsdp, (d + 1) * fsdp)) for d in range(data)], fsdp)
    data_group = subgroups([list(range(f, n, fsdp)) for f in range(fsdp)], data)
    return Layout(data, fsdp, fsdp_group, data_group, r % fsdp)
