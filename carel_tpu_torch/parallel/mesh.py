"""Device mesh over torch.distributed, the counterpart of
carel_tpu/parallel/mesh.py.

JAX's mesh is one controller over many devices. Here every device is one
process of a torch.distributed world (NCCL on the card, gloo on the CPU),
and a ``Mesh`` is that world arranged as JAX arranges its devices: with
axes ('data', 'model') and shape (dp, tp), rank ``d * tp + t`` sits at data
index d and model index t, as ``np.asarray(devices).reshape(shape)`` puts
device ``d * tp + t``. Each rank holds its coordinates and two process
groups: its ``dp_group`` (the ranks of its model index, over which the
batch is split) and its ``tp_group`` (the ranks of its data index, over
which the encoder's heads and MLP columns are split).
"""

from __future__ import annotations

import socket
from dataclasses import dataclass
from typing import Any, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist


def local_device_count(device="cuda") -> int:
    """The devices a mesh can take: the cards on a CUDA machine, one on the
    CPU (torch has one CPU device)."""
    if torch.device(device).type == "cuda":
        return torch.cuda.device_count()
    return 1


@dataclass(eq=False)
class Mesh:
    """One rank's view of a (dp, tp) mesh."""

    shape: Tuple[int, int]
    axes: Tuple[str, ...]
    rank: int
    dp_rank: int
    tp_rank: int
    dp_group: Any
    tp_group: Any
    group: Any  # every rank of the mesh

    @property
    def dp(self) -> int:
        return self.shape[0]

    @property
    def tp(self) -> int:
        return self.shape[1]

    @property
    def size(self) -> int:
        return self.dp * self.tp

    def key(self) -> tuple:
        """What a captured step holds fixed of the mesh."""
        return (self.shape, self.axes, self.rank)


def free_port() -> int:
    """A free TCP port on 127.0.0.1 for the rendezvous."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def init_distributed(rank: int, world: int, port: int, device) -> None:
    """Join a world of ``world`` ranks by TCP on 127.0.0.1:``port``: NCCL
    on a CUDA ``device`` (this rank on card ``rank``), gloo on the CPU."""
    device = torch.device(device)
    kw = {}
    if device.type == "cuda":
        torch.cuda.set_device(rank)
        kw["device_id"] = torch.device("cuda", rank)
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                            init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank, **kw)


def make_mesh(
    num_devices: int = 0,
    axes: Tuple[str, ...] = ("data", "model"),
    shape: Optional[Sequence[int]] = None,
) -> Optional[Mesh]:
    """The mesh over the first ``num_devices`` ranks of the world (0 = all).

    The default layout puts every device on 'data'; ``shape`` carves out
    model parallelism, e.g. (4, 2) on 8. A shape that does not cover the
    devices raises a ValueError, as in JAX. Every rank of the world must
    call this (it makes the process groups); a rank outside the mesh gets
    None."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a torch.distributed world: "
                           "init_distributed first")
    world = dist.get_world_size()
    n = num_devices or world
    if n > world:
        raise ValueError(f"{n} devices asked for, the world has {world}")
    if shape is None:
        shape = (n,) + (1,) * (len(axes) - 1)
    shape = tuple(int(s) for s in shape)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} does not match axes {axes}")
    if int(np.prod(shape)) != n:
        raise ValueError(f"mesh shape {shape} does not cover {n} devices")
    dp = shape[0]
    tp = shape[1] if len(shape) > 1 else 1
    rank = dist.get_rank()
    # every rank makes every group, in one order
    group = dist.new_group(list(range(n)))
    dp_groups = [dist.new_group([d * tp + t for d in range(dp)])
                 for t in range(tp)]
    tp_groups = [dist.new_group([d * tp + t for t in range(tp)])
                 for d in range(dp)]
    if rank >= n:
        return None
    d, t = divmod(rank, tp)
    return Mesh(shape=(dp, tp), axes=tuple(axes), rank=rank, dp_rank=d,
                tp_rank=t, dp_group=dp_groups[t], tp_group=tp_groups[d],
                group=group)
