"""Sharding over a mesh's data axis, the counterpart of
carel_tpu/parallel/sharding.py.

JAX annotates shardings and lets XLA place the collectives; here each rank
holds its rows and the collectives are written out:

- a batch, or a stacked epoch ``[nb, B, ...]`` (the scan axis whole), is
  split over 'data': rank d takes rows ``[d * B / dp, (d + 1) * B / dp)``;
  a B that dp does not divide raises, as JAX's ``device_put`` does;
- parameters are replicated: rank 0's values are broadcast over the mesh,
  and every rank's own values must equal them;
- ``gather_rows`` is the all-gather over 'data' whose backward returns this
  rank's rows of the gradient: every rank then computes the same loss of
  the global batch from the gathered rows, so the gradient it hands back
  is this rank's share of the global one;
- ``all_reduce_grads`` sums over 'data' the gradients of the parameters
  that ran on this rank's rows only (before the gather).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Iterable, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from carel_tpu_torch.parallel.mesh import Mesh


@dataclass(frozen=True)
class Sharding:
    """Where an array lies on a mesh: ``spec`` names the mesh axis of each
    leading dimension (None: whole), as JAX's PartitionSpec."""

    mesh: Mesh
    spec: Tuple


def batch_sharding(mesh: Mesh) -> Sharding:
    return Sharding(mesh, ("data",))


def replicated_sharding(mesh: Mesh) -> Sharding:
    return Sharding(mesh, ())


def _rows(mesh: Mesh, n: int, what: str) -> slice:
    if n % mesh.dp:
        raise ValueError(f"{what} of {n} rows is not divisible by the "
                         f"mesh's data axis of {mesh.dp}")
    per = n // mesh.dp
    return slice(mesh.dp_rank * per, (mesh.dp_rank + 1) * per)


def shard_batch(mesh: Mesh, batch: Dict[str, Any]) -> Dict[str, Any]:
    """This rank's rows of every array (numpy or tensor) of ``batch``."""
    return {k: v[_rows(mesh, v.shape[0], k)] for k, v in batch.items()}


def shard_stacked(mesh: Mesh, stacked: Dict[str, np.ndarray]
                  ) -> Dict[str, np.ndarray]:
    """This rank's rows of a stacked epoch ``[nb, B, ...]``: the scan axis
    stays whole, the batch axis rides 'data'."""
    return {k: np.ascontiguousarray(v[:, _rows(mesh, v.shape[1], k)])
            for k, v in stacked.items()}


def _flat_groups(tensors: Iterable[torch.Tensor]):
    by_dtype: Dict[torch.dtype, list] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    return by_dtype.values()


@torch.no_grad()
def shard_params(mesh: Mesh, model: nn.Module) -> nn.Module:
    """Replicate ``model``'s parameters and buffers over the mesh: rank 0's
    values are broadcast, and each rank's own values must be bit-equal to
    them (the ranks start from one seed), else a ValueError."""
    tensors = [p.data for p in model.parameters()] + list(model.buffers())
    for group in _flat_groups(tensors):
        flat = torch.cat([t.reshape(-1) for t in group])
        mine = flat.clone()
        dist.broadcast(flat, src=0, group=mesh.group)
        if not torch.equal(flat, mine):
            raise ValueError(f"rank {mesh.rank}'s parameters differ from "
                             f"rank 0's: the ranks did not start from one "
                             f"seed")
    return model


def _all_gather(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    x = x.contiguous()
    if x.is_cuda:
        out = x.new_empty((mesh.dp * x.shape[0],) + tuple(x.shape[1:]))
        dist.all_gather_into_tensor(out, x, group=mesh.dp_group)
        return out
    parts = [torch.empty_like(x) for _ in range(mesh.dp)]
    dist.all_gather(parts, x, group=mesh.dp_group)
    return torch.cat(parts)


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh, ctx.rows = mesh, x.shape[0]
        return _all_gather(x, mesh)

    @staticmethod
    def backward(ctx, g):
        start = ctx.mesh.dp_rank * ctx.rows
        return g[start:start + ctx.rows], None


def gather_rows(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """``[b, ...]`` of every rank -> ``[dp * b, ...]`` in row order; the
    backward keeps this rank's rows of the gradient."""
    return _GatherRows.apply(x, mesh)


@torch.no_grad()
def gather_batch(mesh: Mesh, batch: Dict[str, torch.Tensor]
                 ) -> Dict[str, torch.Tensor]:
    """Every array of ``batch`` gathered over 'data' (no gradient)."""
    return {k: _all_gather(v, mesh) for k, v in batch.items()}


@torch.no_grad()
def all_reduce_grads(params: Iterable[torch.Tensor], mesh: Mesh) -> None:
    """Sum the gradients of ``params`` over 'data', in one collective a
    dtype (parameters without a gradient are skipped)."""
    grads = [p.grad for p in params if p.grad is not None]
    for group in _flat_groups(grads):
        flat = torch.cat([g.reshape(-1) for g in group])
        dist.all_reduce(flat, group=mesh.dp_group)
        offset = 0
        for g in group:
            n = g.numel()
            g.copy_(flat[offset:offset + n].view_as(g))
            offset += n
