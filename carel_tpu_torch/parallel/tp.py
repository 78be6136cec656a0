"""Tensor-parallel layout of the encoder, the counterpart of
carel_tpu/parallel/tp.py: the Megatron split of its ``_spec_for``, keyed
here by the port's ``state_dict`` names.

- attention ``qkv`` weight ``[3 * hidden, hidden]``: split by heads. Its
  rows are (3, heads, head_dim), so tp rank r keeps heads
  ``[r * h / tp, (r + 1) * h / tp)`` of each of q, k and v, not a
  contiguous block of rows;
- attention ``out`` weight ``[hidden, hidden]``: split by heads (its input
  features); the partial products are summed over 'model', then the bias is
  added once;
- ``mlp_in`` weight and bias: split by columns (output features);
- ``mlp_out`` weight: split by rows (input features; summed over 'model',
  the bias added once);
- everything else, the qkv bias among it as in JAX, replicated. Each rank
  reads its heads' part of the qkv bias, and its gradient is summed over
  'model', as JAX's partitioner sums it.

``shard_params_tp`` splits the model in place and hands the encoder layers
the mesh; ``full_state_dict`` gathers the whole parameters back (for
checkpoints), ``shard_state_dict`` splits whole ones for this rank.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch
import torch.distributed as dist
from torch import nn

from carel_tpu_torch.parallel.mesh import Mesh
from carel_tpu_torch.parallel.sharding import shard_params

HEADS, COLUMNS, ROWS = "heads", "columns", "rows"


def _spec_for(name: str) -> Optional[str]:
    """How the parameter ``name`` is split over 'model': HEADS, COLUMNS,
    ROWS, or None (replicated)."""
    keys = name.split(".")
    leaf = keys[-1]
    if "attention" in keys and leaf == "weight" and keys[-2] in ("qkv",
                                                                 "out"):
        return HEADS
    if keys[-2:-1] == ["mlp_in"]:
        return COLUMNS
    if keys[-2:] == ["mlp_out", "weight"]:
        return ROWS
    return None


def _heads_view(t: torch.Tensor, kind_name: str, heads: int):
    """A head-split weight as [..., heads, head_dim, ...] with the head
    axis at dim 1: qkv [3, h, hd, D], out [D, h, hd]."""
    if kind_name == "qkv":
        return t.view(3, heads, -1, t.shape[-1])
    return t.view(t.shape[0], heads, -1)


def shard_tensor(name: str, full: torch.Tensor, rank: int, tp: int,
                 num_heads: int) -> torch.Tensor:
    """Tp rank ``rank``'s part of the whole parameter ``full``."""
    kind = _spec_for(name)
    if kind is None:
        return full
    if kind == HEADS:
        if num_heads % tp:
            raise ValueError(f"{num_heads} heads do not split over tp {tp}")
        per = num_heads // tp
        part = _heads_view(full, name.split(".")[-2], num_heads)[
            :, rank * per:(rank + 1) * per]
        return part.reshape(-1, full.shape[-1]) if part.dim() == 4 \
            else part.reshape(full.shape[0], -1)
    dim = 0 if kind == COLUMNS else 1
    if full.shape[dim] % tp:
        raise ValueError(f"{name}: {full.shape[dim]} does not split over "
                         f"tp {tp}")
    per = full.shape[dim] // tp
    return full.narrow(dim, rank * per, per)


def unshard_tensor(name: str, parts: List[torch.Tensor],
                   num_heads: int) -> torch.Tensor:
    """The whole parameter from the tp ranks' ``parts``, in rank order."""
    kind = _spec_for(name)
    if kind is None:
        return parts[0]
    if kind == HEADS:
        per = num_heads // len(parts)
        views = [_heads_view(p, name.split(".")[-2], per) for p in parts]
        whole = torch.cat(views, dim=1)
        return whole.reshape(-1, whole.shape[-1]) if whole.dim() == 4 \
            else whole.reshape(whole.shape[0], -1)
    return torch.cat(parts, dim=0 if kind == COLUMNS else 1)


def _num_heads(model: nn.Module) -> int:
    return model.encoder.cfg.num_heads


@torch.no_grad()
def shard_params_tp(mesh: Mesh, model: nn.Module) -> nn.Module:
    """Replicate ``model`` over the mesh (``shard_params``), then keep this
    rank's part of every split parameter of its encoder and hand the
    encoder's attention and layers the mesh, which then run on this rank's
    heads and MLP columns. The DeepSeek-V2 encoder has no such split and
    raises."""
    if model.encoder.cfg.arch == "deepseek_v2":
        raise NotImplementedError("tensor parallelism of the DeepSeek-V2 "
                                  "encoder: use a mesh with one 'model' rank")
    shard_params(mesh, model)
    heads = _num_heads(model)
    for name, p in model.named_parameters():
        if _spec_for(name) is not None:
            p.data = shard_tensor(name, p.data, mesh.tp_rank, mesh.tp,
                                  heads).clone()
    for layer in model.encoder.layers:
        layer.tp = mesh
        layer.attention.tp = mesh
    return model


@torch.no_grad()
def full_state_dict(model: nn.Module, mesh: Optional[Mesh]
                    ) -> Dict[str, torch.Tensor]:
    """``model.state_dict()`` with every split parameter gathered whole
    over 'model' (a collective: every tp rank calls it)."""
    state = model.state_dict()
    if mesh is None or mesh.tp == 1:
        return state
    heads = _num_heads(model)
    out = {}
    for name, t in state.items():
        if _spec_for(name) is None:
            out[name] = t
            continue
        parts = [torch.empty_like(t) for _ in range(mesh.tp)]
        dist.all_gather(parts, t.contiguous(), group=mesh.tp_group)
        out[name] = unshard_tensor(name, parts, heads)
    return out


def shard_state_dict(state: Dict[str, torch.Tensor], mesh: Optional[Mesh],
                     model: nn.Module) -> Dict[str, torch.Tensor]:
    """This rank's part of a whole ``state_dict`` (a checkpoint) of
    ``model``."""
    if mesh is None or mesh.tp == 1:
        return state
    heads = _num_heads(model)
    return {k: shard_tensor(k, v, mesh.tp_rank, mesh.tp, heads)
            for k, v in state.items()}


class _CopyToTp(torch.autograd.Function):
    """The identity; the backward sums the gradient over 'model'."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.mesh.tp_group)
        return g, None


class _ReduceFromTp(torch.autograd.Function):
    """The sum over 'model'; the backward is the identity."""

    @staticmethod
    def forward(ctx, x, mesh):
        x = x.contiguous().clone()
        dist.all_reduce(x, group=mesh.tp_group)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_tp(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    return _CopyToTp.apply(x, mesh)


def reduce_from_tp(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    return _ReduceFromTp.apply(x, mesh)
