"""Checkpoints, port of carel_tpu/train/checkpoint.py (which uses orbax):
``torch.save`` / ``torch.load`` files named by a model id like the
reference's uuid scheme.

- save_best / load_best: the model's ``state_dict``, "best pair-F1"
  semantics (the reference torch.saves a bare state_dict on every F1
  improvement, flagship :616-628, :874-895, and reloads it after training);
- save_state / load_state: the full train state for a deterministic resume
  (the failure-recovery story the reference lacks, SURVEY.md §5): the
  model's ``state_dict``, the three optimizers' ``state_dict``s, ``step``,
  and the states of the sampling generator and of the generator dropout
  draws from, the counterpart of JAX's params, three opt states, step and
  PRNG key.

Under a mesh the files hold whole parameters (and whole optimizer moments):
the split ones are gathered over 'model' (``parallel/tp.py``), rank 0
writes, and every rank waits for the file; a load splits them again for
its rank. So a checkpoint of a dp2 x tp2 run loads in a one-device run and
the other way round. Every rank holds the same generator states, so rank
0's are the run's.
"""

from __future__ import annotations

import os
from typing import Dict

import torch
import torch.distributed as dist

from carel_tpu_torch.parallel.tp import (full_state_dict, shard_state_dict,
                                         shard_tensor, unshard_tensor)
from carel_tpu_torch.train.state import TrainState, dropout_generator

_OPTIMIZERS = ("optimizer", "disc_optimizer", "club_optimizer")


def best_path(ckpt_dir: str, model_id: str) -> str:
    return os.path.abspath(os.path.join(ckpt_dir, f"{model_id}_best.pt"))


def state_path(ckpt_dir: str, model_id: str) -> str:
    return os.path.abspath(os.path.join(ckpt_dir, f"{model_id}_state.pt"))


def _save(obj, path: str) -> str:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = path + ".tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)
    return path


def save_best(ckpt_dir: str, model_id: str,
              state_dict: Dict[str, torch.Tensor]) -> str:
    return _save(state_dict, best_path(ckpt_dir, model_id))


def load_best(ckpt_dir: str, model_id: str,
              device: torch.device) -> Dict[str, torch.Tensor]:
    return torch.load(best_path(ckpt_dir, model_id), map_location=device,
                      weights_only=True)


def _writes(mesh) -> bool:
    return mesh is None or mesh.rank == 0


def _wait(mesh) -> None:
    if mesh is not None:
        dist.barrier(group=mesh.group)


def save_best_of(ckpt_dir: str, model_id: str, model, mesh=None) -> None:
    """``save_best`` of ``model``'s whole parameters (rank 0 of a mesh
    writes; every rank calls)."""
    state = full_state_dict(model, mesh)
    if _writes(mesh):
        save_best(ckpt_dir, model_id, state)
    _wait(mesh)


def load_best_into(ckpt_dir: str, model_id: str, model, mesh=None) -> None:
    """Load the best checkpoint into ``model``, split for this rank."""
    device = next(model.parameters()).device
    state = load_best(ckpt_dir, model_id, device)
    model.load_state_dict(shard_state_dict(state, mesh, model))


def _device(state: TrainState) -> torch.device:
    return next(state.model.parameters()).device


def _moments(state: TrainState, name: str, opt_state: dict, mesh,
             whole: bool) -> dict:
    """``opt_state`` (an optimizer's ``state_dict``) with the moments of
    split parameters gathered whole (``whole``) or split for this rank."""
    if mesh is None or mesh.tp == 1:
        return opt_state
    names = {id(p): n for n, p in state.model.named_parameters()}
    params = [p for g in getattr(state, name).param_groups
              for p in g["params"]]
    heads = state.model.encoder.cfg.num_heads
    out = {}
    for idx, entry in opt_state["state"].items():
        pname = names[id(params[idx])]
        new = {}
        for k, v in entry.items():
            if isinstance(v, torch.Tensor) and v.dim() > 0:
                if whole:
                    parts = [torch.empty_like(v) for _ in range(mesh.tp)]
                    dist.all_gather(parts, v.contiguous(),
                                    group=mesh.tp_group)
                    v = unshard_tensor(pname, parts, heads)
                else:
                    v = shard_tensor(pname, v, mesh.tp_rank, mesh.tp,
                                     heads).clone()
            new[k] = v
        out[idx] = new
    return {"state": out, "param_groups": opt_state["param_groups"]}


def save_state(ckpt_dir: str, model_id: str, state: TrainState,
               mesh=None) -> str:
    """Full train-state snapshot (model, optimizers, step, generators),
    whole under a mesh (every rank calls; rank 0 writes)."""
    payload = {
        "model": full_state_dict(state.model, mesh),
        **{name: _moments(state, name, getattr(state, name).state_dict(),
                          mesh, whole=True) for name in _OPTIMIZERS},
        "step": state.step,
        "generator": state.generator.get_state(),
        "dropout_generator": dropout_generator(_device(state)).get_state(),
    }
    path = state_path(ckpt_dir, model_id)
    if _writes(mesh):
        _save(payload, path)
    _wait(mesh)
    return path


def load_state(ckpt_dir: str, model_id: str,
               state: TrainState, mesh=None) -> TrainState:
    """Restore a ``save_state`` snapshot into ``state`` and return it. The
    params are copied in place; the optimizers take the saved moments and
    step counts but keep their hyper-parameters (lr as this run sets it, as
    the JAX package's optax chain does), so their state tensors are new and
    a captured epoch step captures again (``scan_epoch.capture_key``)."""
    device = _device(state)
    payload = torch.load(state_path(ckpt_dir, model_id),
                         map_location=device, weights_only=True)
    state.model.load_state_dict(shard_state_dict(payload["model"], mesh,
                                                 state.model))
    for name in _OPTIMIZERS:
        opt = getattr(state, name)
        saved = _moments(state, name, payload[name], mesh, whole=False)
        groups = [{**g_saved, **{k: v for k, v in g.items() if k != "params"}}
                  for g_saved, g in zip(saved["param_groups"],
                                        opt.param_groups)]
        opt.load_state_dict({"state": saved["state"], "param_groups": groups})
    state.step = int(payload["step"])
    state.generator.set_state(payload["generator"].cpu())
    dropout_generator(device).set_state(payload["dropout_generator"].cpu())
    return state
