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
"""

from __future__ import annotations

import os
from typing import Dict

import torch

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


def _device(state: TrainState) -> torch.device:
    return next(state.model.parameters()).device


def save_state(ckpt_dir: str, model_id: str, state: TrainState) -> str:
    """Full train-state snapshot (model, optimizers, step, generators)."""
    payload = {
        "model": state.model.state_dict(),
        **{name: getattr(state, name).state_dict() for name in _OPTIMIZERS},
        "step": state.step,
        "generator": state.generator.get_state(),
        "dropout_generator": dropout_generator(_device(state)).get_state(),
    }
    return _save(payload, state_path(ckpt_dir, model_id))


def load_state(ckpt_dir: str, model_id: str,
               state: TrainState) -> TrainState:
    """Restore a ``save_state`` snapshot into ``state`` and return it. The
    params are copied in place; the optimizers take the saved moments and
    step counts but keep their hyper-parameters (lr as this run sets it, as
    the JAX package's optax chain does), so their state tensors are new and
    a captured epoch step captures again (``scan_epoch.capture_key``)."""
    device = _device(state)
    payload = torch.load(state_path(ckpt_dir, model_id),
                         map_location=device, weights_only=True)
    state.model.load_state_dict(payload["model"])
    for name in _OPTIMIZERS:
        opt = getattr(state, name)
        saved = payload[name]
        groups = [{**g_saved, **{k: v for k, v in g.items() if k != "params"}}
                  for g_saved, g in zip(saved["param_groups"],
                                        opt.param_groups)]
        opt.load_state_dict({"state": saved["state"], "param_groups": groups})
    state.step = int(payload["step"])
    state.generator.set_state(payload["generator"].cpu())
    dropout_generator(device).set_state(payload["dropout_generator"].cpu())
    return state
