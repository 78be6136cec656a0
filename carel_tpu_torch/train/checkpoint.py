"""Best-by-F1 checkpoints: ``torch.save`` / ``torch.load`` of the model's
``state_dict`` (the JAX package uses orbax). The reference torch.saves a bare
state_dict on every F1 improvement (flagship :616-628, :874-895) and reloads
it after training; files are named by a model id like the reference's uuid
scheme."""

from __future__ import annotations

import os
from typing import Dict

import torch


def best_path(ckpt_dir: str, model_id: str) -> str:
    return os.path.abspath(os.path.join(ckpt_dir, f"{model_id}_best.pt"))


def save_best(ckpt_dir: str, model_id: str,
              state_dict: Dict[str, torch.Tensor]) -> str:
    path = best_path(ckpt_dir, model_id)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = path + ".tmp"
    torch.save(state_dict, tmp)
    os.replace(tmp, path)
    return path


def load_best(ckpt_dir: str, model_id: str,
              device: torch.device) -> Dict[str, torch.Tensor]:
    return torch.load(best_path(ckpt_dir, model_id), map_location=device,
                      weights_only=True)
