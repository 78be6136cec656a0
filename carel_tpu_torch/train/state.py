"""Train state: the model plus the reference's optimizer groups, port of
carel_tpu/train/state.py.

Groups, by module path (``param_labels``): ``disc`` (ec_disc/ce_disc),
``club``, ``frozen`` (the four latent projections) and ``main`` (the rest).
The main group trains with Adam(vae_lr, betas (0.9, 0.999), eps 1e-8 outside
the sqrt), which is optax.adam's update.

Parity quirk: the reference's main optimizer NEVER includes the four latent
projection layers (emotion/cause mu/log_var are absent from get_params,
flagship :284-297), so they stay at their random init for the whole run.
With compat_frozen_latent_heads (default) they get ``requires_grad_(False)``;
gradient still flows through them to the encoder. The disc and club groups
exist and are not updated: that is what the none/mmd steps do in JAX.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import torch
from torch import nn

from carel_tpu_torch.config import CarelConfig

MAIN, DISC, CLUB, FROZEN = "main", "disc", "club", "frozen"

LATENT_HEADS = ("emotion_mu", "emotion_log_var", "cause_mu", "cause_log_var")


def param_labels(model: nn.Module,
                 compat_frozen_latent_heads: bool = True) -> Dict[str, str]:
    """Optimizer group of every parameter, by its module path."""

    def label_for(name: str) -> str:
        keys = name.split(".")
        if "ec_disc" in keys or "ce_disc" in keys:
            return DISC
        if "club" in keys:
            return CLUB
        if compat_frozen_latent_heads and any(k in LATENT_HEADS for k in keys):
            return FROZEN
        return MAIN

    return {name: label_for(name) for name, _ in model.named_parameters()}


@dataclass
class TrainState:
    """The model, its main-group optimizer, the sampling-noise generator and
    the count of optimizer steps."""

    model: nn.Module
    optimizer: torch.optim.Optimizer
    generator: torch.Generator
    labels: Dict[str, str]
    step: int = 0


def create_train_state(cfg: CarelConfig, model: nn.Module,
                       generator: torch.Generator,
                       compat_frozen_latent_heads: bool = True) -> TrainState:
    labels = param_labels(model, compat_frozen_latent_heads)
    main = []
    for name, p in model.named_parameters():
        if labels[name] == FROZEN:
            p.requires_grad_(False)
        elif labels[name] == MAIN:
            main.append(p)
    optimizer = torch.optim.Adam(main, lr=cfg.train.vae_lr,
                                 betas=(0.9, 0.999), eps=1e-8)
    return TrainState(model=model, optimizer=optimizer, generator=generator,
                      labels=labels)
