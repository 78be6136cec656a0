"""Train state: the model plus the reference's optimizer groups, port of
carel_tpu/train/state.py.

Groups, by module path (``param_labels``): ``disc`` (ec_disc/ce_disc),
``club``, ``frozen`` (the four latent projections) and ``main`` (the rest).
Each updated group has its own optimizer, as in the reference (SURVEY.md
§2.2; ec_gan :906-909, vi_final :878-879):

- main: Adam(vae_lr, betas (0.9, 0.999), eps 1e-8 outside the sqrt), which
  is optax.adam's update;
- disc: RMSprop(adv_lr, decay 0.99, eps 1e-8 INSIDE the sqrt), which is
  optax.rmsprop's default (``DiscRMSprop``; torch.optim.RMSprop puts eps
  outside the sqrt and is another optimizer);
- club: Adam(aprx_lr, betas (0.9, 0.999), eps 1e-8).

The gan step updates main and disc, the vi step club then main; the none,
mmd and hsic steps update main only, as in JAX.

On CUDA the two Adams are built fused and with ``capturable=True`` and hold
their lr as a 0-d device tensor, so that a step captured in a CUDA graph
(train/scan_epoch.py) reads the lr that ``set_lr`` writes in place; on the
CPU, where capturable Adam does not run, they take a float lr. The eager
step uses the same optimizers, so eager and captured steps run the same
update.

Parity quirk: the reference's main optimizer NEVER includes the four latent
projection layers (emotion/cause mu/log_var are absent from get_params,
flagship :284-297), so they stay at their random init for the whole run.
With compat_frozen_latent_heads (default) they get ``requires_grad_(False)``;
gradient still flows through them to the encoder.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List

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


class DiscRMSprop(torch.optim.Optimizer):
    """optax.rmsprop(lr, decay, eps) with its defaults (eps_in_sqrt=True,
    initial scale 0, no momentum, not centered):
    nu = decay * nu + (1 - decay) * g^2;  p -= lr * g / sqrt(nu + eps).
    The state of a parameter is ``nu``. The update is ``torch._foreach_*``
    on device tensors with no value read back, so it captures in a CUDA
    graph as it is (its float lr is then a constant of the graph)."""

    def __init__(self, params, lr: float, decay: float = 0.99,
                 eps: float = 1e-8):
        super().__init__(params, dict(lr=lr, decay=decay, eps=eps))

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("DiscRMSprop.step takes no closure")
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            grads = [p.grad for p in params]
            nus: List[torch.Tensor] = []
            for p in params:
                state = self.state[p]
                if not state:
                    state["nu"] = torch.zeros_like(p)
                nus.append(state["nu"])
            torch._foreach_mul_(nus, group["decay"])
            torch._foreach_addcmul_(nus, grads, grads, 1.0 - group["decay"])
            scale = torch._foreach_add(nus, group["eps"])
            torch._foreach_rsqrt_(scale)
            torch._foreach_mul_(scale, grads)
            torch._foreach_add_(params, scale, alpha=-group["lr"])


def set_lr(optimizer: torch.optim.Optimizer, lr: float) -> None:
    """Set the lr of every group: a 0-d tensor lr is written in place, so a
    captured step replays with the new value; a float lr is replaced (the
    epoch step then sees a changed hyper-parameter and captures again)."""
    for group in optimizer.param_groups:
        if isinstance(group["lr"], torch.Tensor):
            group["lr"].fill_(lr)
        else:
            group["lr"] = lr


def dropout_generator(device: torch.device) -> torch.Generator:
    """The generator dropout draws from on ``device``: the default one."""
    if device.type == "cuda":
        index = device.index
        if index is None:
            index = torch.cuda.current_device()
        return torch.cuda.default_generators[index]
    return torch.default_generator


@dataclass
class TrainState:
    """The model, its three optimizers (main Adam, disc RMSprop, club
    Adam), the sampling-noise generator and the count of main-optimizer
    steps."""

    model: nn.Module
    optimizer: torch.optim.Optimizer
    disc_optimizer: torch.optim.Optimizer
    club_optimizer: torch.optim.Optimizer
    generator: torch.Generator
    labels: Dict[str, str]
    step: int = 0


def create_train_state(cfg: CarelConfig, model: nn.Module,
                       generator: torch.Generator,
                       compat_frozen_latent_heads: bool = True) -> TrainState:
    labels = param_labels(model, compat_frozen_latent_heads)
    groups: Dict[str, list] = {MAIN: [], DISC: [], CLUB: []}
    for name, p in model.named_parameters():
        if labels[name] == FROZEN:
            p.requires_grad_(False)
        else:
            groups[labels[name]].append(p)
    tc = cfg.train
    device = next(model.parameters()).device
    cuda = device.type == "cuda"

    def adam(params, lr: float) -> torch.optim.Adam:
        if cuda:
            # fused: the whole update in a few multi-tensor launches; the
            # capturable foreach update forms its bias corrections with a
            # launch per parameter (+340 launches a step at full width)
            return torch.optim.Adam(
                params, lr=torch.tensor(lr, dtype=torch.float32,
                                        device=device),
                betas=(0.9, 0.999), eps=1e-8, capturable=True, fused=True)
        return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)

    return TrainState(
        model=model,
        optimizer=adam(groups[MAIN], tc.vae_lr),
        disc_optimizer=DiscRMSprop(groups[DISC], lr=tc.adv_lr, decay=0.99,
                                   eps=1e-8),
        club_optimizer=adam(groups[CLUB], tc.aprx_lr),
        generator=generator, labels=labels)
