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
update. With ``optim_mu_dtype="bfloat16"`` the main Adam is ``MuDtypeAdam``
(optax.adam's ``mu_dtype``: the first moment stored in bf16); the club Adam
keeps fp32 moments, as in JAX.

The attention adapters' params are ``main``. Under an adapter the pooler
gets no gradient, and neither does the sparse adapters' ``v_proj``: JAX
hands them zero gradients, after which Adam leaves them where they were;
here their ``.grad`` stays None on every step, so both Adams skip them and
never create their state, and one capture serves every step.

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


# entries of the denominators MuDtypeAdam holds at once (64 MB in fp32)
DENOM_CHUNK = 1 << 24


def _chunks(tensors, numel: int):
    """(lo, hi) ranges of ``tensors`` holding at most ``numel`` entries
    each, or one tensor that alone holds more."""
    lo = total = 0
    for i, t in enumerate(tensors):
        if total and total + t.numel() > numel:
            yield lo, i
            lo, total = i, 0
        total += t.numel()
    if lo < len(tensors):
        yield lo, len(tensors)


class MuDtypeAdam(torch.optim.Optimizer):
    """optax.adam(lr, b1, b2, eps, mu_dtype=...): Adam whose first moment is
    stored in ``mu_dtype`` (bf16 halves it), the update optax's:

        mu = (1 - b1) g + b1' mu       (fp32; b1' is b1 rounded to mu's
                                        dtype, as optax's weak-typed b1 * mu
                                        takes it, 0.8984375 in bf16; under
                                        jit XLA keeps the product in fp32)
        nu = b2 nu + (1 - b2) g^2      (fp32)
        p -= lr * (mu / (1 - b1^t)) / (sqrt(nu / (1 - b2^t)) + eps)

    with mu the fp32 value before it is stored back in ``mu_dtype``
    (rounded to nearest even). The state of a parameter is ``exp_avg``
    (mu), ``exp_avg_sq`` (nu) and ``step``, a 0-d fp32 tensor on the
    parameter's device, so train/checkpoint.py, scan_epoch's ``_Snapshot``
    and ``capture_key`` see it as they see torch's Adam. ``lr`` may be a 0-d
    device tensor (``set_lr`` writes it in place). The update is
    ``torch._foreach_*`` ops with no value read back to the host, so it
    captures in a CUDA graph. It works in the gradients' storage: after
    ``step`` a parameter's ``.grad`` holds the update it took (the train
    step clears every ``.grad`` before the next backward), and its only
    temporary is a chunk of denominators, so that its step needs less
    memory than fused fp32 Adam's state alone saves."""

    def __init__(self, params, lr, betas=(0.9, 0.999), eps: float = 1e-8,
                 mu_dtype: torch.dtype = torch.bfloat16):
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps))
        self.mu_dtype = mu_dtype

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("MuDtypeAdam.step takes no closure")
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            b1, b2 = group["betas"]
            grads = [p.grad for p in params]
            for p in params:
                state = self.state[p]
                if not state:
                    state["step"] = torch.zeros((), dtype=torch.float32,
                                                device=p.device)
                    state["exp_avg"] = torch.zeros_like(
                        p, dtype=self.mu_dtype)
                    state["exp_avg_sq"] = torch.zeros_like(p)
            steps = [self.state[p]["step"] for p in params]
            mus = [self.state[p]["exp_avg"] for p in params]
            nus = [self.state[p]["exp_avg_sq"] for p in params]
            torch._foreach_add_(steps, 1.0)
            # the bias corrections 1 - b^t, in fp32
            bc1 = torch._foreach_pow(b1, steps)
            bc2 = torch._foreach_pow(b2, steps)
            for bc in (bc1, bc2):
                torch._foreach_neg_(bc)
                torch._foreach_add_(bc, 1.0)
            torch._foreach_mul_(nus, b2)
            torch._foreach_addcmul_(nus, grads, grads, value=1.0 - b2)
            # mu in fp32, in the gradients' storage
            torch._foreach_mul_(grads, 1.0 - b1)
            torch._foreach_add_(grads, mus, alpha=float(
                torch.tensor(b1).to(self.mu_dtype)))
            torch._foreach_copy_(mus, grads)
            # the update; its one temporary, the denominators, is made a
            # chunk of parameters at a time, so that it never holds more
            # than DENOM_CHUNK entries (or one parameter)
            torch._foreach_div_(grads, bc1)
            for lo, hi in _chunks(nus, DENOM_CHUNK):
                denom = torch._foreach_div(nus[lo:hi], bc2[lo:hi])
                torch._foreach_sqrt_(denom)
                torch._foreach_add_(denom, group["eps"])
                torch._foreach_div_(grads[lo:hi], denom)
                del denom
            torch._foreach_mul_(grads, group["lr"])
            torch._foreach_sub_(params, grads)

    def load_state_dict(self, state_dict) -> None:
        """torch's load casts every state tensor to its param's dtype; the
        first moments go back to ``mu_dtype``."""
        super().load_state_dict(state_dict)
        for state in self.state.values():
            if "exp_avg" in state:
                state["exp_avg"] = state["exp_avg"].to(self.mu_dtype)


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


def device_lr(lr: float, device: torch.device):
    """An optimizer's lr: a 0-d fp32 tensor on a CUDA device (a captured
    step reads it, ``set_lr`` writes it in place), a float on the CPU."""
    if device.type == "cuda":
        return torch.tensor(lr, dtype=torch.float32, device=device)
    return lr


def adam(params, lr: float, device: torch.device) -> torch.optim.Adam:
    """torch's Adam(lr, betas (0.9, 0.999), eps 1e-8), optax.adam's update:
    on CUDA fused and capturable (the whole update in a few multi-tensor
    launches; the capturable foreach update forms its bias corrections with
    a launch per parameter, +340 launches a step at full width), on the CPU
    the default."""
    if device.type == "cuda":
        return torch.optim.Adam(params, lr=device_lr(lr, device),
                                betas=(0.9, 0.999), eps=1e-8,
                                capturable=True, fused=True)
    return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)


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
    if tc.optim_mu_dtype not in ("float32", "bfloat16"):
        raise ValueError(f"optim_mu_dtype {tc.optim_mu_dtype!r}: use "
                         "float32 or bfloat16")
    if tc.optim_mu_dtype == "bfloat16":
        main = MuDtypeAdam(groups[MAIN], lr=device_lr(tc.vae_lr, device),
                           betas=(0.9, 0.999), eps=1e-8,
                           mu_dtype=torch.bfloat16)
    else:
        main = adam(groups[MAIN], tc.vae_lr, device)
    return TrainState(
        model=model,
        optimizer=main,
        disc_optimizer=DiscRMSprop(groups[DISC], lr=tc.adv_lr, decay=0.99,
                                   eps=1e-8),
        club_optimizer=adam(groups[CLUB], tc.aprx_lr, device),
        generator=generator, labels=labels)
