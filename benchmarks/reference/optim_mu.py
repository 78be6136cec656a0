"""Adam with its first moment stored in bf16, as optax.adam(...,
mu_dtype=jnp.bfloat16) computes it, over a dict of fp32 tensors, and the
CAREL training steps of ``reference/carel.py`` with it in place of
``reference/optim.py``'s Adam.

optax's update with ``mu_dtype``: mu = (1 - b1) g + b1' mu, where mu is
the stored bf16 moment and b1' is b1 rounded to bf16 (optax's weak-typed
``b1 * mu`` takes the moment's dtype; under jit the product stays in
fp32); nu = b2 nu + (1 - b2) g^2 in fp32; the step from the fp32 mu, p -=
lr (mu / (1 - b1^t)) / (sqrt(nu / (1 - b2^t)) + eps); then mu is stored
in bf16, rounded to nearest even.
"""

from __future__ import annotations

from typing import Dict

import torch

from reference import carel as ref
from reference.encoder import part_norms


class MuAdam:
    def __init__(self, params: Dict[str, torch.Tensor], betas=(0.9, 0.999),
                 eps: float = 1e-8, mu_dtype=torch.bfloat16):
        self.params = params
        self.b1, self.b2 = betas
        self.b1_mu = float(torch.tensor(self.b1).to(mu_dtype))
        self.eps = eps
        self.t = 0
        self.m = {n: torch.zeros_like(p, dtype=mu_dtype)
                  for n, p in params.items()}
        self.v = {n: torch.zeros_like(p) for n, p in params.items()}

    @torch.no_grad()
    def step(self, grads: Dict[str, torch.Tensor], lr: float) -> None:
        self.t += 1
        bc1 = 1.0 - self.b1 ** self.t
        bc2 = 1.0 - self.b2 ** self.t
        for n, p in self.params.items():
            g = grads[n]
            mu = (1.0 - self.b1) * g + self.b1_mu * self.m[n].float()
            self.v[n].mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            denom = (self.v[n] / bc2).sqrt_().add_(self.eps)
            p.sub_(lr * (mu / bc1) / denom)
            self.m[n] = mu.to(self.m[n].dtype)


def train_steps(P, c: dict, k: dict, batches: list, kl_indices: list,
                noise_gen, num, mask_dtype, half: bool = False) -> dict:
    """``reference/carel.py``'s ``train_steps`` with ``MuAdam``."""
    names = ref.trainable(P)
    start = {n: P[n].detach().clone() for n in names}
    opt = MuAdam({n: P[n] for n in names}, k["adam_betas"], k["adam_eps"])
    losses, grad = [], {}
    for step, (batch, i) in enumerate(zip(batches, kl_indices)):
        leaves = {n: P[n].detach().requires_grad_(True) for n in names}
        Q = dict(P, **leaves)
        value = ref.loss(Q, c, k, batch, ref.kl_weight(i, k), noise_gen,
                         num, mask_dtype, half)
        grads = torch.autograd.grad(value, [leaves[n] for n in names])
        g = dict(zip(names, grads))
        if step == 0:
            grad = part_norms((n, g[n]) for n in names)
        losses.append(float(value.detach()))
        opt.step(g, k["lr"])
    change = part_norms((n, P[n] - start[n]) for n in names)
    return {"losses": losses, "grad": grad, "change": change}
