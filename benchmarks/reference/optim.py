"""Adam and AdamW (Kingma and Ba 2015; Loshchilov and Hutter 2019) over a
dict of fp32 tensors, as optax.adam / optax.adamw define them: eps outside
the square root, bias corrections 1 - beta^t, AdamW's decay p *= 1 - lr wd
before the update."""

from __future__ import annotations

from typing import Dict

import torch


class Adam:
    def __init__(self, params: Dict[str, torch.Tensor], betas=(0.9, 0.999),
                 eps: float = 1e-8, weight_decay: float = 0.0):
        self.params = params
        self.b1, self.b2 = betas
        self.eps = eps
        self.wd = weight_decay
        self.t = 0
        self.m = {n: torch.zeros_like(p) for n, p in params.items()}
        self.v = {n: torch.zeros_like(p) for n, p in params.items()}

    @torch.no_grad()
    def step(self, grads: Dict[str, torch.Tensor], lr: float) -> None:
        self.t += 1
        bc1 = 1.0 - self.b1 ** self.t
        bc2 = 1.0 - self.b2 ** self.t
        for n, p in self.params.items():
            g = grads[n]
            if self.wd:
                p.mul_(1.0 - lr * self.wd)
            self.m[n].mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            self.v[n].mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            denom = (self.v[n].sqrt() / bc2 ** 0.5).add_(self.eps)
            p.addcdiv_(self.m[n], denom, value=-lr / bc1)
