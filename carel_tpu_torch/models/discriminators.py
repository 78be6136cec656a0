"""Adversarial and variational auxiliary networks, port of the
LinearDiscriminator and ClubNet of carel_tpu/models/discriminators.py.

- LinearDiscriminator: the GAN variant's cross-latent adversaries (ec_disc /
  ce_disc, drl_classifier_ec_gan.py:168-169): dropout then one linear layer.
- ClubNet: the VI variant's conditional approximation network p(e|c)
  (drl_classifier_ec_vi_final.py:153-161): linear-relu-linear for mu and
  linear-relu-linear-tanh for log_var.
- grad_reverse: the gradient-reversal layer of the clause-level DANN
  (models/dann.py);
- DomainDiscriminator: the reference's domain head, gradient reversal then
  hidden-relu-hidden-relu-logit (Dense ``fc1``, ``fc2``, ``out``),
  exported as in the JAX package (which no trainer calls).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class LinearDiscriminator(nn.Module):
    def __init__(self, in_dim: int, num_classes: int = 1,
                 dropout: float = 0.5):
        super().__init__()
        self.dropout = dropout
        self.disc = nn.Linear(in_dim, num_classes)

    def forward(self, z: torch.Tensor, deterministic: bool = True):
        return self.disc(F.dropout(z, self.dropout,
                                   training=not deterministic))


class ClubNet(nn.Module):
    """Approximation network for the CLUB-style upper bound."""

    def __init__(self, ec_dim: int = 24):
        super().__init__()
        self.mu_in = nn.Linear(ec_dim, ec_dim)
        self.mu_out = nn.Linear(ec_dim, ec_dim)
        self.lv_in = nn.Linear(ec_dim, ec_dim)
        self.lv_out = nn.Linear(ec_dim, ec_dim)

    def forward(self, cause_emb: torch.Tensor):
        mu = self.mu_out(F.relu(self.mu_in(cause_emb)))
        log_var = torch.tanh(self.lv_out(F.relu(self.lv_in(cause_emb))))
        return mu, log_var


class _GradReverse(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, lambda_):
        ctx.lambda_ = lambda_
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return -ctx.lambda_ * g, None


def grad_reverse(x: torch.Tensor, lambda_: float = 1.0) -> torch.Tensor:
    """Gradient reversal (DANN): the identity forward, -lambda * g
    backward, as carel_tpu's custom_vjp ``grad_reverse``."""
    return _GradReverse.apply(x, float(lambda_))


class DomainDiscriminator(nn.Module):
    """grad_reverse(features, grl_lambda), then Dense(hidden) - relu -
    Dense(hidden) - relu - Dense(1): one domain logit a row."""

    def __init__(self, in_dim: int, hidden_dim: int = 100,
                 grl_lambda: float = 1.0):
        super().__init__()
        self.grl_lambda = grl_lambda
        self.fc1 = nn.Linear(in_dim, hidden_dim)
        self.fc2 = nn.Linear(hidden_dim, hidden_dim)
        self.out = nn.Linear(hidden_dim, 1)

    def forward(self, features: torch.Tensor) -> torch.Tensor:
        x = grad_reverse(features, self.grl_lambda)
        x = F.relu(self.fc1(x))
        x = F.relu(self.fc2(x))
        return self.out(x)
