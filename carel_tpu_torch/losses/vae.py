"""VAE losses: KL with tanh annealing.

Port of carel_tpu/losses/vae.py (reference get_kl_loss / get_annealed_weight,
flagship :515-534). Means are masked so padded batch rows contribute nothing.
The BoW reconstruction term is the fused loss of ops/cuda_bow.py.
"""

from __future__ import annotations

import math

import torch

from carel_tpu_torch.losses.classify import masked_mean


def kl_loss(mu: torch.Tensor, log_var: torch.Tensor, mask=None) -> torch.Tensor:
    """mean over batch of -0.5 * sum(1 + lv - exp(lv) - mu^2) (flagship :525-534)."""
    per_example = -0.5 * torch.sum(1.0 + log_var - torch.exp(log_var)
                                   - mu ** 2, dim=-1)
    return masked_mean(per_example, mask)


def annealed_kl_weight(iteration: int, kl_ann_iterations: int,
                       lambda_weight: float) -> float:
    """tanh ramp (flagship :515-523) while iteration < T, weight 1 after.

    Computed in double on the host: early in the ramp tanh is close to -1,
    and an fp32 1 + tanh (as the JAX package computes it) keeps only ~3
    digits of the weight (~2.5e-4 at iteration 0)."""
    T = float(kl_ann_iterations)
    if not iteration < T:
        return 1.0
    return (math.tanh((iteration - T * 1.5) / (T / 3.0)) + 1.0) * lambda_weight
