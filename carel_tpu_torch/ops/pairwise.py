"""Pairwise-distance kernel statistics, plain PyTorch.

Numerics follow the reference formulas (carel_tpu/ops/pairwise.py):

- ``pdist``: sqrt(eps + |x^2 + y^2 - 2xy|) with eps = 1e-5 *inside* the
  sqrt;
- ``mmd_statistic``: the unbiased two-sample estimator with an RBF-sum kernel
  exp(-alpha * pdist^2) over ``alphas``, diagonals removed from the
  within-sample blocks. The training loss uses the NEGATED statistic;
- ``hsic``: tr(K H L H) / (n - 1)^2 with Gaussian Grams over *squared*
  distances.

An optional example mask makes zero-padded tail rows inert: the estimator
then runs over the n real rows. These are the plain versions that the CPU
runs and that the CUDA kernels (``carel_tpu_torch.ops.cuda_pairwise``) are
held against. The Gram products must run in full fp32:
``device.resolve_device`` turns TF32 off.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch


def pdist(sample_1: torch.Tensor, sample_2: torch.Tensor,
          eps: float = 1e-5) -> torch.Tensor:
    """Euclidean distance matrix with the reference's eps-inside-sqrt guard."""
    n1 = torch.sum(sample_1 ** 2, dim=1, keepdim=True)
    n2 = torch.sum(sample_2 ** 2, dim=1, keepdim=True)
    d2 = n1 + n2.T - 2.0 * (sample_1 @ sample_2.T)
    return torch.sqrt(eps + torch.abs(d2))


def mmd_statistic(
    sample_1: torch.Tensor,
    sample_2: torch.Tensor,
    alphas: Sequence[float] = (0.1,),
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Unbiased MMD^2 between two equal-size samples; ``mask`` [B] marks the
    real rows of both."""
    B = sample_1.shape[0]
    if mask is None:
        mask = torch.ones(B, dtype=torch.float32, device=sample_1.device)
    mask = mask.float()
    n = torch.sum(mask)
    a00 = 1.0 / (n * (n - 1.0))
    a01 = -1.0 / (n * n)

    sample_12 = torch.cat([sample_1, sample_2], dim=0).float()
    distances = pdist(sample_12, sample_12)
    kernels = torch.zeros_like(distances)
    for alpha in alphas:
        kernels = kernels + torch.exp(-alpha * distances ** 2)

    m2 = torch.cat([mask, mask])
    kernels = kernels * m2[:, None] * m2[None, :]

    k_1 = kernels[:B, :B]
    k_2 = kernels[B:, B:]
    k_12 = kernels[:B, B:]
    return (2 * a01 * torch.sum(k_12)
            + a00 * (torch.sum(k_1) - torch.trace(k_1))
            + a00 * (torch.sum(k_2) - torch.trace(k_2)))


def _gaussian_gram(x: torch.Tensor, sigma: float) -> torch.Tensor:
    # exp(-squared_distances / sigma): squared distances, no sqrt, no abs
    # and no eps, unlike pdist
    norms = torch.sum(x ** 2, dim=-1, keepdim=True)
    d2 = norms + norms.T - 2.0 * (x @ x.T)
    return torch.exp(-d2 / sigma)


def hsic(x: torch.Tensor, y: torch.Tensor, s_x: float = 1.0,
         s_y: float = 1.0, mask: Optional[torch.Tensor] = None
         ) -> torch.Tensor:
    """Hilbert-Schmidt Independence Criterion tr(K H L H) / (n - 1)^2 with
    Gaussian Grams K, L. The mask acts through the centering matrix
    H = diag(m) - m m^T / n, whose rows and columns at padded positions are
    zero, so padded rows are inert. Computes in fp32, or in float64 for
    float64 inputs."""
    B = x.shape[0]
    dtype = torch.promote_types(x.dtype, torch.float32)
    if mask is None:
        mask = torch.ones(B, dtype=dtype, device=x.device)
    mask = mask.to(dtype)
    n = torch.sum(mask)
    K = _gaussian_gram(x.to(dtype), s_x)
    L = _gaussian_gram(y.to(dtype), s_y)
    H = torch.diag(mask) - torch.outer(mask, mask) / n
    return torch.sum((L @ H) * (K @ H).T) / ((n - 1.0) ** 2)
