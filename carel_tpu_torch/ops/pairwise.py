"""Pairwise-distance kernel statistics, plain PyTorch.

Numerics follow the reference formulas (carel_tpu/ops/pairwise.py):

- ``pdist``: sqrt(eps + |x^2 + y^2 - 2xy|) with eps = 1e-5 *inside* the
  sqrt;
- ``mmd_statistic``: the unbiased two-sample estimator with an RBF-sum kernel
  exp(-alpha * pdist^2) over ``alphas``, diagonals removed from the
  within-sample blocks. The training loss uses the NEGATED statistic;
- ``mmd_permutation_test``: that statistic (unmasked) and its p-value under
  the label-permutation null;
- ``hsic``: tr(K H L H) / (n - 1)^2 with Gaussian Grams over *squared*
  distances.

An optional example mask makes zero-padded tail rows inert: the estimator
then runs over the n real rows. These are the plain versions that the CPU
runs and that the CUDA kernels (``carel_tpu_torch.ops.cuda_pairwise``) are
held against. The Gram products must run in full fp32:
``device.resolve_device`` turns TF32 off.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

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


def mmd_permutation_test(
    sample_1: torch.Tensor,
    sample_2: torch.Tensor,
    alphas: Sequence[float] = (0.1,),
    n_permutations: int = 1000,
    generator: Optional[torch.Generator] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(mmd, p_value) under the label-permutation null (the reference's
    MMDStatistic.pval is a stub; this is carel_tpu's working version). The
    kernel matrix of the pooled samples is formed once, in fp32; each
    permutation only reassigns the rows to the two samples, and all
    ``n_permutations`` statistics come from one [P, 2B] x [2B, 2B] product.
    The permutations are drawn from ``generator`` (seeded 0 on the samples'
    device by default)."""
    B = sample_1.shape[0]
    device = sample_1.device
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    sample_12 = torch.cat([sample_1, sample_2], 0).float()
    distances = pdist(sample_12, sample_12)
    kernels = torch.zeros_like(distances)
    for alpha in alphas:
        kernels = kernels + torch.exp(-alpha * distances ** 2)
    diag = torch.diagonal(kernels)

    n = float(B)
    a00 = 1.0 / (n * (n - 1.0))
    a01 = -1.0 / (n * n)

    def stat(f: torch.Tensor) -> torch.Tensor:
        """The statistic of each assignment f [P, 2B] (1 = sample 1)."""
        g = 1.0 - f
        kf = f @ kernels
        kg = g @ kernels
        k11 = torch.sum(kf * f, 1) - torch.sum(f * diag, 1)
        k22 = torch.sum(kg * g, 1) - torch.sum(g * diag, 1)
        k12 = torch.sum(kf * g, 1)
        return 2 * a01 * k12 + a00 * k11 + a00 * k22

    base = torch.cat([torch.ones(B), torch.zeros(B)]).to(device)
    observed = stat(base[None])[0]
    order = torch.argsort(torch.rand(n_permutations, 2 * B, device=device,
                                     generator=generator), dim=1)
    null = stat(base[order])
    p_value = torch.mean((null >= observed).float())
    return observed, p_value


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
