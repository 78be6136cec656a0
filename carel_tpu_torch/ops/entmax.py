"""Sparsemax and 1.5-entmax over the last axis, port of
carel_tpu/ops/entmax.py.

The reference's sparse attention adapters apply Sparsemax / entmax15 from
the ``entmax`` package over attention scores
(drl_classifier_ec_mmd_final_mul_newsplit_emnlp.py:212-219, :263-268). As in
the JAX package: an exact, sort-based forward in fp32 and a closed-form
backward, so autograd never differentiates through the sort. The steps are
JAX's: sparsemax has no max shift, entmax15 halves and shifts by the row
max, its support index is clamped at 0 before the gather, and its backward
guards a zero denominator. One step differs: sparsemax clamps its support
size at 1, where JAX's gathers at index -1 and gives an all-masked row
(a padded batch row) inf weights.

Attention rows are short (L <= 128 at the presets' max_len), so the sort
is ``torch.sort`` over the last axis; everything here is device ops with no
value read back to the host, so it captures in a CUDA graph. The masked
scores (-1e9) sort last and get weight 0; an all-masked row gets uniform
weights under entmax15, as in JAX, and weight 0 under sparsemax.

References: Martins & Astudillo 2016 (sparsemax); Peters, Niculae & Martins
2019 (exact alpha=1.5 entmax).
"""

from __future__ import annotations

import torch


def _ranks(z: torch.Tensor) -> torch.Tensor:
    """1, 2, ..., n in fp32, n the last axis of ``z``."""
    return torch.arange(1, z.shape[-1] + 1, dtype=torch.float32,
                        device=z.device)


def sparsemax_forward(z: torch.Tensor) -> torch.Tensor:
    """Projection of the last axis onto the probability simplex, in fp32."""
    z = z.float()
    z_sorted = torch.sort(z, dim=-1, descending=True).values
    k = _ranks(z)
    cumsum = torch.cumsum(z_sorted, dim=-1)
    support = (1.0 + k * z_sorted) > cumsum
    # at least 1: on an all-masked row (a padded batch row) no rank is in
    # the support in fp32, and JAX's take_along_axis at index -1 reads the
    # row's total, which makes every weight inf; here the row gets weight
    # 0 (and a zero gradient) instead
    k_z = torch.clamp_min(support.sum(dim=-1, keepdim=True), 1).float()
    # cumsum at the support boundary
    tau_sum = torch.gather(cumsum, -1, (k_z - 1).long())
    tau = (tau_sum - 1.0) / k_z
    return torch.clamp_min(z - tau, 0.0)


def sparsemax_backward(p: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    s = (p > 0).to(g.dtype)
    v = g * s
    mean = v.sum(dim=-1, keepdim=True) / torch.clamp_min(
        s.sum(dim=-1, keepdim=True), 1.0)
    return (v - s * mean).to(p.dtype)


def entmax15_forward(z: torch.Tensor) -> torch.Tensor:
    """Exact alpha=1.5 entmax over the last axis, in fp32."""
    z = z.float() / 2.0
    # entmax is shift-invariant: subtract the max for stability
    z = z - z.max(dim=-1, keepdim=True).values
    z_sorted = torch.sort(z, dim=-1, descending=True).values
    k = _ranks(z)
    mean = torch.cumsum(z_sorted, dim=-1) / k
    meansq = torch.cumsum(z_sorted ** 2, dim=-1) / k
    ss = k * (meansq - mean ** 2)
    delta = (1.0 - ss) / k
    tau = mean - torch.sqrt(torch.clamp_min(delta, 0.0))
    # support: the largest k with tau_k <= z_sorted_k
    support = tau <= z_sorted
    k_z = support.sum(dim=-1, keepdim=True) - 1
    tau_star = torch.gather(tau, -1, torch.clamp_min(k_z, 0))
    return torch.clamp_min(z - tau_star, 0.0) ** 2


def entmax15_backward(p: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    # Jv = d*g - (sum(d*g) / sum(d)) * d with d = sqrt(p)
    d = torch.sqrt(p).to(g.dtype)
    dx = g * d
    denom = d.sum(dim=-1, keepdim=True)
    q = dx.sum(dim=-1, keepdim=True) / torch.where(
        denom == 0, torch.ones_like(denom), denom)
    return (dx - q * d).to(p.dtype)


class _Sparsemax(torch.autograd.Function):
    @staticmethod
    def forward(ctx, z):
        p = sparsemax_forward(z)
        ctx.save_for_backward(p)
        ctx.in_dtype = z.dtype
        return p

    @staticmethod
    def backward(ctx, g):
        (p,) = ctx.saved_tensors
        return sparsemax_backward(p, g).to(ctx.in_dtype)


class _Entmax15(torch.autograd.Function):
    @staticmethod
    def forward(ctx, z):
        p = entmax15_forward(z)
        ctx.save_for_backward(p)
        ctx.in_dtype = z.dtype
        return p

    @staticmethod
    def backward(ctx, g):
        (p,) = ctx.saved_tensors
        return entmax15_backward(p, g).to(ctx.in_dtype)


def sparsemax(z: torch.Tensor) -> torch.Tensor:
    """Sparsemax over the last axis (fp32 out), with the closed-form VJP."""
    return _Sparsemax.apply(z)


def entmax15(z: torch.Tensor) -> torch.Tensor:
    """1.5-entmax over the last axis (fp32 out), with the closed-form VJP."""
    return _Entmax15.apply(z)
