"""Fused BoW decoder loss: CUDA kernels K3 (forward) and K4 (backward).

Port of carel_tpu/ops/pallas_bow.py. The loss (reference flagship
:252-254, :381-387) is

    L = mean_{real rows, V} BCE(softmax(h W^T + b), t),   t = c + s*w

with c = ls/V, s = 1-ls and w the sparse normalized BoW counts. Per row the
dense sum decomposes into per-row scalars

    R = -c*S_z - s*sum_nnz(w*z_g) + lse*T_sum
        - (1-c)*S_log1mp + s*sum_nnz(w*log(1-p_g))
    T_sum = c*V + s*sum(w),  S_z = sum_v z_v,  S_log1mp = sum_v log(1-p_v)

so the kernel (``carel_tpu_torch/csrc/bow.cu``: one launch, the logits
evaluated once and kept on the chip between its two sweeps) returns lse, S_z,
S_log1mp and Qp = sum_v p/(1-p) per row; the [B, V] logits are never stored
in device memory. The nnz part (z at the <= T bag-of-words indices) runs
here in plain torch, as it ran in XLA. The backward, with per-row
A = c*V - (1-c)*Qp + s*Qw (Qw = sum_nnz w/(1-p_g)), is

    dR/dz_v = -c + A*p_v + (1-c)*p_v/(1-p_v)     (dense part)
              - s*w_v - s*w_v*p_v/(1-p_v)        (nnz corrections)

The backward kernel K4 is one launch as well: it evaluates the logits once
more, forms G = dR/dz from them on the chip, adds the nnz corrections
(computed here, per row and nnz slot) at their columns of G in a fixed order,
and from G forms dW, db and dh. No float atomics add anything, so the
backward gives the same bits on every run and every replay of a captured
step (an ``index_add_`` of the corrections would not).

W is the decoder's ``nn.Linear`` weight, [V, D].

``fused_bow_loss`` is what the loss calls: a CPU tensor goes to
``fused_bow_loss_plain`` (dense logits and autograd); a CUDA tensor launches
the kernels or raises. There is no fallback.
"""

from __future__ import annotations

from typing import Optional

import torch

from carel_tpu_torch.ops import native
from carel_tpu_torch.ops.bow_recon import densify_bow

# kernel launches since the last reset, counted where each C entry point runs
launches = {"bow_fwd": 0, "bow_bwd": 0}

P_MAX = 1.0 - 1e-7  # the reference clamp of p away from 1


def fused_bow_loss_plain(
    hidden: torch.Tensor,  # [B, D]
    W: torch.Tensor,  # [V, D]
    b: torch.Tensor,  # [V]
    bow_indices: torch.Tensor,  # [B, T], -1 padded
    bow_weights: torch.Tensor,  # [B, T]
    label_smoothing: float = 0.1,
    example_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The fused loss computed densely: z = h W^T + b, then the BCE of
    pallas_bow.py:240-265 (p clamped at 1-1e-7); autograd gives the
    backward."""
    B = hidden.shape[0]
    V = W.shape[0]
    c = label_smoothing / V
    s = 1.0 - label_smoothing
    z = hidden.float() @ W.float().T + b.float()
    logp = torch.log_softmax(z, dim=1)
    p = torch.clamp(torch.exp(logp), max=P_MAX)
    target = densify_bow(bow_indices, bow_weights, V) * s + c
    R = torch.sum(-target * logp - (1.0 - target) * torch.log1p(-p), dim=1)
    if example_mask is None:
        example_mask = torch.ones(B, dtype=torch.float32, device=hidden.device)
    denom = torch.clamp(torch.sum(example_mask), min=1.0) * V
    return torch.sum(R * example_mask) / denom


def _check_dense(h, W, b):
    if h.device.type != "cuda":
        raise ValueError(f"bow kernel: h on {h.device}, expected a CUDA "
                         "tensor")
    if h.dim() != 2 or W.dim() != 2:
        raise ValueError("bow kernel: h must be [B, D] and W [V, D]")
    B, D = h.shape
    V = W.shape[0]
    if D > native.lib().carel_bow_max_dim():
        raise ValueError(f"bow kernel: D = {D} exceeds "
                         f"{native.lib().carel_bow_max_dim()}")
    native.check_input(h, "h", (B, D), h.device)
    native.check_input(W, "W", (V, D), h.device)
    native.check_input(b, "b", (V,), h.device)
    return B, D, V


def bow_forward_kernel(h: torch.Tensor, W: torch.Tensor,
                       b: torch.Tensor) -> torch.Tensor:
    """K3: [4, B] = lse, S_z, S_log1mp, Qp per row of z = h W^T + b."""
    B, D, V = _check_dense(h, W, b)
    lib = native.lib()
    scratch = lib.carel_bow_fwd_scratch(B, D, V, 0)
    if scratch < 0:
        raise RuntimeError("bow forward kernel: the card could not be queried")
    # the result and, behind it, the per-chunk partials of the two sweeps
    buf = torch.empty(4 * B + scratch, dtype=torch.float32, device=h.device)
    out = buf[:4 * B].view(4, B)
    err = lib.carel_bow_fwd(h.data_ptr(), W.data_ptr(), b.data_ptr(), B, D, V,
                            buf[4 * B:].data_ptr(), out.data_ptr(),
                            native.stream(h.device))
    native.check(err, "bow forward kernel")
    launches["bow_fwd"] += 1
    return out


def bow_backward_kernel(h: torch.Tensor, W: torch.Tensor, b: torch.Tensor,
                        rowp: torch.Tensor, idx: torch.Tensor,
                        corr: torch.Tensor):
    """K4: (dW [V, D], db [V], dh [B, D]) with rowp [5, B] = lse, A,
    (1-c)*gscale, c*gscale, gscale: of the dense part plus the corrections
    corr [B, T] at the BoW indices idx [B, T] (int64; an index outside V, or
    a correction of 0, adds nothing), each added to G in ascending t."""
    B, D, V = _check_dense(h, W, b)
    native.check_input(rowp, "rowp", (5, B), h.device)
    T = idx.shape[-1]
    native.check_input(idx, "idx", (B, T), h.device, torch.int64)
    native.check_input(corr, "corr", (B, T), h.device)
    lib = native.lib()
    floats = lib.carel_bow_bwd_scratch(B, D, V, 0)
    if floats < 0:
        raise RuntimeError("bow backward kernel: the card could not be "
                           "queried")
    # each block's partial dh, which the kernel adds up after a grid barrier
    scratch = torch.empty(floats, dtype=torch.float32, device=h.device)
    dW = torch.empty_like(W)
    db = torch.empty_like(b)
    dh = torch.empty_like(h)
    err = lib.carel_bow_bwd(h.data_ptr(), W.data_ptr(), b.data_ptr(), B, D, V,
                            rowp.data_ptr(), idx.data_ptr(), corr.data_ptr(),
                            T,
                            dW.data_ptr(), db.data_ptr(), dh.data_ptr(),
                            scratch.data_ptr(), native.stream(h.device))
    native.check(err, "bow backward kernel")
    launches["bow_bwd"] += 1
    return dW, db, dh


def loss_from_row_sums(stats, h, W, b, bow_indices, bow_weights, mask,
                       label_smoothing):
    """The loss from the four dense row sums ``stats`` = (lse, S_z, S_log1mp,
    Qp) and the nnz part, which is computed here; also returns what the
    backward keeps: (safe indices, valid, w, p at the indices, the
    denominator)."""
    V = W.shape[0]
    c = label_smoothing / V
    s = 1.0 - label_smoothing
    lse, S_z, S_log1mp, _ = stats
    valid = bow_indices >= 0
    safe = torch.where(valid, bow_indices, 0).long()
    w = torch.where(valid, bow_weights, 0.0)
    Wg = W[safe]  # [B, T, D]
    zg = torch.einsum("btd,bd->bt", Wg, h) + b[safe]
    pg = torch.clamp(torch.exp(zg - lse[:, None]), max=P_MAX)
    T_sum = c * V + s * torch.sum(w, dim=1)
    R = (-c * S_z - s * torch.sum(w * zg, dim=1) + lse * T_sum
         - (1.0 - c) * S_log1mp
         + s * torch.sum(w * torch.where(valid, torch.log1p(-pg), 0.0),
                         dim=1))
    denom = torch.clamp(torch.sum(mask), min=1.0) * V
    return torch.sum(R * mask) / denom, (safe, valid, w, pg, denom)


class _FusedBow(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h, W, b, bow_indices, bow_weights, mask, label_smoothing):
        stats = bow_forward_kernel(h, W, b)
        loss, (safe, valid, w, pg, denom) = loss_from_row_sums(
            stats, h, W, b, bow_indices, bow_weights, mask, label_smoothing)
        ctx.save_for_backward(h, W, b, safe, valid, w, mask, stats[0],
                              stats[3], pg, denom)
        ctx.label_smoothing = label_smoothing
        return loss

    @staticmethod
    def backward(ctx, g):
        h, W, b, safe, valid, w, mask, lse, Qp, pg, denom = ctx.saved_tensors
        V = W.shape[0]
        c = ctx.label_smoothing / V
        s = 1.0 - ctx.label_smoothing
        Qw = torch.sum(torch.where(valid, w / (1.0 - pg), 0.0), dim=1)
        A = c * V - (1.0 - c) * Qp + s * Qw
        gscale = g * mask / denom  # per-row upstream grad x mean scaling
        rowp = torch.stack([lse, A, (1.0 - c) * gscale, c * gscale,
                            gscale]).contiguous()
        # sparse corrections at the nnz indices: -s*w - s*w*p_g/(1-p_g)
        corr = torch.where(valid, (-s * w - s * w * pg / (1.0 - pg))
                           * gscale[:, None], 0.0).contiguous()
        dW, db, dh = bow_backward_kernel(h, W, b, rowp, safe, corr)
        return dh, dW, db, None, None, None, None


def fused_bow_loss(
    hidden: torch.Tensor,  # [B, D] generative embedding (48-d)
    W: torch.Tensor,  # [V, D] decoder weight
    b: torch.Tensor,  # [V] decoder bias
    bow_indices: torch.Tensor,  # [B, T] int, -1 padded
    bow_weights: torch.Tensor,  # [B, T]
    label_smoothing: float = 0.1,
    example_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Fused decoder + softmax + BCE loss (mean over real rows x V): the plain
    version on the CPU, kernels K3/K4 on CUDA."""
    if hidden.device.type == "cpu":
        return fused_bow_loss_plain(hidden, W, b, bow_indices, bow_weights,
                                    label_smoothing, example_mask)
    if example_mask is None:
        example_mask = torch.ones(hidden.shape[0], dtype=torch.float32,
                                  device=hidden.device)
    return _FusedBow.apply(hidden, W, b, bow_indices, bow_weights.float(),
                           example_mask.float(), float(label_smoothing))
