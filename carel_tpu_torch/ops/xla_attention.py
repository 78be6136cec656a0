"""The encoder's xla attention core (``attention_impl="xla"``, the default):
scores, the key-padding bias, the fp32 softmax, the bf16 probabilities,
dropout on them and their product with the values, from the packed
projection ``[B, L, 3, h, hd]`` to the context ``[B, L, h * hd]``.

- ``attention_ops``: the plain PyTorch ops, JAX's rounding points
  (carel_tpu/models/encoder.py:70-81). A CPU tensor takes them, and an fp32
  encoder on CUDA (the encoder chooses by the projection's dtype).
- ``xla_attention``: on CUDA, bf16 only, the kernel pair of
  ``csrc/attn_xla_{fwd,bwd}.cu`` (``csrc/attn_xla.cuh`` states the
  function and its roundings), with torch's own dropout draw; a CPU tensor
  goes to ``attention_ops``. There is no fallback: a CUDA input the kernels
  do not take raises.
- ``kernel_arithmetic``: the kernels' arithmetic in plain ops (normalised
  probabilities rounded to bf16, torch's dropout arithmetic, the row term
  of the softmax gradient, the fp32 ``ds`` as a bf16 hi/lo pair), which the
  tests and ``chip_smoke.py`` hold the kernels and ``attention_ops``
  against.
- ``attention_scores``: the fp32 ``q @ k^T`` of bf16 operands, which the
  plain ops and the DeepSeek-V2 encoder's MLA use.

The keep mask is drawn by torch's dropout on a contiguous bf16 tensor of the
probabilities' shape (``draw_keep``): the same bits, and the same advance of
the generator, as ``F.dropout`` on the probabilities in ``attention_ops``.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from carel_tpu_torch.ops import native

# kernel launches since the last reset, counted where each C entry point runs
launches = {"xla_attn_fwd": 0, "xla_attn_bwd": 0}


def scores_upcast(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """q @ k^T [..., L, L] in fp32 from the fp32 copies of q and k: a product
    of two bf16 values is exact in fp32 (TF32 is off), so this is the fp32
    sum of the bf16 products that JAX's preferred_element_type=float32
    gives."""
    return q.float() @ k.float().transpose(-1, -2)


class _Fp32Scores(torch.autograd.Function):
    """The same scores from bf16 q, k [N, L, hd] on CUDA: the bf16 tensor-core
    GEMM with its fp32 accumulator written out (``out_dtype``), with no fp32
    copies of q and k. The backward is JAX's transpose of that product: the
    fp32 cotangent times the other operand in fp32, rounded to bf16."""

    @staticmethod
    def forward(ctx, q, k):
        ctx.save_for_backward(q, k)
        return torch.bmm(q, k.transpose(1, 2), out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        q, k = ctx.saved_tensors
        with torch.autocast(device_type="cuda", enabled=False):
            dq = torch.bmm(g, k.float()).to(q.dtype)
            dk = torch.bmm(g.transpose(1, 2), q.float()).to(k.dtype)
        return dq, dk


def attention_scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """fp32 q @ k^T of q, k [B, h, L, hd]: bf16 CUDA tensors take the
    tensor-core GEMM with an fp32 output, everything else the upcast."""
    if q.is_cuda and q.dtype == torch.bfloat16:
        B, h, L, hd = q.shape
        return _Fp32Scores.apply(q.reshape(B * h, L, hd),
                                 k.reshape(B * h, L, hd)).view(B, h, L, L)
    return scores_upcast(q, k)


def attention_ops(qkv: torch.Tensor, bias: torch.Tensor, dropout: float,
                  training: bool) -> torch.Tensor:
    """The core as plain ops: fp32 scores of the (bf16) q and k, divided by
    sqrt(hd), plus the fp32 ``bias`` ``[B, 1, 1, L]``, an fp32 softmax cast
    to v's type, ``F.dropout`` on it, times v; ``[B, L, h * hd]``."""
    B, L, _, h, hd = qkv.shape
    q, k, v = (t.transpose(1, 2) for t in qkv.unbind(2))  # [B, h, L, hd]
    # fp32 sums of the bf16 q, k products, as JAX's
    # preferred_element_type=float32 gives them; autocast must not cast
    # the fp32 operands or scores back to bf16
    with torch.autocast(device_type=qkv.device.type, enabled=False):
        scores = attention_scores(q, k) / math.sqrt(hd)
    probs = torch.softmax(scores + bias, dim=-1).to(v.dtype)
    probs = F.dropout(probs, dropout, training=training)
    return (probs @ v).transpose(1, 2).reshape(B, L, -1)


def scales(hd: int, dropout: float) -> Tuple[float, float, float]:
    """The kernels' fp32 factors, as torch forms them on CUDA: the scale
    ``1 / sqrt(hd)`` (torch divides by a Python scalar as a product with
    its fp32 reciprocal), the dropout forward's ``1 / (1 - p)`` (the fp32
    keep probability's reciprocal) and its backward's (``1 / (1 - p)`` in
    double, cast to fp32)."""
    scale = np.float32(1.0) / np.float32(math.sqrt(hd))
    fscale = np.float32(1.0 / float(np.float32(1.0 - dropout)))
    bscale = np.float32(1.0 / (1.0 - dropout))
    return float(scale), float(fscale), float(bscale)


def draw_keep(shape: Tuple[int, ...], dropout: float,
              device: torch.device) -> torch.Tensor:
    """torch's dropout keep mask (bool) for a contiguous bf16 tensor of
    ``shape``: the bits and the generator's advance of ``F.dropout`` on the
    probabilities. The draw reads no value, so its input is left
    uninitialised."""
    buf = torch.empty(shape, dtype=torch.bfloat16, device=device)
    return torch.native_dropout(buf, dropout, True)[1]


def _check(qkv: torch.Tensor, bias: torch.Tensor) -> Tuple[int, ...]:
    """Raise unless the kernels take this projection and key bias; returns
    (B, L, h, hd)."""
    if qkv.device.type != "cuda":
        raise ValueError(f"xla attention kernels: qkv on {qkv.device}, "
                         "expected a CUDA tensor")
    if qkv.dtype != torch.bfloat16:
        raise TypeError(f"xla attention kernels: dtype {qkv.dtype}, expected "
                        "bfloat16")
    if qkv.dim() != 5 or qkv.shape[2] != 3:
        raise ValueError(f"qkv must be [B, L, 3, h, hd], got "
                         f"{tuple(qkv.shape)}")
    if not qkv.is_contiguous() or qkv.data_ptr() % 16:
        raise ValueError("xla attention kernels: qkv must be contiguous and "
                         "start on 16 bytes")
    B, L, _, h, hd = qkv.shape
    if not native.lib().carel_xla_attn_takes(L, hd):
        raise ValueError(f"xla attention kernels: head dim {hd} at L {L} "
                         "(head dims 16, 32, 64, 128; L up to what one "
                         "block's shared memory holds, 384 at head dim 64)")
    native.check_input(bias, "key bias", (B, L), qkv.device)
    return B, L, h, hd


def xla_attention_forward_kernel(qkv: torch.Tensor, bias: torch.Tensor,
                                 keep: Optional[torch.Tensor], scale: float,
                                 fscale: float):
    """The forward kernel: the context ``[B, L, h * hd]`` and each row's
    fp32 max and exp-sum ``[B, h, L]`` of qkv ``[B, L, 3, h, hd]`` (bf16),
    the key bias ``[B, L]`` (fp32) and the keep mask ``[B, h, L, L]``
    (bool, or None: no dropout)."""
    B, L, h, hd = _check(qkv, bias)
    if keep is not None:
        native.check_input(keep, "keep mask", (B, h, L, L), qkv.device,
                           torch.bool)
    out = torch.empty((B, L, h * hd), dtype=qkv.dtype, device=qkv.device)
    m = torch.empty((B, h, L), dtype=torch.float32, device=qkv.device)
    l = torch.empty_like(m)
    err = native.lib().carel_xla_attn_fwd(
        qkv.data_ptr(), bias.data_ptr(),
        None if keep is None else keep.data_ptr(), out.data_ptr(),
        m.data_ptr(), l.data_ptr(), B, h, L, hd, scale, fscale,
        native.stream(qkv.device))
    native.check(err, "xla attention forward kernel")
    launches["xla_attn_fwd"] += 1
    return out, m, l


def xla_attention_backward_kernel(qkv: torch.Tensor, bias: torch.Tensor,
                                  keep: Optional[torch.Tensor],
                                  dout: torch.Tensor, m: torch.Tensor,
                                  l: torch.Tensor, scale: float, fscale: float,
                                  bscale: float) -> torch.Tensor:
    """The backward kernel: the packed gradient ``[B, L, 3, h, hd]`` of the
    forward's inputs from the context's gradient ``dout`` and the forward's
    ``m`` and ``l``."""
    B, L, h, hd = _check(qkv, bias)
    if keep is not None:
        native.check_input(keep, "keep mask", (B, h, L, L), qkv.device,
                           torch.bool)
    native.check_input(dout, "context gradient", (B, L, h * hd), qkv.device,
                       qkv.dtype)
    native.check_input(m, "row max", (B, h, L), qkv.device)
    native.check_input(l, "row sum", (B, h, L), qkv.device)
    dqkv = torch.empty_like(qkv)
    err = native.lib().carel_xla_attn_bwd(
        qkv.data_ptr(), bias.data_ptr(),
        None if keep is None else keep.data_ptr(), dout.data_ptr(),
        m.data_ptr(), l.data_ptr(), dqkv.data_ptr(), B, h, L, hd, scale,
        fscale, bscale, native.stream(qkv.device))
    native.check(err, "xla attention backward kernel")
    launches["xla_attn_bwd"] += 1
    return dqkv


class _XlaAttention(torch.autograd.Function):
    """qkv ``[B, L, 3, h, hd]`` -> context ``[B, L, h * hd]`` through the
    kernel pair; the gradient is one packed buffer."""

    @staticmethod
    def forward(ctx, qkv, bias, keep, scale, fscale, bscale):
        out, m, l = xla_attention_forward_kernel(qkv, bias, keep, scale,
                                                 fscale)
        ctx.save_for_backward(qkv, bias, keep, m, l)
        ctx.scales = (scale, fscale, bscale)
        return out

    @staticmethod
    def backward(ctx, dout):
        qkv, bias, keep, m, l = ctx.saved_tensors
        dqkv = xla_attention_backward_kernel(
            qkv, bias, keep, dout.to(qkv.dtype).contiguous(), m, l,
            *ctx.scales)
        return dqkv, None, None, None, None, None


def xla_attention(qkv: torch.Tensor, bias: torch.Tensor, dropout: float,
                  training: bool) -> torch.Tensor:
    """The core of the packed projection ``qkv`` ``[B, L, 3, h, hd]`` under
    the fp32 key bias ``bias`` ``[B, 1, 1, L]``, with dropout ``dropout`` on
    the probabilities when ``training``: ``attention_ops`` for a CPU tensor,
    the kernel pair for a CUDA one."""
    if qkv.device.type == "cpu":
        return attention_ops(qkv, bias, dropout, training)
    B, L, _, h, hd = qkv.shape
    keep = None
    if training and dropout > 0.0:
        if dropout >= 1.0:
            raise ValueError(f"xla attention kernels: dropout {dropout}, "
                             "expected under 1")
        keep = draw_keep((B, h, L, L), dropout, qkv.device)
    return _XlaAttention.apply(qkv, bias.reshape(B, L), keep,
                               *scales(hd, dropout))


def _heads(t: torch.Tensor) -> torch.Tensor:
    """``[B, L, h, hd]`` -> fp32 ``[B, h, L, hd]``."""
    return t.transpose(1, 2).float()


def _rounded(t: torch.Tensor) -> torch.Tensor:
    return t.bfloat16().float()


class _KernelArithmetic(torch.autograd.Function):
    """The kernels' function and roundings in plain fp32 ops; gradient
    through the kernels' backward arithmetic."""

    @staticmethod
    def _probs(qkv, bias, keep, scale, fscale):
        q, k, v = (_heads(t) for t in qkv.unbind(2))
        x = (q @ k.transpose(-1, -2)) * scale + bias[:, None, None, :]
        e = torch.exp(x - x.amax(dim=-1, keepdim=True))
        p = e / e.sum(dim=-1, keepdim=True)
        pd = _rounded(p)
        if keep is not None:
            pd = torch.where(keep, _rounded(pd * fscale), 0.0)
        return q, k, v, p, pd

    @staticmethod
    def forward(ctx, qkv, bias, keep, scale, fscale, bscale):
        B, L, _, h, hd = qkv.shape
        with torch.autocast(device_type=qkv.device.type, enabled=False):
            _, _, v, _, pd = _KernelArithmetic._probs(qkv, bias, keep, scale,
                                                      fscale)
            out = pd @ v
        ctx.save_for_backward(qkv, bias, keep)
        ctx.scales = (scale, fscale, bscale)
        return out.transpose(1, 2).reshape(B, L, h * hd).to(qkv.dtype)

    @staticmethod
    def backward(ctx, dout):
        qkv, bias, keep = ctx.saved_tensors
        scale, fscale, bscale = ctx.scales
        B, L, _, h, hd = qkv.shape
        with torch.autocast(device_type=qkv.device.type, enabled=False):
            q, k, v, p, pd = _KernelArithmetic._probs(qkv, bias, keep, scale,
                                                      fscale)
            do = _heads(dout.reshape(B, L, h, hd))
            dv = pd.transpose(-1, -2) @ do
            dp = _rounded(do @ v.transpose(-1, -2))
            if keep is not None:
                dp = torch.where(keep, _rounded(dp * bscale), 0.0)
            row = (dp * p).sum(dim=-1, keepdim=True)
            ds = (p * (dp - row)) * scale
            hi = _rounded(ds)
            lo = _rounded(ds - hi)
            dq = hi @ k + lo @ k
            dk = hi.transpose(-1, -2) @ q + lo.transpose(-1, -2) @ q
        dqkv = torch.stack([t.transpose(1, 2) for t in (dq, dk, dv)], dim=2)
        return dqkv.to(qkv.dtype), None, None, None, None, None


def kernel_arithmetic(qkv: torch.Tensor, bias: torch.Tensor,
                      keep: Optional[torch.Tensor],
                      dropout: float) -> torch.Tensor:
    """The kernels' function in plain ops on any device, given the keep mask
    ``[B, h, L, L]`` (None: no dropout) and the fp32 key bias ``[B, L]``:
    the context ``[B, L, h * hd]`` in qkv's type; differentiable in qkv."""
    hd = qkv.shape[-1]
    return _KernelArithmetic.apply(qkv, bias.float(), keep,
                                   *scales(hd, dropout))
