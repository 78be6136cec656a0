"""Flash attention with a segment mask: CUDA kernels K7 (forward), K8 (dK and
dV) and K9 (dQ, with the row term delta = sum(o * do) as its prologue).

Port of the stock Pallas TPU flash attention that carel_tpu's SelfAttention
calls under ``attention_impl="flash"`` (carel_tpu/models/encoder.py:48-67).
The kernels live in ``carel_tpu_torch/csrc``: for bf16 inputs all three run
on the tensor cores (``flash_mma.cu``), for fp32 inputs on the CUDA cores
(``flash.cu``); the C entry points pick by the input type, there is nothing
to choose here. This module checks the
inputs, allocates outputs and scratch, launches on the current stream and
counts launches.

The function: ``softmax(q . k^T * sm_scale + segment mask) . v``. The mask
is the stock kernel's segment mask, not a key-padding mask: token i attends
to token j iff ``mask[b, i] == mask[b, j]``, the rest gets ``-0.7 * FLT_MAX``
added. So pad queries attend to pad keys, every row keeps a positive softmax
sum (an all-pad row gives finite values), and the output at pad positions
differs from a key-padding attention while real positions agree. There is no
dropout on the probabilities, in training too.

Arithmetic: scores are fp32 sums of the input-type products; the softmax is
fp32; the unnormalised probabilities ``exp(s - max)`` are rounded to v's type
before the product with v (the stock kernel rounds ``exp(s - running max)``;
its single-block form and the XLA attention round the normalised
probabilities), summed in fp32 and divided by the fp32 row sum; the output
takes the input type. For fp32 inputs nothing is rounded.

``flash_attention`` (stock layout ``[B, h, L, hd]``) and
``flash_attention_packed`` (the encoder's packed projection
``[B, L, 3, h, hd]`` read in place, context written as ``[B, L, h * hd]``,
gradient one packed buffer) are what callers use. A CPU tensor goes to the
plain version ``flash_attention_plain``; a CUDA tensor launches the kernels
or raises. There is no fallback.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from carel_tpu_torch.ops import native

# the stock kernel's DEFAULT_MASK_VALUE
MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)

# kernel launches since the last reset, counted where each C entry point runs
launches = {"flash_fwd": 0, "flash_bwd_dkv": 0, "flash_bwd_dq": 0}

_DTYPES = (torch.float32, torch.bfloat16)


def segment_ids(mask: torch.Tensor) -> torch.Tensor:
    """The ``[B, L]`` attention mask (or any integer-valued segment ids) as
    the contiguous int32 tensor the kernels read."""
    if mask.dim() != 2:
        raise ValueError(f"mask must be [B, L], got {tuple(mask.shape)}")
    return mask.to(torch.int32).contiguous()


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          mask: torch.Tensor, sm_scale: float,
                          out_dtype: Optional[torch.dtype] = None
                          ) -> torch.Tensor:
    """The same function in plain PyTorch ops on q, k, v ``[B, h, L, hd]``
    and mask ``[B, L]``: dense fp32 scores from the upcast inputs, the
    segment mask with the stock mask value, ``exp(s - max)`` rounded to v's
    type, fp32 sums. ``out_dtype`` (default: q's) is the type of the result;
    float32 gives the value before the last rounding."""
    seg = segment_ids(mask)
    with torch.autocast(device_type=q.device.type, enabled=False):
        logits = (q.float() @ k.float().transpose(-1, -2)) * sm_scale
        same = seg[:, None, :, None] == seg[:, None, None, :]
        logits = logits + torch.where(same, 0.0, MASK_VALUE)
        unnorm = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
        out = (unnorm.to(v.dtype).float() @ v.float()) \
            / unnorm.sum(dim=-1, keepdim=True)
    return out.to(out_dtype or q.dtype)


def _strides(t: torch.Tensor) -> Tuple[int, int, int]:
    return t.stride(0), t.stride(1), t.stride(2)


def _row_alignment(t: torch.Tensor) -> int:
    """The boundary, in elements, on which every row of a view must start:
    16 bytes (the kernels' vector loads, ``cp.async`` and ``ldmatrix``), so 4
    fp32 or 8 bf16 elements."""
    return 16 // t.element_size()


def _rows_aligned(t: torch.Tensor) -> bool:
    """Whether the last dimension is contiguous and every row starts on the
    boundary of ``_row_alignment``: the base pointer and every other
    stride."""
    align = _row_alignment(t)
    return t.stride(-1) == 1 \
        and not any(s % align for s in t.stride()[:-1]) \
        and t.data_ptr() % 16 == 0


def _check_view(t: torch.Tensor, name: str, like: torch.Tensor) -> None:
    """Raise unless ``t`` is a ``[B, h, L, hd]`` view the kernels can
    address: like's device, dtype and shape, a contiguous last dimension,
    and rows that start on a 16-byte boundary (4 fp32 or 8 bf16
    elements)."""
    if t.device != like.device:
        raise ValueError(f"{name}: on {t.device}, expected {like.device}")
    if t.dtype != like.dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {like.dtype}")
    if tuple(t.shape) != tuple(like.shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(like.shape)}")
    if t.stride(3) != 1:
        raise ValueError(f"{name}: last dimension not contiguous")
    if not _rows_aligned(t):
        raise ValueError(f"{name}: rows do not start on a "
                         f"{_row_alignment(t)}-element boundary")


def _check_qkv(q, k, v, seg):
    if q.device.type != "cuda":
        raise ValueError(f"flash kernel: q on {q.device}, expected a CUDA "
                         "tensor")
    if q.dim() != 4:
        raise ValueError(f"flash kernel: q must be [B, h, L, hd], got "
                         f"{tuple(q.shape)}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"flash kernel: dtype {q.dtype}, expected float32 or "
                        "bfloat16")
    B, h, L, hd = q.shape
    if not native.lib().carel_flash_takes_head_dim(hd):
        raise ValueError(f"flash kernel: head dim {hd} is not one of 16, 32, "
                         "64, 128")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check_view(t, name, q)
        if _strides(t) != _strides(q):
            raise ValueError(f"flash kernel: {name} strides {_strides(t)} "
                             f"differ from q's {_strides(q)}")
    native.check_input(seg, "segment ids", (B, L), q.device, torch.int32)
    return B, h, L, hd


def flash_forward_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         seg: torch.Tensor, sm_scale: float,
                         out: torch.Tensor) -> torch.Tensor:
    """K7: writes the attention output into ``out`` (a ``[B, h, L, hd]``
    view with its own strides) and returns the fp32 log-sum-exp ``[B, h, L]``
    of each row's masked scores. q, k, v are ``[B, h, L, hd]`` views with
    equal strides, seg the int32 ``[B, L]`` segment ids."""
    B, h, L, hd = _check_qkv(q, k, v, seg)
    _check_view(out, "out", q)
    lse = torch.empty((B, h, L), dtype=torch.float32, device=q.device)
    err = native.lib().carel_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), seg.data_ptr(),
        out.data_ptr(), lse.data_ptr(), B, h, L, hd, *_strides(q),
        *_strides(out), sm_scale, int(q.dtype == torch.bfloat16),
        native.stream(q.device))
    native.check(err, "flash forward kernel")
    launches["flash_fwd"] += 1
    return lse


def flash_backward_dq_kernel(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, seg: torch.Tensor,
                             out: torch.Tensor, dout: torch.Tensor,
                             lse: torch.Tensor, sm_scale: float,
                             dq: torch.Tensor) -> torch.Tensor:
    """K9: writes dq (a ``[B, h, L, hd]`` view) of ``sum(out * dout)`` from
    the output and log-sum-exp of K7 for the same inputs, and returns the
    fp32 row term ``delta = sum(out * dout, -1)`` ``[B, h, L]`` that K8
    reads."""
    B, h, L, hd = _check_qkv(q, k, v, seg)
    for name, t in (("out", out), ("dout", dout), ("dq", dq)):
        _check_view(t, name, q)
    native.check_input(lse, "lse", (B, h, L), q.device)
    delta = torch.empty_like(lse)
    err = native.lib().carel_flash_bwd_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), seg.data_ptr(),
        out.data_ptr(), dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
        dq.data_ptr(), B, h, L, hd, *_strides(q), *_strides(out),
        *_strides(dout), *_strides(dq), sm_scale,
        int(q.dtype == torch.bfloat16), native.stream(q.device))
    native.check(err, "flash backward dq kernel")
    launches["flash_bwd_dq"] += 1
    return delta


def flash_backward_dkv_kernel(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, seg: torch.Tensor,
                              dout: torch.Tensor, lse: torch.Tensor,
                              delta: torch.Tensor, sm_scale: float,
                              dk: torch.Tensor, dv: torch.Tensor) -> None:
    """K8: writes dk and dv (``[B, h, L, hd]`` views with equal strides)
    from the log-sum-exp of K7 and the delta of K9 for the same inputs."""
    B, h, L, hd = _check_qkv(q, k, v, seg)
    for name, t in (("dout", dout), ("dk", dk), ("dv", dv)):
        _check_view(t, name, q)
    if _strides(dk) != _strides(dv):
        raise ValueError("flash kernel: dk and dv strides differ")
    native.check_input(lse, "lse", (B, h, L), q.device)
    native.check_input(delta, "delta", (B, h, L), q.device)
    err = native.lib().carel_flash_bwd_dkv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), seg.data_ptr(),
        dout.data_ptr(), lse.data_ptr(), delta.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), B, h, L, hd, *_strides(q), *_strides(dout),
        *_strides(dk), sm_scale, int(q.dtype == torch.bfloat16),
        native.stream(q.device))
    native.check(err, "flash backward dk/dv kernel")
    launches["flash_bwd_dkv"] += 1


def _backward(q, k, v, seg, out, dout, lse, sm_scale, dq, dk, dv) -> None:
    delta = flash_backward_dq_kernel(q, k, v, seg, out, dout, lse, sm_scale,
                                     dq)
    flash_backward_dkv_kernel(q, k, v, seg, dout, lse, delta, sm_scale, dk,
                              dv)


def _addressable(dout: torch.Tensor) -> torch.Tensor:
    """The cotangent as the kernels can address it (autograd may hand over
    an expanded or transposed one)."""
    return dout if _rows_aligned(dout) else dout.contiguous()


class _Flash(torch.autograd.Function):
    """q, k, v ``[B, h, L, hd]`` -> out ``[B, h, L, hd]``, contiguous."""

    @staticmethod
    def forward(ctx, q, k, v, seg, sm_scale):
        out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
        lse = flash_forward_kernel(q, k, v, seg, sm_scale, out)
        ctx.save_for_backward(q, k, v, seg, out, lse)
        ctx.sm_scale = sm_scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, seg, out, lse = ctx.saved_tensors
        dq, dk, dv = (torch.empty(q.shape, dtype=q.dtype, device=q.device)
                      for _ in range(3))
        _backward(q, k, v, seg, out, _addressable(dout), lse, ctx.sm_scale,
                  dq, dk, dv)
        return dq, dk, dv, None, None


def _heads_first(t: torch.Tensor) -> torch.Tensor:
    """``[B, L, h, hd]`` -> the ``[B, h, L, hd]`` view of the same memory."""
    return t.transpose(1, 2)


class _FlashPacked(torch.autograd.Function):
    """qkv ``[B, L, 3, h, hd]`` -> context ``[B, L, h * hd]``; q, k, v are
    read in place and the gradient is one packed buffer."""

    @staticmethod
    def forward(ctx, qkv, seg, sm_scale):
        B, L, _, h, hd = qkv.shape
        q, k, v = (_heads_first(t) for t in qkv.unbind(2))
        out = torch.empty((B, L, h * hd), dtype=qkv.dtype, device=qkv.device)
        lse = flash_forward_kernel(q, k, v, seg, sm_scale,
                                   _heads_first(out.view(B, L, h, hd)))
        ctx.save_for_backward(qkv, seg, out, lse)
        ctx.sm_scale = sm_scale
        return out

    @staticmethod
    def backward(ctx, dout):
        qkv, seg, out, lse = ctx.saved_tensors
        B, L, _, h, hd = qkv.shape
        q, k, v = (_heads_first(t) for t in qkv.unbind(2))
        dqkv = torch.empty(qkv.shape, dtype=qkv.dtype, device=qkv.device)
        dq, dk, dv = (_heads_first(t) for t in dqkv.unbind(2))
        _backward(q, k, v, seg, _heads_first(out.view(B, L, h, hd)),
                  _heads_first(_addressable(dout).view(B, L, h, hd)), lse,
                  ctx.sm_scale, dq, dk, dv)
        return dqkv, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    mask: torch.Tensor, sm_scale: float) -> torch.Tensor:
    """Attention of q, k, v ``[B, h, L, hd]`` (the stock kernel's layout)
    under the segment mask ``[B, L]``: the plain version on the CPU, kernels
    K7-K9 on CUDA."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, mask, sm_scale)
    if not (_strides(q) == _strides(k) == _strides(v)
            and all(_rows_aligned(t) for t in (q, k, v))):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    return _Flash.apply(q, k, v, segment_ids(mask), float(sm_scale))


def flash_attention_packed(qkv: torch.Tensor, mask: torch.Tensor,
                           sm_scale: float) -> torch.Tensor:
    """The same attention from the packed projection ``[B, L, 3, h, hd]``,
    returning the context ``[B, L, h * hd]``; no copy stands before or after
    the kernels."""
    if qkv.dim() != 5 or qkv.shape[2] != 3:
        raise ValueError(f"qkv must be [B, L, 3, h, hd], got "
                         f"{tuple(qkv.shape)}")
    B, L, _, h, hd = qkv.shape
    if qkv.device.type == "cpu":
        q, k, v = (_heads_first(t) for t in qkv.unbind(2))
        out = flash_attention_plain(q, k, v, mask, sm_scale)
        return out.transpose(1, 2).reshape(B, L, h * hd)
    if not qkv.is_contiguous():
        qkv = qkv.contiguous()
    return _FlashPacked.apply(qkv, segment_ids(mask), float(sm_scale))
