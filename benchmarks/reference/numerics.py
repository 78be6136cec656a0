"""How the reference computes its products and draws its dropout masks.

``Numerics("fp32")`` is the reference: fp32 products with TF32 off.
``Numerics("fp8")`` is the control: the products the configuration runs in
bf16 (the encoder's) round every operand to float8 e4m3 with a per-tensor
scale, in the forward and in both products of the backward, as an fp8
GEMM does; that is the step below bf16 that a later change could be
tempted to take, and it must come out as not correct. ``Numerics("bf16")``
rounds those operands to bf16, to read how close a bf16 encoder comes to
the fp32 one.

``head`` is the precision of the products that the configuration runs in
fp32 with TF32 off (the CAREL heads, the MMD's Gram matrix, the BoW
decoder, the MLM head): "fp32" in the reference; "tf32" (10 bits of
mantissa, rounded to nearest) or "bf16" to read what a lower precision
there does, rounded the same way.

Dropout: torch's dropout draws its keep mask from the device's default
generator, and the draw depends on the tensor's shape and dtype. The
program drops bf16 tensors in its bf16 encoder and fp32 ones in its heads,
so the reference draws each mask from a tensor of ones of the program's
shape and dtype, in the program's order, from the same seed, and applies
it in fp32.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

FP8_MAX = 448.0  # largest finite float8 e4m3fn


def set_reference_numerics() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def round_fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 under a per-tensor scale."""
    scale = FP8_MAX / x.abs().amax().clamp(min=1e-30)
    return (x * scale).to(torch.float8_e4m3fn).to(x.dtype) / scale


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """fp32 rounded to TF32's 10 bits of mantissa, ties away from zero."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def round_bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(x.dtype)


ENCODER_ROUNDING = {"fp8": round_fp8, "bf16": round_bf16}
HEAD_ROUNDING = {"tf32": round_tf32, "bf16": round_bf16}


class _RoundedMatmul(torch.autograd.Function):
    """a @ b with every operand of the forward and backward products
    rounded by ``rnd``."""

    @staticmethod
    def forward(ctx, a, b, rnd):
        ra, rb = rnd(a), rnd(b)
        ctx.save_for_backward(ra, rb)
        ctx.rnd = rnd
        return ra @ rb

    @staticmethod
    def backward(ctx, g):
        ra, rb = ctx.saved_tensors
        rg = ctx.rnd(g)
        return rg @ rb.transpose(-1, -2), ra.transpose(-1, -2) @ rg, None


class Numerics:
    def __init__(self, mode: str = "fp32", dropout: bool = True,
                 head: str = "fp32"):
        if mode not in ("fp32", "bf16", "fp8"):
            raise ValueError(f"numerics {mode!r}")
        if head != "fp32" and head not in HEAD_ROUNDING:
            raise ValueError(f"head numerics {head!r}")
        self.mode = mode
        self.dropout = dropout
        self.head = head

    def head_mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """a @ b, a product the configuration runs in fp32."""
        if self.head == "fp32":
            return a @ b
        return _RoundedMatmul.apply(a, b, HEAD_ROUNDING[self.head])

    def head_linear(self, x: torch.Tensor, w: torch.Tensor,
                    b: Optional[torch.Tensor]) -> torch.Tensor:
        """x @ w^T + b, a layer the configuration runs in fp32."""
        if self.head == "fp32":
            return F.linear(x, w, b)
        shape = x.shape
        y = self.head_mm(x.reshape(-1, shape[-1]), w.transpose(0, 1))
        y = y.reshape(*shape[:-1], w.shape[0])
        return y if b is None else y + b

    def bmm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """a @ b, a product the configuration runs in bf16."""
        if self.mode == "fp32":
            return a @ b
        return _RoundedMatmul.apply(a, b, ENCODER_ROUNDING[self.mode])

    def linear(self, x: torch.Tensor, w: torch.Tensor,
               b: Optional[torch.Tensor]) -> torch.Tensor:
        """x @ w^T + b, a layer the configuration runs in bf16."""
        shape = x.shape
        y = self.bmm(x.reshape(-1, shape[-1]), w.transpose(0, 1))
        y = y.reshape(*shape[:-1], w.shape[0])
        return y if b is None else y + b

    def drop(self, x: torch.Tensor, p: float,
             mask_dtype: torch.dtype) -> torch.Tensor:
        """Dropout of ``x`` with the keep mask that torch's dropout draws
        for a tensor of ``x``'s shape and ``mask_dtype``."""
        if not self.dropout or p == 0.0:
            return x
        with torch.no_grad():
            ones = torch.ones(x.shape, dtype=mask_dtype, device=x.device)
            keep = F.dropout(ones, p, training=True) != 0
        return x * keep / (1.0 - p)
