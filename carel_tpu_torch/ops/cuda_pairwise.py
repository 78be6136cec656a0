"""Fused pairwise statistics: unbiased MMD^2, CUDA kernels K1 (forward) and
K2 (backward), and HSIC, kernels K5 (forward) and K6 (backward).

Port of carel_tpu/ops/pallas_pairwise.py. The kernels live in
``carel_tpu_torch/csrc/mmd.cu`` and ``csrc/hsic.cu``; this module checks the
inputs, allocates outputs and scratch, launches on the current stream and
counts launches. Each call of an MMD wrapper makes one call into the
library; the library's limits are read once, when it loads
(``native.consts``).

``mmd_statistic`` and ``hsic_statistic`` are what the losses call. A CPU
tensor goes to the plain version (``mmd_statistic_plain`` / ``hsic_plain``,
the formulas of ``ops/pairwise.py``); a CUDA tensor launches the kernels or
raises. There is no fallback.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from carel_tpu_torch.ops import native
from carel_tpu_torch.ops.pairwise import hsic as hsic_plain
from carel_tpu_torch.ops.pairwise import mmd_statistic as mmd_statistic_plain

# kernel launches since the last reset, counted where each C entry point runs
launches = {"mmd_fwd": 0, "mmd_bwd": 0, "hsic_fwd": 0, "hsic_bwd": 0}


# K1's tile rows (kTile in csrc/mmd.cu), for the CPU tests that repeat K1's
# decomposition; the wrapper sizes K1's scratch from the library's own value
MMD_TILE_ROWS = 8

# K1's scratch on each device: its ticket (0 between launches) and its
# partials. It only grows, and a buffer it outgrows is kept alive: a captured
# CUDA graph may still hold its address. The port runs K1 on one stream; two
# streams must not run it at once on one device.
_mmd_scratch: dict = {}
_outgrown: list = []


def _alpha_args(alphas: Tuple[float, ...]):
    most = native.consts["carel_mmd_max_alphas"]
    if not 1 <= len(alphas) <= most:
        raise ValueError(f"mmd kernel takes 1..{most} alphas, got "
                         f"{len(alphas)}")
    return [*alphas, *([0.0] * (most - len(alphas)))], len(alphas)


def _check_inputs(x, y, mask, what="mmd"):
    if x.device.type != "cuda":
        raise ValueError(f"{what} kernel: x on {x.device}, expected a CUDA "
                         "tensor")
    if x.dim() != 2:
        raise ValueError(f"{what} kernel: x must be [B, d], got "
                         f"{tuple(x.shape)}")
    B, d = x.shape
    native.lib()
    max_dim = native.consts[f"carel_{what}_max_dim"]
    if d > max_dim:
        raise ValueError(f"{what} kernel: d = {d} exceeds {max_dim}")
    native.check_input(x, "x", (B, d), x.device)
    native.check_input(y, "y", (B, d), x.device)
    native.check_input(mask, "mask", (B,), x.device)
    return B, d


def _mmd_scratch_for(device: torch.device, B: int) -> torch.Tensor:
    """K1's scratch for B rows: the ticket and 3 partials for each of the
    nt (nt + 1) / 2 blocks, nt = ceil(B / tile rows)."""
    nt = -(-B // native.consts["carel_mmd_tile_rows"])
    need = 1 + 3 * (nt * (nt + 1) // 2)
    buf = _mmd_scratch.get(device)
    if buf is None or buf.numel() < need:
        if buf is not None:
            _outgrown.append(buf)
        buf = torch.zeros(need, dtype=torch.float64, device=device)
        _mmd_scratch[device] = buf
    return buf


def mmd_forward_kernel(x: torch.Tensor, y: torch.Tensor, mask: torch.Tensor,
                       alphas: Tuple[float, ...]):
    """K1: (MMD^2 as a 0-d tensor, the residuals K2 reads: float32 [2B + 2]
    holding MMD^2, n = sum(mask), then the squared norms of the rows of x
    and of y). One allocation, of which the value is a view."""
    B, d = _check_inputs(x, y, mask)
    al, n_al = _alpha_args(alphas)
    buf = torch.empty(2 + 2 * B, dtype=torch.float32, device=x.device)
    err = native.lib().carel_mmd_fwd(
        x.data_ptr(), y.data_ptr(), mask.data_ptr(), B, d, *al, n_al,
        _mmd_scratch_for(x.device, B).data_ptr(), buf.data_ptr(),
        native.stream(x.device))
    native.check(err, "mmd forward kernel")
    launches["mmd_fwd"] += 1
    return buf[0], buf


def mmd_backward_kernel(x: torch.Tensor, y: torch.Tensor, mask: torch.Tensor,
                        res: torch.Tensor, g: torch.Tensor,
                        alphas: Tuple[float, ...]):
    """K2: (dx, dy) of g * MMD^2, with ``res`` the residuals of K1 for the
    same inputs and g a 0-d device tensor."""
    B, d = _check_inputs(x, y, mask)
    native.check_input(res, "res", (2 * B + 2,), x.device)
    native.check_input(g, "g", (), x.device)
    al, n_al = _alpha_args(alphas)
    dx = torch.empty_like(x)
    dy = torch.empty_like(y)
    err = native.lib().carel_mmd_bwd(
        x.data_ptr(), y.data_ptr(), mask.data_ptr(), B, d, *al, n_al,
        res.data_ptr(), g.data_ptr(), dx.data_ptr(), dy.data_ptr(),
        native.stream(x.device))
    native.check(err, "mmd backward kernel")
    launches["mmd_bwd"] += 1
    return dx, dy


class _FusedMmd(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, y, mask, alphas):
        out, res = mmd_forward_kernel(x, y, mask, alphas)
        ctx.save_for_backward(x, y, mask, res)
        ctx.alphas = alphas
        return out

    @staticmethod
    def backward(ctx, g):
        x, y, mask, res = ctx.saved_tensors
        dx, dy = mmd_backward_kernel(x, y, mask, res, g.float().contiguous(),
                                     ctx.alphas)
        return dx, dy, None, None


def mmd_statistic(x: torch.Tensor, y: torch.Tensor,
                  alphas: Sequence[float] = (0.1,),
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Unbiased MMD^2 between the rows of x and y [B, d] (``mask`` [B] marks
    real rows): the plain version on the CPU, kernels K1/K2 on CUDA."""
    if x.device.type == "cpu":
        return mmd_statistic_plain(x, y, alphas, mask)
    if mask is None:
        mask = torch.ones(x.shape[0], dtype=torch.float32, device=x.device)
    return _FusedMmd.apply(x, y, mask, tuple(float(a) for a in alphas))


def _hsic_check(x, y, mask, s_x, s_y):
    B, d = _check_inputs(x, y, mask, "hsic")
    most = native.consts["carel_hsic_max_rows"]
    if not 2 <= B <= most:
        raise ValueError(f"hsic kernel: B = {B} outside 2..{most}")
    if not (s_x > 0.0 and s_y > 0.0):
        raise ValueError(f"hsic kernel: sigmas must be > 0, got {s_x}, {s_y}")
    return B, d


def hsic_forward_kernel(x: torch.Tensor, y: torch.Tensor, mask: torch.Tensor,
                        s_x: float, s_y: float):
    """K5: (HSIC as a 0-d tensor, the float64 residuals K6 reads: the row
    sums of both masked Grams, n and their totals)."""
    B, d = _hsic_check(x, y, mask, s_x, s_y)
    lib = native.lib()
    n_res = lib.carel_hsic_residuals(B)
    # the residuals and, behind them, the kernel's per-row partials
    buf = torch.empty(n_res + lib.carel_hsic_fwd_scratch(B),
                      dtype=torch.float64, device=x.device)
    res = buf[:n_res]
    out = torch.empty((), dtype=torch.float32, device=x.device)
    err = lib.carel_hsic_fwd(x.data_ptr(), y.data_ptr(), mask.data_ptr(), B,
                             d, s_x, s_y, res.data_ptr(),
                             buf[n_res:].data_ptr(), out.data_ptr(),
                             native.stream(x.device))
    native.check(err, "hsic forward kernel")
    launches["hsic_fwd"] += 1
    return out, res


def hsic_backward_kernel(x: torch.Tensor, y: torch.Tensor, mask: torch.Tensor,
                         s_x: float, s_y: float, res: torch.Tensor,
                         g: torch.Tensor):
    """K6: (dx, dy) of g * HSIC, with the residuals of K5 for the same inputs
    and g a 0-d device tensor."""
    B, d = _hsic_check(x, y, mask, s_x, s_y)
    if (res.device != x.device or res.dtype != torch.float64
            or tuple(res.shape) != (native.lib().carel_hsic_residuals(B),)):
        raise ValueError("hsic backward kernel: res is not the residual "
                         "buffer of hsic_forward_kernel for these inputs")
    native.check_input(g, "g", (), x.device)
    dx = torch.empty_like(x)
    dy = torch.empty_like(y)
    err = native.lib().carel_hsic_bwd(
        x.data_ptr(), y.data_ptr(), mask.data_ptr(), B, d, s_x, s_y,
        res.data_ptr(), g.data_ptr(), dx.data_ptr(), dy.data_ptr(),
        native.stream(x.device))
    native.check(err, "hsic backward kernel")
    launches["hsic_bwd"] += 1
    return dx, dy


class _FusedHsic(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, y, mask, s_x, s_y):
        out, res = hsic_forward_kernel(x, y, mask, s_x, s_y)
        ctx.save_for_backward(x, y, mask, res)
        ctx.sigmas = (s_x, s_y)
        return out

    @staticmethod
    def backward(ctx, g):
        x, y, mask, res = ctx.saved_tensors
        dx, dy = hsic_backward_kernel(x, y, mask, *ctx.sigmas, res,
                                      g.float().contiguous())
        return dx, dy, None, None, None


def hsic_statistic(x: torch.Tensor, y: torch.Tensor, s_x: float = 1.0,
                   s_y: float = 1.0,
                   mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """HSIC between the rows of x and y [B, d] (``mask`` [B] marks real
    rows): the plain version on the CPU, kernels K5/K6 on CUDA."""
    if x.device.type == "cpu":
        return hsic_plain(x, y, s_x, s_y, mask)
    if mask is None:
        mask = torch.ones(x.shape[0], dtype=torch.float32, device=x.device)
    return _FusedHsic.apply(x, y, mask, float(s_x), float(s_y))
