"""The routed experts of a mixture-of-experts layer, over the experts this
device holds: a dropless dispatch that needs no value on the host, and the
grouped products of the held experts (Triton kernels on CUDA).

The JAX package has no mixture of experts and no Pallas kernel is replaced:
this serves the DeepSeek-V2 encoder (``models/deepseek_v2.py``), whose
layers route each token to ``k`` of ``E`` experts of which this device holds
``held`` (an expert-parallel rank's share). cuBLAS takes the sizes of a
grouped product from the host, and inside a captured step the rows each
expert receives are known on the device alone, so the products are kernels
of their own.

Dispatch (``dispatch``, plain tensor ops, no host sync). A token sends at
most min(k, held) rows here, so the buffer of permuted rows holds
``buffer_rows`` = T min(k, held) rows plus ``BLOCK_M - 1`` of padding an
expert, an exact static bound: no token is ever dropped. The (token, slot)
choices are sorted by held expert with a stable sort; each expert's rows
start on a multiple of ``BLOCK_M``, so a tile of rows belongs to one expert
(``tile_expert``, -1 past the last one). The plan holds, for each choice,
its row (-1 when its expert is not held) and, for each row, its choice
(-1 for padding).

Kernels (``expert_gemm_kernel``, ``expert_gemm_wgrad_kernel``, and the
row kernels ``moe_*``): the grouped product C[r] = A[r] W[e(r)]^T (or
A[r] W[e(r)]) of the tiles that hold rows, in bf16 with fp32 sums, which
skip the empty tail of the buffer; each held expert's weight gradient
dW[e] = dC_e^T A_e summed over its rows in one fixed order; and the row
passes (the gather of the permuted rows, the SwiGLU and its derivative, the
weighted combine in slot order, the weights' gradient), which stop at the
last used row. No float atomics: the same inputs give the same bits on
every run and every replay. What bounds them on the card: the products'
FLOPs (about 2 x 2,048 x 4,224 a routed row forward at DeepSeek-V2-Lite's
widths), so the design's aim is to spend no tile on the empty tail and no
pass over the worst-case buffer.

The backward (``_RoutedExperts``) keeps the two products' outputs of the
forward, [gate | up] and the expert outputs, in their worst-case buffers
(9.5 GB over DeepSeek-V2-Lite's 13 mixture layers at 128 x 96 tokens), and
forms the gathered rows and the SwiGLU again with the row passes: no
product runs twice.

A CPU tensor takes each kernel's plain version (same arguments, same
arithmetic order of the combine); a CUDA tensor the kernel, with no
fallback. Triton is imported, and the kernels built, at the first launch.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

# rows of a tile of the grouped product; each held expert's rows start on a
# multiple of it
BLOCK_M = 128
# tiles, warps and pipeline stages of the grouped product and of the weight
# gradient (the fastest of 8 and 7 settings at DeepSeek-V2-Lite's widths on
# an H100); tiles of the row passes
BLOCK_N, BLOCK_K, GEMM_WARPS, GEMM_STAGES = 256, 64, 8, 3
WGRAD_M, WGRAD_N, WGRAD_K, WGRAD_WARPS, WGRAD_STAGES = 64, 128, 128, 4, 3
ROW_BLOCK, COL_BLOCK = 64, 256

# kernel launches since the last reset, counted where the wrappers run
launches = {"expert_gemm": 0, "expert_gemm_wgrad": 0, "moe_gather": 0,
            "moe_swiglu": 0, "moe_swiglu_bwd": 0, "moe_combine": 0,
            "moe_row_dot": 0}


class Plan(NamedTuple):
    """Where each routed choice goes in the permuted buffer of ``rows``
    rows: ``choice_rows`` [T, k] (-1: its expert is not held),
    ``row_choice`` [rows] (token * k + slot; -1: padding), ``tile_expert``
    [rows / BLOCK_M] int32 (-1: no rows), ``starts`` [held + 1] (the first
    row of each expert, then the rows used), ``counts`` [held] (rows an
    expert received)."""

    rows: int
    choice_rows: torch.Tensor
    row_choice: torch.Tensor
    tile_expert: torch.Tensor
    starts: torch.Tensor
    counts: torch.Tensor


def buffer_rows(tokens: int, k: int, held: int) -> int:
    """The permuted buffer's rows: every token's held choices, at most
    min(k, held), and each expert's padding to a tile."""
    bound = tokens * min(k, held) + held * (BLOCK_M - 1)
    return -(-bound // BLOCK_M) * BLOCK_M


def dispatch(ids: torch.Tensor, first: int, held: int) -> Plan:
    """The plan of routing choices ``ids`` [T, k] (expert indices over all
    experts) onto the experts [first, first + held), in device ops that
    read nothing back to the host."""
    T, k = ids.shape
    dev = ids.device
    R = buffer_rows(T, k, held)
    n = T * k
    local = ids.reshape(-1).long() - first
    key = torch.where((local >= 0) & (local < held), local,
                      torch.full_like(local, held))
    counts_all = (key[:, None] == torch.arange(held + 1, device=dev)).sum(0)
    counts = counts_all[:held]
    zero = counts.new_zeros(1)
    padded = (counts + BLOCK_M - 1) // BLOCK_M * BLOCK_M
    starts = torch.cat([zero, torch.cumsum(padded, 0)])
    # where each expert's choices begin in the sorted order
    sorted_starts = torch.cat([zero, torch.cumsum(counts_all, 0)[:-1]])
    sorted_key, order = torch.sort(key, stable=True)
    j = torch.arange(n, device=dev)
    held_sorted = sorted_key < held
    # a choice of an absent expert goes to a row of its own past the buffer
    dest = torch.where(held_sorted,
                       starts[sorted_key] + j - sorted_starts[sorted_key],
                       R + j)
    choice_rows = torch.empty(n, dtype=torch.long, device=dev).scatter_(
        0, order, torch.where(held_sorted, dest, -1))
    row_choice = torch.full((R + n,), -1, dtype=torch.long,
                            device=dev).scatter_(
        0, dest, torch.where(held_sorted, order, -1))[:R]
    tile_start = torch.arange(0, R, BLOCK_M, device=dev)
    tile_expert = torch.searchsorted(starts[1:].contiguous(), tile_start,
                                     right=True)
    tile_expert = torch.where(tile_expert < held, tile_expert, -1)
    return Plan(R, choice_rows.view(T, k), row_choice,
                tile_expert.to(torch.int32), starts, counts)


# --------------------------------------------------------------------------
# the Triton kernels, plain functions until ``_kernels`` builds them (tl is
# bound then: this module imports without triton)

tl = None


def expert_gemm_kernel(a_ptr, b_ptr, c_ptr, tile_expert_ptr, N, K,
                       s_am, s_ak, s_be, s_bn, s_bk, s_cm, s_cn,
                       BM: tl.constexpr, BN: tl.constexpr, BK: tl.constexpr,
                       IEEE: tl.constexpr):
    # C[r, n] = sum_k A[r, k] B[e, n, k] over the tiles of rows with an
    # expert; the strides of B give either layout of the weights
    pid_n = tl.program_id(0)
    pid_m = tl.program_id(1)
    e = tl.load(tile_expert_ptr + pid_m)
    if e >= 0:
        rm = pid_m * BM + tl.arange(0, BM)
        rn = pid_n * BN + tl.arange(0, BN)
        rk = tl.arange(0, BK)
        a_ptrs = a_ptr + rm[:, None] * s_am + rk[None, :] * s_ak
        b_ptrs = b_ptr + e * s_be + rk[:, None] * s_bk + rn[None, :] * s_bn
        acc = tl.zeros((BM, BN), dtype=tl.float32)
        for k0 in range(0, K, BK):
            kk = k0 + rk
            a = tl.load(a_ptrs, mask=kk[None, :] < K, other=0.0)
            b = tl.load(b_ptrs, mask=(kk[:, None] < K) & (rn[None, :] < N),
                        other=0.0)
            if IEEE:
                acc = tl.dot(a, b, acc, input_precision="ieee")
            else:
                acc = tl.dot(a, b, acc)
            a_ptrs += BK * s_ak
            b_ptrs += BK * s_bk
        tl.store(c_ptr + rm[:, None] * s_cm + rn[None, :] * s_cn,
                 acc.to(c_ptr.dtype.element_ty), mask=rn[None, :] < N)


def expert_gemm_wgrad_kernel(dc_ptr, a_ptr, dw_ptr, starts_ptr, N, K,
                             s_dm, s_dn, s_am, s_ak, s_we, s_wn, s_wk,
                             BM: tl.constexpr, BN: tl.constexpr,
                             BK: tl.constexpr, IEEE: tl.constexpr):
    # dW[e, n, k] = sum over expert e's rows r of dC[r, n] A[r, k], the
    # rows in ascending order
    pid_k = tl.program_id(0)
    pid_n = tl.program_id(1)
    e = tl.program_id(2)
    lo = tl.load(starts_ptr + e)
    hi = tl.load(starts_ptr + e + 1)
    rn = pid_n * BN + tl.arange(0, BN)
    rk = pid_k * BK + tl.arange(0, BK)
    rm = tl.arange(0, BM)
    acc = tl.zeros((BN, BK), dtype=tl.float32)
    for m0 in range(lo, hi, BM):
        rows = m0 + rm
        dc = tl.load(dc_ptr + rows[:, None] * s_dm + rn[None, :] * s_dn,
                     mask=rn[None, :] < N, other=0.0)
        a = tl.load(a_ptr + rows[:, None] * s_am + rk[None, :] * s_ak,
                    mask=rk[None, :] < K, other=0.0)
        if IEEE:
            acc = tl.dot(tl.trans(dc), a, acc, input_precision="ieee")
        else:
            acc = tl.dot(tl.trans(dc), a, acc)
    tl.store(dw_ptr + e * s_we + rn[:, None] * s_wn + rk[None, :] * s_wk,
             acc, mask=(rn[:, None] < N) & (rk[None, :] < K))


def moe_gather_kernel(src_ptr, row_choice_ptr, scale_ptr, out_ptr, used_ptr,
                      D, TOPK: tl.constexpr, HAS_SCALE: tl.constexpr,
                      BR: tl.constexpr, BD: tl.constexpr):
    # out[r] = scale[c] src[c // k] for the row's choice c, 0 for padding
    r0 = tl.program_id(0) * BR
    if r0 < tl.load(used_ptr):
        rows = r0 + tl.arange(0, BR)
        cols = tl.program_id(1) * BD + tl.arange(0, BD)
        c = tl.load(row_choice_ptr + rows)
        valid = c >= 0
        tok = tl.where(valid, c // TOPK, 0)
        v = tl.load(src_ptr + tok[:, None] * D + cols[None, :],
                    mask=valid[:, None] & (cols[None, :] < D),
                    other=0.0).to(tl.float32)
        if HAS_SCALE:
            s = tl.load(scale_ptr + tl.where(valid, c, 0), mask=valid,
                        other=0.0)
            v = v * s[:, None]
        tl.store(out_ptr + rows[:, None] * D + cols[None, :],
                 v.to(out_ptr.dtype.element_ty), mask=cols[None, :] < D)


def moe_swiglu_kernel(h_ptr, a_ptr, used_ptr, I, BR: tl.constexpr,
                      BD: tl.constexpr):
    # a = silu(gate) * up of h = [gate | up], in fp32
    r0 = tl.program_id(0) * BR
    if r0 < tl.load(used_ptr):
        rows = r0 + tl.arange(0, BR)
        cols = tl.program_id(1) * BD + tl.arange(0, BD)
        m = cols[None, :] < I
        at = rows[:, None] * (2 * I) + cols[None, :]
        g = tl.load(h_ptr + at, mask=m, other=0.0).to(tl.float32)
        u = tl.load(h_ptr + at + I, mask=m, other=0.0).to(tl.float32)
        a = g * tl.sigmoid(g) * u
        tl.store(a_ptr + rows[:, None] * I + cols[None, :],
                 a.to(a_ptr.dtype.element_ty), mask=m)


def moe_swiglu_bwd_kernel(h_ptr, da_ptr, dh_ptr, used_ptr, I,
                          BR: tl.constexpr, BD: tl.constexpr):
    # dh = [da u silu'(gate) | da silu(gate)]
    r0 = tl.program_id(0) * BR
    if r0 < tl.load(used_ptr):
        rows = r0 + tl.arange(0, BR)
        cols = tl.program_id(1) * BD + tl.arange(0, BD)
        m = cols[None, :] < I
        at = rows[:, None] * (2 * I) + cols[None, :]
        g = tl.load(h_ptr + at, mask=m, other=0.0).to(tl.float32)
        u = tl.load(h_ptr + at + I, mask=m, other=0.0).to(tl.float32)
        da = tl.load(da_ptr + rows[:, None] * I + cols[None, :], mask=m,
                     other=0.0).to(tl.float32)
        s = tl.sigmoid(g)
        dg = da * u * s * (1.0 + g * (1.0 - s))
        du = da * g * s
        tl.store(dh_ptr + at, dg.to(dh_ptr.dtype.element_ty), mask=m)
        tl.store(dh_ptr + at + I, du.to(dh_ptr.dtype.element_ty), mask=m)


def moe_combine_kernel(y_ptr, choice_rows_ptr, coef_ptr, out_ptr, D,
                       TOPK: tl.constexpr, HAS_COEF: tl.constexpr,
                       BD: tl.constexpr):
    # out[t] = sum over the token's held slots, in slot order, of
    # coef[t, s] y[row(t, s)], in fp32, cast once
    t = tl.program_id(0)
    cols = tl.program_id(1) * BD + tl.arange(0, BD)
    m = cols < D
    acc = tl.zeros((BD,), dtype=tl.float32)
    for s in tl.static_range(TOPK):
        r = tl.load(choice_rows_ptr + t * TOPK + s)
        if r >= 0:
            v = tl.load(y_ptr + r * D + cols, mask=m, other=0.0).to(
                tl.float32)
            if HAS_COEF:
                v = v * tl.load(coef_ptr + t * TOPK + s)
            acc += v
    tl.store(out_ptr + t * D + cols, acc.to(out_ptr.dtype.element_ty),
             mask=m)


def moe_row_dot_kernel(g_ptr, y_ptr, choice_rows_ptr, out_ptr, D,
                       TOPK: tl.constexpr, BD: tl.constexpr):
    # out[t, s] = <g[t], y[row(t, s)]> in fp32, 0 for a slot not held
    t = tl.program_id(0)
    for s in tl.static_range(TOPK):
        r = tl.load(choice_rows_ptr + t * TOPK + s)
        acc = tl.zeros((BD,), dtype=tl.float32)
        if r >= 0:
            for d0 in range(0, D, BD):
                cols = d0 + tl.arange(0, BD)
                m = cols < D
                gv = tl.load(g_ptr + t * D + cols, mask=m, other=0.0)
                yv = tl.load(y_ptr + r * D + cols, mask=m, other=0.0)
                acc += gv.to(tl.float32) * yv.to(tl.float32)
        tl.store(out_ptr + t * TOPK + s, tl.sum(acc, axis=0))


_KERNELS: dict = {}


def _kernels() -> dict:
    """The Triton kernels, built at the first launch."""
    if not _KERNELS:
        import triton
        import triton.language

        globals()["tl"] = triton.language
        for fn in (expert_gemm_kernel, expert_gemm_wgrad_kernel,
                   moe_gather_kernel, moe_swiglu_kernel,
                   moe_swiglu_bwd_kernel, moe_combine_kernel,
                   moe_row_dot_kernel):
            _KERNELS[fn.__name__] = triton.jit(fn)
    return _KERNELS


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _check_cuda(*tensors) -> None:
    for t in tensors:
        if not t.is_contiguous():
            raise ValueError("expert kernels take contiguous tensors")


# --------------------------------------------------------------------------
# the wrappers: a CPU tensor takes the plain version, a CUDA one the kernel


def expert_gemm(a: torch.Tensor, w: torch.Tensor, plan: Plan,
                transpose: bool = True) -> torch.Tensor:
    """C [rows, N] in ``a``'s dtype: C[r] = a[r] @ w[e]^T with ``w``
    [held, N, K] (``transpose``), else a[r] @ w[e] with ``w`` [held, K, N],
    e the expert of r's tile; the rows of tiles with no expert are not
    written (0 in the plain version)."""
    N, K = (w.shape[1], w.shape[2]) if transpose else (w.shape[2],
                                                       w.shape[1])
    if a.device.type == "cpu":
        return expert_gemm_plain(a, w, plan, transpose)
    _check_cuda(a, w)
    c = torch.empty(a.shape[0], N, dtype=a.dtype, device=a.device)
    s_bn, s_bk = (w.stride(1), w.stride(2)) if transpose else \
        (w.stride(2), w.stride(1))
    grid = (_cdiv(N, BLOCK_N), plan.rows // BLOCK_M)
    _kernels()["expert_gemm_kernel"][grid](
        a, w, c, plan.tile_expert, N, K, a.stride(0), a.stride(1),
        w.stride(0), s_bn, s_bk, c.stride(0), c.stride(1),
        BM=BLOCK_M, BN=BLOCK_N, BK=BLOCK_K, IEEE=a.dtype == torch.float32,
        num_warps=GEMM_WARPS, num_stages=GEMM_STAGES)
    launches["expert_gemm"] += 1
    return c


def expert_gemm_plain(a, w, plan: Plan, transpose: bool = True):
    N = w.shape[1] if transpose else w.shape[2]
    c = torch.zeros(a.shape[0], N, dtype=a.dtype, device=a.device)
    for i, e in enumerate(plan.tile_expert.tolist()):
        if e < 0:
            continue
        rows = slice(i * BLOCK_M, (i + 1) * BLOCK_M)
        we = w[e].float()
        c[rows] = (a[rows].float() @ (we.T if transpose else we)).to(a.dtype)
    return c


def expert_gemm_wgrad(dc: torch.Tensor, a: torch.Tensor,
                      plan: Plan) -> torch.Tensor:
    """dW [held, N, K] fp32: dW[e] = dc_e^T @ a_e over expert e's rows."""
    held = plan.starts.shape[0] - 1
    N, K = dc.shape[1], a.shape[1]
    if dc.device.type == "cpu":
        return expert_gemm_wgrad_plain(dc, a, plan)
    _check_cuda(dc, a)
    dw = torch.empty(held, N, K, dtype=torch.float32, device=dc.device)
    grid = (_cdiv(K, WGRAD_K), _cdiv(N, WGRAD_N), held)
    _kernels()["expert_gemm_wgrad_kernel"][grid](
        dc, a, dw, plan.starts, N, K, dc.stride(0), dc.stride(1),
        a.stride(0), a.stride(1), dw.stride(0), dw.stride(1), dw.stride(2),
        BM=WGRAD_M, BN=WGRAD_N, BK=WGRAD_K,
        IEEE=dc.dtype == torch.float32, num_warps=WGRAD_WARPS,
        num_stages=WGRAD_STAGES)
    launches["expert_gemm_wgrad"] += 1
    return dw


def expert_gemm_wgrad_plain(dc, a, plan: Plan):
    starts = plan.starts.tolist()
    return torch.stack([dc[lo:hi].float().T @ a[lo:hi].float()
                        for lo, hi in zip(starts[:-1], starts[1:])])


def _used(plan: Plan) -> torch.Tensor:
    return plan.starts[-1:]


def gather_rows(src: torch.Tensor, plan: Plan, k: int,
                scale: Optional[torch.Tensor] = None,
                dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """[rows, D]: row r is src[c // k] (times scale[c] in fp32) for its
    choice c, 0 for padding, in ``dtype`` (``src``'s); rows past the used
    ones are not written (0 in the plain version)."""
    dtype = dtype or src.dtype
    D = src.shape[1]
    if src.device.type == "cpu":
        return gather_rows_plain(src, plan, k, scale, dtype)
    _check_cuda(src)
    out = torch.empty(plan.rows, D, dtype=dtype, device=src.device)
    grid = (plan.rows // ROW_BLOCK, _cdiv(D, COL_BLOCK))
    _kernels()["moe_gather_kernel"][grid](
        src, plan.row_choice, scale if scale is not None else src, out,
        _used(plan), D, TOPK=k, HAS_SCALE=scale is not None, BR=ROW_BLOCK,
        BD=COL_BLOCK, num_warps=8)
    launches["moe_gather"] += 1
    return out


def gather_rows_plain(src, plan: Plan, k: int, scale=None, dtype=None):
    c = plan.row_choice
    valid = c >= 0
    v = src[torch.where(valid, c // k, 0)].float()
    if scale is not None:
        v = v * scale.reshape(-1)[torch.where(valid, c, 0)][:, None]
    return torch.where(valid[:, None], v, 0.0).to(dtype or src.dtype)


def swiglu(h: torch.Tensor, plan: Plan) -> torch.Tensor:
    """a [rows, I] = silu(h[:, :I]) * h[:, I:] in fp32, in h's dtype."""
    I2 = h.shape[1]
    I = I2 // 2
    if h.device.type == "cpu":
        return swiglu_plain(h)
    _check_cuda(h)
    a = torch.empty(h.shape[0], I, dtype=h.dtype, device=h.device)
    grid = (plan.rows // ROW_BLOCK, _cdiv(I, COL_BLOCK))
    _kernels()["moe_swiglu_kernel"][grid](h, a, _used(plan), I,
                                          BR=ROW_BLOCK, BD=COL_BLOCK,
                                          num_warps=8)
    launches["moe_swiglu"] += 1
    return a


def swiglu_plain(h):
    g, u = h.float().chunk(2, dim=1)
    return (g * torch.sigmoid(g) * u).to(h.dtype)


def swiglu_backward(h: torch.Tensor, da: torch.Tensor,
                    plan: Plan) -> torch.Tensor:
    """dh [rows, 2 I] of ``swiglu`` from its output's gradient ``da``."""
    I = h.shape[1] // 2
    if h.device.type == "cpu":
        return swiglu_backward_plain(h, da)
    _check_cuda(h, da)
    dh = torch.empty_like(h)
    grid = (plan.rows // ROW_BLOCK, _cdiv(I, COL_BLOCK))
    _kernels()["moe_swiglu_bwd_kernel"][grid](h, da, dh, _used(plan), I,
                                              BR=ROW_BLOCK, BD=COL_BLOCK,
                                              num_warps=8)
    launches["moe_swiglu_bwd"] += 1
    return dh


def swiglu_backward_plain(h, da):
    g, u = h.float().chunk(2, dim=1)
    d = da.float()
    s = torch.sigmoid(g)
    return torch.cat([d * u * s * (1.0 + g * (1.0 - s)), d * g * s],
                     dim=1).to(h.dtype)


def combine(y: torch.Tensor, plan: Plan, coef: Optional[torch.Tensor],
            dtype: torch.dtype) -> torch.Tensor:
    """[T, D]: out[t] = sum over the token's held slots s, in slot order,
    of coef[t, s] y[row(t, s)] (coef 1 when None), in fp32, cast once to
    ``dtype``."""
    T, k = plan.choice_rows.shape
    D = y.shape[1]
    if y.device.type == "cpu":
        return combine_plain(y, plan, coef, dtype)
    _check_cuda(y)
    out = torch.empty(T, D, dtype=dtype, device=y.device)
    grid = (T, _cdiv(D, 1024))
    _kernels()["moe_combine_kernel"][grid](
        y, plan.choice_rows, coef if coef is not None else y, out, D,
        TOPK=k, HAS_COEF=coef is not None, BD=1024, num_warps=4)
    launches["moe_combine"] += 1
    return out


def combine_plain(y, plan: Plan, coef, dtype):
    T, k = plan.choice_rows.shape
    acc = torch.zeros(T, y.shape[1], dtype=torch.float32, device=y.device)
    for s in range(k):
        r = plan.choice_rows[:, s]
        v = y[r.clamp(min=0)].float()
        if coef is not None:
            v = v * coef[:, s:s + 1]
        acc = acc + torch.where((r >= 0)[:, None], v, 0.0)
    return acc.to(dtype)


def row_dot(g: torch.Tensor, y: torch.Tensor, plan: Plan) -> torch.Tensor:
    """[T, k] fp32: <g[t], y[row(t, s)]>, 0 for a slot not held."""
    T, k = plan.choice_rows.shape
    D = g.shape[1]
    if g.device.type == "cpu":
        return row_dot_plain(g, y, plan)
    _check_cuda(g, y)
    out = torch.empty(T, k, dtype=torch.float32, device=g.device)
    _kernels()["moe_row_dot_kernel"][(T,)](g, y, plan.choice_rows, out, D,
                                           TOPK=k, BD=1024, num_warps=4)
    launches["moe_row_dot"] += 1
    return out


def row_dot_plain(g, y, plan: Plan):
    r = plan.choice_rows
    v = (g.float()[:, None, :] * y[r.clamp(min=0)].float()).sum(-1)
    return torch.where(r >= 0, v, 0.0)


# --------------------------------------------------------------------------


def _expert_forward(x, w_gate_up, w_down, plan: Plan, k: int):
    """(permuted rows, [gate | up], SwiGLU, expert outputs), the rows of the
    buffer, in x's dtype."""
    xp = gather_rows(x, plan, k)
    h = expert_gemm(xp, w_gate_up, plan)
    a = swiglu(h, plan)
    return xp, h, a, expert_gemm(a, w_down, plan)


class _RoutedExperts(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weights, w_gate_up, w_down, choice_rows, row_choice,
                tile_expert, starts, counts, rows):
        plan = Plan(rows, choice_rows, row_choice, tile_expert, starts,
                    counts)
        k = choice_rows.shape[1]
        with torch.autocast(device_type=x.device.type, enabled=False):
            wgu, wd = w_gate_up.to(x.dtype), w_down.to(x.dtype)
            _, h, _, y = _expert_forward(x, wgu, wd, plan, k)
            out = combine(y, plan, weights, x.dtype)
        ctx.rows = rows
        ctx.dtypes = w_gate_up.dtype, w_down.dtype
        # the backward takes the products' outputs (and the weights' casts,
        # as autocast keeps a linear layer's) and forms the rest again
        ctx.save_for_backward(x, weights, wgu, wd, h, y, choice_rows,
                              row_choice, tile_expert, starts, counts)
        return out

    @staticmethod
    def backward(ctx, g):
        x, weights, wgu, wd, h, y, *rest = ctx.saved_tensors
        plan = Plan(ctx.rows, *rest)
        k = plan.choice_rows.shape[1]
        g = g.contiguous()
        xp = gather_rows(x, plan, k)
        a = swiglu(h, plan)
        dweights = row_dot(g, y, plan)
        del y
        dy = gather_rows(g, plan, k, scale=weights, dtype=x.dtype)
        da = expert_gemm(dy, wd, plan, transpose=False)
        dw_down = expert_gemm_wgrad(dy, a, plan)
        del dy, a
        dh = swiglu_backward(h, da, plan)
        del h, da
        dxp = expert_gemm(dh, wgu, plan, transpose=False)
        dw_gate_up = expert_gemm_wgrad(dh, xp, plan)
        dx = combine(dxp, plan, None, x.dtype)
        return (dx, dweights, dw_gate_up.to(ctx.dtypes[0]),
                dw_down.to(ctx.dtypes[1])) + (None,) * 6


def routed_experts(x: torch.Tensor, weights: torch.Tensor,
                   plan: Plan, w_gate_up: torch.Tensor,
                   w_down: torch.Tensor) -> torch.Tensor:
    """[T, D] in x's dtype: each token's sum, in slot order and fp32, of
    weights[t, s] SwiGLU_e(x[t]) over its slots whose expert e this device
    holds, cast once; 0 for a token with none. ``x`` [T, D], ``weights``
    [T, k] fp32, ``w_gate_up`` [held, 2 I, D] (gate rows, then up rows),
    ``w_down`` [held, D, I]."""
    return _RoutedExperts.apply(x.contiguous(), weights.contiguous(),
                                w_gate_up, w_down, plan.choice_rows,
                                plan.row_choice, plan.tile_expert,
                                plan.starts, plan.counts, plan.rows)
