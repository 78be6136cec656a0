"""The port's MMD and BoW ops against the JAX package, and the CUDA kernels
against their plain versions.

CPU (always): the plain versions against carel_tpu.ops (XLA formulas and the
Pallas kernels in interpret mode), for values and gradients, with masked rows.
Tolerances: MMD value rtol 1e-5 and grads normwise rtol 1e-5; BoW values
rtol 1e-5 and grads rtol 2e-4 / atol 1e-7, the bars of
tests/test_pallas_bow.py.

The kernels themselves are held against the plain versions on the card in
tests/test_torch_kernels.py (marked ``cuda``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from carel_tpu.ops.bow_recon import bow_reconstruction_loss as j_bow_recon
from carel_tpu.ops.pairwise import mmd_statistic as j_mmd
from carel_tpu.ops.pallas_bow import fused_bow_loss as j_fused_bow
from carel_tpu.ops.pallas_pairwise import mmd_pallas

from carel_tpu_torch import ops
from carel_tpu_torch.ops import cuda_attention, cuda_bow, cuda_pairwise
from carel_tpu_torch.ops.bow_recon import bow_reconstruction_loss


def _mmd_problem(B=13, d=24, masked=3, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, d)).astype(np.float32)
    y = (rng.normal(size=(B, d)) * 1.2 + 0.3).astype(np.float32)
    mask = np.ones(B, np.float32)
    mask[B - masked:] = 0.0
    return x, y, mask


def _torch_value_and_grads(fn, *arrays):
    leaves = [torch.tensor(a, requires_grad=True) for a in arrays]
    val = fn(*leaves)
    grads = torch.autograd.grad(val, leaves)
    return float(val.detach()), [g.numpy() for g in grads]


@pytest.mark.parametrize("jax_impl", ["xla", "pallas"])
@pytest.mark.parametrize("alphas", [(0.1,), (0.1, 1.0)])
def test_plain_mmd_matches_jax(jax_impl, alphas):
    x, y, mask = _mmd_problem()
    mask_t = torch.tensor(mask)
    val, (dx, dy) = _torch_value_and_grads(
        lambda a, b: cuda_pairwise.mmd_statistic(a, b, alphas, mask_t), x, y)

    def jfn(a, b):
        if jax_impl == "pallas":
            return mmd_pallas(a, b, alphas, jnp.asarray(mask))
        return j_mmd(a, b, alphas, mask=jnp.asarray(mask))

    j_val, (j_dx, j_dy) = jax.value_and_grad(jfn, argnums=(0, 1))(x, y)
    np.testing.assert_allclose(val, float(j_val), rtol=1e-5)
    # grads: normwise rtol 1e-5; elementwise, entries that cancel to near
    # zero get an atol of 1e-6 of the largest entry
    for got, want in ((dx, j_dx), (dy, j_dy)):
        want = np.asarray(want)
        assert np.linalg.norm(got - want) <= 1e-5 * np.linalg.norm(want)
        np.testing.assert_allclose(got, want, rtol=1e-5,
                                   atol=1e-6 * np.abs(want).max())
    assert np.abs(dx[-3:]).max() == 0.0  # masked rows get no gradient


def _bow_problem(B=8, D=16, V=700, T=6, seed=1, masked=2):
    rng = np.random.default_rng(seed)
    h = rng.normal(size=(B, D)).astype(np.float32)
    W = (rng.normal(size=(D, V)) * 0.2).astype(np.float32)  # JAX [D, V]
    b = (rng.normal(size=V) * 0.1).astype(np.float32)
    idx = rng.integers(0, V, (B, T)).astype(np.int32)
    idx[:, -1] = -1  # padded nnz slot
    idx[0, 1] = idx[0, 0]  # duplicate index in one row
    wts = (rng.random((B, T)) * 0.5).astype(np.float32)
    wts[:, -1] = 0.0
    mask = np.ones(B, np.float32)
    mask[B - masked:] = 0.0
    return h, W, b, idx, wts, mask


@pytest.mark.parametrize("jax_impl", ["pallas", "xla"])
def test_plain_bow_matches_jax(jax_impl):
    # V = 700 is not a multiple of the Pallas tile (256)
    h, W, b, idx, wts, mask = _bow_problem()
    idx_t, wts_t, mask_t = map(torch.tensor, (idx, wts, mask))
    val, (dh, dWt, db) = _torch_value_and_grads(
        lambda hh, ww, bb: cuda_bow.fused_bow_loss(
            hh, ww, bb, idx_t, wts_t, 0.1, mask_t),
        h, np.ascontiguousarray(W.T), b)

    def jfn(hh, ww, bb):
        if jax_impl == "pallas":
            return j_fused_bow(hh, ww, bb, jnp.asarray(idx), jnp.asarray(wts),
                               0.1, jnp.asarray(mask), tile_v=256)
        return j_bow_recon(hh @ ww + bb, jnp.asarray(idx), jnp.asarray(wts),
                           0.1, jnp.asarray(mask))

    j_val, (j_dh, j_dW, j_db) = jax.value_and_grad(jfn, argnums=(0, 1, 2))(
        h, W, b)
    np.testing.assert_allclose(val, float(j_val), rtol=1e-5)
    for name, got, want in (("dh", dh, j_dh), ("dW", dWt.T, j_dW),
                            ("db", db, j_db)):
        np.testing.assert_allclose(got, np.asarray(want), rtol=2e-4,
                                   atol=1e-7, err_msg=name)


def test_bow_reconstruction_loss_matches_jax():
    h, W, b, idx, wts, mask = _bow_problem(seed=3)
    logits = h @ W + b
    got = bow_reconstruction_loss(torch.tensor(logits), torch.tensor(idx),
                                  torch.tensor(wts), 0.1, torch.tensor(mask))
    want = j_bow_recon(jnp.asarray(logits), jnp.asarray(idx),
                       jnp.asarray(wts), 0.1, jnp.asarray(mask))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


def test_cpu_tensors_take_the_plain_version():
    ops.reset_launch_counts()
    x, y, mask = _mmd_problem(B=6, masked=1)
    want = cuda_pairwise.mmd_statistic_plain(torch.tensor(x), torch.tensor(y),
                                             (0.1,), torch.tensor(mask))
    got = cuda_pairwise.mmd_statistic(torch.tensor(x), torch.tensor(y),
                                      (0.1,), torch.tensor(mask))
    assert float(got) == float(want)
    x, y, mask = (torch.tensor(a) for a in (x, y, mask))
    assert float(cuda_pairwise.hsic_statistic(x, y, 1.0, 0.7, mask)) == \
        float(cuda_pairwise.hsic_plain(x, y, 1.0, 0.7, mask))
    h, W, b, idx, wts, mask = _bow_problem(B=4, V=50, T=3, masked=1)
    args = (torch.tensor(h), torch.tensor(np.ascontiguousarray(W.T)),
            torch.tensor(b), torch.tensor(idx), torch.tensor(wts), 0.1,
            torch.tensor(mask))
    assert float(cuda_bow.fused_bow_loss(*args)) == \
        float(cuda_bow.fused_bow_loss_plain(*args))
    q = torch.tensor(np.random.default_rng(0).normal(size=(2, 2, 5, 16))
                     .astype(np.float32))
    seg = torch.tensor([[1, 1, 1, 0, 0], [0] * 5])
    assert torch.equal(
        cuda_attention.flash_attention(q, q, q, seg, 0.25),
        cuda_attention.flash_attention_plain(q, q, q, seg, 0.25))
    assert ops.launch_counts() == {
        "mmd_fwd": 0, "mmd_bwd": 0, "hsic_fwd": 0, "hsic_bwd": 0,
        "bow_fwd": 0, "bow_bwd": 0, "flash_fwd": 0, "flash_bwd_dkv": 0,
        "flash_bwd_dq": 0, "emb_bwd": 0, "expert_gemm": 0,
        "expert_gemm_wgrad": 0, "moe_gather": 0, "moe_swiglu": 0,
        "moe_swiglu_bwd": 0, "moe_combine": 0, "moe_row_dot": 0,
        "xla_attn_fwd": 0, "xla_attn_bwd": 0}


def test_kernel_wrappers_refuse_cpu_tensors():
    x, y, mask = (torch.tensor(a) for a in _mmd_problem(B=4, masked=0))
    with pytest.raises(ValueError, match="CUDA"):
        cuda_pairwise.mmd_forward_kernel(x, y, mask, (0.1,))
    h = torch.zeros(2, 4)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_bow.bow_forward_kernel(h, torch.zeros(10, 4), torch.zeros(10))
    with pytest.raises(ValueError, match="CUDA"):
        cuda_bow.bow_backward_kernel(
            h, torch.zeros(10, 4), torch.zeros(10), torch.zeros(5, 2),
            torch.zeros(2, 3, dtype=torch.long), torch.zeros(2, 3))


def _view(dtype, offset, stride_pad):
    """A ``[2, 2, 8, 16]`` view with a contiguous last dimension, its first
    element ``offset`` elements into an aligned buffer and its rows
    ``16 + stride_pad`` elements apart."""
    width = 16 + stride_pad
    buf = torch.zeros(2 * 2 * 8 * width + 16, dtype=dtype)
    assert buf.data_ptr() % 16 == 0
    return buf[offset:offset + 2 * 2 * 8 * width].view(2, 2, 8, width)[
        ..., :16]


@pytest.mark.parametrize("dtype,align", [(torch.float32, 4),
                                         (torch.bfloat16, 8)])
@pytest.mark.parametrize("case", ["aligned", "base", "stride"])
def test_flash_views_must_start_rows_on_16_bytes(dtype, align, case):
    """The kernels load 16 bytes at a time (fp32: float4; bf16: cp.async and
    ldmatrix), so every row of a view starts on a 16-byte boundary: 4 fp32
    or 8 bf16 elements, for the base pointer and for each stride. A view
    off by half of that is refused by ``_check_view`` and copied by
    ``_addressable``."""
    half = align // 2
    t = {"aligned": _view(dtype, 0, align), "base": _view(dtype, half, align),
         "stride": _view(dtype, 0, half)}[case]
    like = torch.zeros(2, 2, 8, 16, dtype=dtype)
    assert cuda_attention._row_alignment(t) == align
    if case == "aligned":
        cuda_attention._check_view(t, "t", like)
        assert cuda_attention._addressable(t) is t
    else:
        with pytest.raises(ValueError, match=f"{align}-element boundary"):
            cuda_attention._check_view(t, "t", like)
        copy = cuda_attention._addressable(t)
        assert copy is not t and copy.is_contiguous()
        assert torch.equal(copy, t)
        cuda_attention._check_view(copy, "copy", like)
    # a 4-element boundary is enough for fp32 and not for bf16
    four = _view(dtype, 4, 4)
    assert cuda_attention._rows_aligned(four) == (dtype == torch.float32)



def test_ptxas_report_gives_registers_stack_and_spills():
    """The build keeps nvcc's ``-Xptxas -v`` report; the parser takes each
    kernel's registers, stack frame and spill stores plus loads, and skips
    lines that belong to no kernel."""
    from carel_tpu_torch.ops import native

    name = "_ZN12_GLOBAL__N_115hsic_bwd_kernelILi24EEEvNS_7BwdArgsE"
    log = "\n".join([
        "ptxas info    : 0 bytes gmem",
        f"ptxas info    : Compiling entry function '{name}' for 'sm_90a'",
        f"ptxas info    : Function properties for {name}",
        "    8 bytes stack frame, 16 bytes spill stores, 8 bytes spill loads",
        "ptxas info    : Used 255 registers, used 1 barriers, 8 bytes "
        "cumulative stack size, 416 bytes cmem[0]",
        "ptxas info    : Compiling entry function 'k2' for 'sm_90a'",
        "ptxas info    : Function properties for k2",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 64 registers, used 0 barriers",
    ])
    assert native.ptxas_resources(log) == {name: (255, 8, 24),
                                           "k2": (64, 0, 0)}
