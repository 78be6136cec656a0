"""The hand-written CUDA kernels K1-K4 against their plain PyTorch versions,
on the card. Every test here is marked ``cuda`` and skips without a GPU (the
kernels have no CPU mode). This file imports nothing of JAX, so it also runs
on a GPU machine without JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels.py -q

Tolerances: values rtol 1e-5; grads normwise relative error 1e-5 (MMD) and
1e-4 (BoW), the gates of chip_smoke.py.
"""

import numpy as np
import pytest
import torch

from carel_tpu_torch import ops
from carel_tpu_torch.ops import cuda_bow, cuda_pairwise

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    from carel_tpu_torch.device import resolve_device

    return resolve_device("cuda")


def _relnorm(a, b):
    return float(torch.linalg.vector_norm((a - b).double())
                 / torch.linalg.vector_norm(b.double()))


def _mmd_problem(device, B, masked, d=24, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, d)).astype(np.float32)
    y = (rng.normal(size=(B, d)) * 1.2 + 0.3).astype(np.float32)
    mask = np.ones(B, np.float32)
    mask[B - masked:] = 0.0
    return tuple(torch.tensor(a, device=device) for a in (x, y, mask))


def _bow_problem(device, B=64, D=48, V=23808, T=128, masked=4, seed=1):
    rng = np.random.default_rng(seed)
    h = rng.normal(size=(B, D)).astype(np.float32)
    W = (rng.normal(size=(V, D)) * 0.2).astype(np.float32)
    b = (rng.normal(size=V) * 0.1).astype(np.float32)
    idx = rng.integers(0, V, (B, T)).astype(np.int32)
    idx[:, T // 4:] = -1  # padded nnz slots
    idx[0, 1] = idx[0, 0]  # duplicate index in one row
    wts = np.where(idx >= 0, rng.random((B, T)), 0.0).astype(np.float32)
    wts /= wts.sum(axis=1, keepdims=True)
    mask = np.ones(B, np.float32)
    mask[B - masked:] = 0.0
    return tuple(torch.tensor(a, device=device)
                 for a in (h, W, b, idx, wts, mask))


@pytest.mark.parametrize("B,masked", [(64, 0), (61, 3), (13, 2)])
def test_mmd_kernels_match_plain(cuda, B, masked):
    x, y, mask = _mmd_problem(cuda, B, masked)
    xk, yk = x.clone().requires_grad_(), y.clone().requires_grad_()
    xp, yp = x.clone().requires_grad_(), y.clone().requires_grad_()
    ops.reset_launch_counts()
    vk = cuda_pairwise.mmd_statistic(xk, yk, (0.1,), mask)
    gk = torch.autograd.grad(vk, (xk, yk))
    assert ops.launch_counts()["mmd_fwd"] == 1
    assert ops.launch_counts()["mmd_bwd"] == 1
    vp = cuda_pairwise.mmd_statistic_plain(xp, yp, (0.1,), mask)
    gp = torch.autograd.grad(vp, (xp, yp))
    torch.testing.assert_close(vk, vp, rtol=1e-5, atol=0)
    for a, c in zip(gk, gp):
        assert _relnorm(a, c) <= 1e-5
        if masked:
            assert float(a[-masked:].abs().max()) == 0.0


@pytest.mark.parametrize("V", [23808, 700])
def test_bow_kernels_match_plain(cuda, V):
    h, W, b, idx, wts, mask = _bow_problem(cuda, V=V)
    leaves_k = [t.clone().requires_grad_() for t in (h, W, b)]
    leaves_p = [t.clone().requires_grad_() for t in (h, W, b)]
    ops.reset_launch_counts()
    vk = cuda_bow.fused_bow_loss(*leaves_k, idx, wts, 0.1, mask)
    gk = torch.autograd.grad(vk, leaves_k)
    assert ops.launch_counts()["bow_fwd"] == 1
    assert ops.launch_counts()["bow_bwd"] == 1
    vp = cuda_bow.fused_bow_loss_plain(*leaves_p, idx, wts, 0.1, mask)
    gp = torch.autograd.grad(vp, leaves_p)
    torch.testing.assert_close(vk, vp, rtol=1e-5, atol=0)
    for a, c in zip(gk, gp):
        assert _relnorm(a, c) <= 1e-4


def test_kernels_repeat_bit_for_bit(cuda):
    x, y, mask = _mmd_problem(cuda, 64, 0)
    a = cuda_pairwise.mmd_forward_kernel(x, y, mask, (0.1,))[0]
    b = cuda_pairwise.mmd_forward_kernel(x, y, mask, (0.1,))[0]
    assert torch.equal(a, b)
    h, W, bias, *_ = _bow_problem(cuda)
    assert torch.equal(cuda_bow.bow_forward_kernel(h, W, bias),
                       cuda_bow.bow_forward_kernel(h, W, bias))


def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    x, y, mask = _mmd_problem(cuda, 8, 0)
    with pytest.raises(TypeError):
        cuda_pairwise.mmd_forward_kernel(x.double(), y, mask, (0.1,))
    with pytest.raises(ValueError, match="contiguous"):
        cuda_pairwise.mmd_forward_kernel(x.T.contiguous().T, y, mask, (0.1,))
    with pytest.raises(ValueError, match="shape"):
        cuda_pairwise.mmd_forward_kernel(x, y[:4], mask, (0.1,))
    with pytest.raises(ValueError, match="exceeds"):
        wide = torch.zeros(8, 40, device=cuda)
        cuda_pairwise.mmd_forward_kernel(wide, wide, mask, (0.1,))
    h, W, b, *_ = _bow_problem(cuda, V=100)
    with pytest.raises(ValueError, match="shape"):
        cuda_bow.bow_forward_kernel(h, W, b[:50])
