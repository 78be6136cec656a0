"""The merge arithmetic of the fused BoW forward kernel (K3), on the CPU.

The kernel itself runs only on the card. It cuts the vocabulary V into
contiguous ranges, one per block; a block evaluates its piece of
z = h W^T + b once and writes the range's (max, sum exp(z - max), sum z) per
row; after a grid-wide barrier every block merges the ranges' partials in a
fixed order, in double, into the row's lse; a second sweep over the kept z
writes (sum log1p(-p), sum p/(1-p)) with p = min(exp(z - lse), 1 - 1e-7),
merged the same way. ``_emulated_row_sums`` repeats that decomposition in
plain PyTorch, fp32 where the kernel is fp32 and float64 where it merges.

It is held against the dense row sums of the plain version's z (float64 sums
of the same fp32 logits: lse, S_z, S_log1mp, Qp to rtol 1e-5), and the loss
that ``cuda_bow.loss_from_row_sums`` (the code the CUDA path runs after the
kernel) builds from the emulated sums is held against
``carel_tpu.ops.pallas_bow.fused_bow_loss`` (Pallas in interpret mode) and
against ``fused_bow_loss_plain``, value rtol 1e-5, for 1, 7 and 132 ranges,
V = 1,003 and 23,808, B = 5 and 64. Inputs come from a numpy seed.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from carel_tpu.ops.pallas_bow import fused_bow_loss as j_fused_bow

from carel_tpu_torch.ops import cuda_bow

D, T, LS = 48, 16, 0.1


@functools.lru_cache(maxsize=None)
def _problem(B: int, V: int):
    rng = np.random.default_rng(B + V)
    h = rng.normal(size=(B, D)).astype(np.float32)
    W = (rng.normal(size=(V, D)) / np.sqrt(D)).astype(np.float32)
    b = (rng.normal(size=V) * 0.1).astype(np.float32)
    idx = rng.integers(0, V, (B, T)).astype(np.int32)
    idx[:, T // 2:] = -1  # padded nnz slots
    idx[0, 1] = idx[0, 0]  # a duplicate index
    wts = np.where(idx >= 0, rng.random((B, T)), 0.0).astype(np.float32)
    wts /= wts.sum(axis=1, keepdims=True)
    mask = np.ones(B, np.float32)
    mask[-1] = 0.0
    return h, W, b, idx, wts, mask


@functools.lru_cache(maxsize=None)
def _jax_loss(B: int, V: int) -> float:
    h, W, b, idx, wts, mask = _problem(B, V)
    return float(j_fused_bow(jnp.asarray(h), jnp.asarray(W.T), jnp.asarray(b),
                             jnp.asarray(idx), jnp.asarray(wts), LS,
                             jnp.asarray(mask)))


def _logits(h, W, b) -> torch.Tensor:
    """z as the plain version forms it, fp32."""
    return torch.tensor(h) @ torch.tensor(W).T + torch.tensor(b)


def _emulated_row_sums(z: torch.Tensor, ranges: int) -> torch.Tensor:
    """[4, B] = lse, S_z, S_log1mp, Qp from fp32 logits ``z`` [B, V] by the
    kernel's decomposition over ``ranges`` contiguous ranges of V."""
    V = z.shape[1]
    cols = -(-V // ranges)
    pieces = [z[:, v0:v0 + cols] for v0 in range(0, V, cols)]
    # sweep 1: per range, fp32
    m = torch.stack([p.amax(1) for p in pieces])  # [ranges, B]
    se = torch.stack([torch.exp(p - p.amax(1, keepdim=True)).sum(1)
                      for p in pieces])
    sz = torch.stack([p.sum(1) for p in pieces])
    # the merge, in double, ranges in order
    top = m.amax(0)
    total = (se.double() * torch.exp(m.double() - top.double())).sum(0)
    lse = top + torch.log(total).float()
    S_z = sz.double().sum(0).float()
    # sweep 2 over the kept z: per range in fp32, merged in double
    s1, s2 = [], []
    for p in pieces:
        prob = torch.clamp(torch.exp(p - lse[:, None]), max=cuda_bow.P_MAX)
        s1.append(torch.log1p(-prob).sum(1))
        s2.append((prob / (1.0 - prob)).sum(1))
    S_log1mp = torch.stack(s1).double().sum(0).float()
    Qp = torch.stack(s2).double().sum(0).float()
    return torch.stack([lse, S_z, S_log1mp, Qp])


@pytest.mark.parametrize("B", [5, 64])
@pytest.mark.parametrize("V", [1003, 23808])
@pytest.mark.parametrize("ranges", [1, 7, 132])
def test_emulated_row_sums_match_the_dense_sums(ranges, V, B):
    h, W, b, *_ = _problem(B, V)
    z = _logits(h, W, b)
    got = _emulated_row_sums(z, ranges).double()
    zd = z.double()
    lse = torch.logsumexp(zd, 1)
    p = torch.clamp(torch.exp(zd - lse[:, None]), max=cuda_bow.P_MAX)
    want = torch.stack([lse, zd.sum(1), torch.log1p(-p).sum(1),
                        (p / (1.0 - p)).sum(1)])
    # S_z is a sum of both signs: its error is held against sum |z|
    scale = torch.stack([lse.abs(), zd.abs().sum(1), want[2].abs(),
                         want[3].abs()])
    assert float(((got - want).abs() / scale).max()) <= 1e-5
    torch.testing.assert_close(got[0], want[0], rtol=1e-6, atol=0)


@pytest.mark.parametrize("B", [5, 64])
@pytest.mark.parametrize("V", [1003, 23808])
@pytest.mark.parametrize("ranges", [1, 7, 132])
def test_loss_from_emulated_row_sums_matches_jax(ranges, V, B):
    h, W, b, idx, wts, mask = _problem(B, V)
    stats = _emulated_row_sums(_logits(h, W, b), ranges)
    args = [torch.tensor(a) for a in (h, W, b, idx, wts, mask)]
    got, _ = cuda_bow.loss_from_row_sums(stats, *args, LS)
    plain = cuda_bow.fused_bow_loss_plain(*args[:5], LS, args[5])
    np.testing.assert_allclose(float(got), float(plain), rtol=1e-5)
    np.testing.assert_allclose(float(got), _jax_loss(B, V), rtol=1e-5)
