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

K4 adds the backward's corrections at the bag-of-words indices to G itself,
row by row in a fixed order: an emulation of that fold and of the products
that follow is held against the index_add_ and the product they replace.
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


def _fold_corrections(G, idx, corr, v0=0):
    """K4's corrections in plain PyTorch: for each row of the piece G
    [rows, cols] of columns v0.., the row's entries whose index falls in
    the piece added to G one at a time, t ascending (fp32)."""
    G = G.clone()
    for r in range(G.shape[0]):
        for t in range(idx.shape[1]):
            c = int(idx[r, t]) - v0
            if 0 <= c < G.shape[1]:
                G[r, c] += corr[r, t]
    return G


# few words (many repeats, in a row too) and many; V cut into pieces of
# 64 columns, as K4's blocks cut it, or kept whole
@pytest.mark.parametrize("words,cols", [(5, 300), (300, 300), (5, 64),
                                        (300, 64)])
def test_corrections_folded_into_g_match_index_add(words, cols):
    """The corrections at the BoW indices added to G (K4's order: each
    block's piece, row by row, t ascending), then dW = G^T h, db = the
    column sums and dh = G W, equal the dense products plus the index_add_
    and the batched product of the corrections that they replace, within
    fp32 rounding (rtol 1e-6 normwise)."""
    V, B = 300, 6
    rng = np.random.default_rng(words + cols)
    idx = rng.integers(0, words, (B, T))
    idx[:, T // 2:] = -1
    idx[0, 1] = idx[0, 0]  # an index twice in a row
    idx = torch.tensor(idx)
    valid = idx >= 0
    safe = torch.where(valid, idx, 0)
    corr = torch.where(valid, torch.tensor(rng.normal(size=(B, T)),
                                           dtype=torch.float32), 0.0)
    h = torch.tensor(rng.normal(size=(B, D)), dtype=torch.float32)
    W = torch.tensor(rng.normal(size=(V, D)), dtype=torch.float32)
    G = torch.tensor(rng.normal(size=(B, V)) * 1e-3, dtype=torch.float32)
    folded = torch.cat([_fold_corrections(G[:, v0:v0 + cols], safe, corr, v0)
                        for v0 in range(0, V, cols)], dim=1)
    got = (folded.T @ h, folded.sum(0), folded @ W)
    flat = safe.reshape(-1)
    want = (
        (G.T @ h).index_add_(0, flat, (corr[:, :, None] * h[:, None, :])
                             .reshape(-1, D)),
        G.sum(0).index_add_(0, flat, corr.reshape(-1)),
        G @ W + torch.einsum("bt,btd->bd", corr, W[safe]))
    for a, c in zip(got, want):
        assert float(torch.linalg.vector_norm(a - c)
                     / torch.linalg.vector_norm(c)) <= 1e-6
