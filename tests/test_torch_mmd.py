"""The arithmetic of the MMD kernels K1 (forward) and K2 (backward), on the
CPU.

The kernels run only on the card. K1 cuts the rows into tiles of
``cuda_pairwise.MMD_TILE_ROWS`` and gives each pair of tiles (ti <= tj) to a
block: the xy pairs of (ti, tj) and, off the diagonal, of (tj, ti); the xx
and yy pairs of (ti, tj), only j > i inside a diagonal tile, so that their
sums cover the upper triangle and are doubled at the end. d2 comes from each
row's squared norm, formed once, and a dot product. Thread (i, j) of a
block (tile^2 threads) takes pair (i, j) of each of the four products and
sums them in double; the block adds its threads by an xor butterfly in each
warp and the warps in order; the last block adds the blocks' partials
thread-strided and then the same way. K2 gives each output row (rows of dx,
then of dy) to a warp whose lanes stride over j, each lane summing its terms
in fp32, and adds the lanes by recursive halving, which has the bits of an
xor butterfly per coordinate.
``_emulated_mmd`` and ``_emulated_mmd_grad`` repeat those decompositions in
plain PyTorch, fp32 where the kernels are fp32 and float64 where they sum in
double.

Both are held against ``carel_tpu.ops.pallas_pairwise.mmd_pallas`` (Pallas
in interpret mode on the CPU, fp32), ``carel_tpu.ops.pairwise.mmd_statistic``
and the port's plain version (fp32): value rtol 1e-5; grads normwise 1e-5 and
elementwise rtol 1e-5 with an atol of 1e-6 of the largest entry; masked rows
get exactly zero gradient. B in {2, 13, 61, 64, 257, 1000} with masked rows,
one alpha (the presets' 0.1) and four (the kernels' most), K1's tile rows and
tiles of one row (one thread a block, so the last block adds the partials
in index order). Inputs come from a numpy seed.

JAX's XLA formula runs in float64 (x64 on, its float32 casts read as
float64). In fp32 it subtracts the Gram diagonal (about one per alpha and
row) from the sum of the whole Gram, and that cancellation puts it 5.1e-5
from its own float64 value at B = 13 with four alphas, where the emulated
kernel arithmetic is 5e-9 from it; the other fp32 references stay within
4.6e-6 of it at every shape here.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from carel_tpu.ops import pairwise as j_pairwise
from carel_tpu.ops.pallas_pairwise import mmd_pallas

from carel_tpu_torch.ops import cuda_pairwise

D = 24
EPS = 1e-5
LANES = 32
ALPHAS = {"one": (0.1,), "four": (0.1, 0.5, 1.0, 2.0)}
MASKED = {2: 0, 13: 2, 61: 3, 64: 4, 257: 5, 1000: 7}


@functools.lru_cache(maxsize=None)
def _problem(B: int):
    rng = np.random.default_rng(B)
    x = rng.normal(size=(B, D)).astype(np.float32)
    y = (rng.normal(size=(B, D)) * 1.2 + 0.3).astype(np.float32)
    mask = np.ones(B, np.float32)
    if MASKED[B]:
        mask[-MASKED[B]:] = 0.0
    return x, y, mask


def _butterfly(v: torch.Tensor) -> torch.Tensor:
    """The sum over the last dimension (a power of two, at most 32 lanes) by
    the xor butterfly of ``__shfl_xor_sync`` (offsets 16, 8, 4, 2, 1), as
    lane 0 forms it. Lanes past the last dimension would hold 0, and adding
    0 to a sum leaves its bits, so a shorter butterfly is the same sum."""
    o = v.shape[-1] // 2
    while o:
        v = v[..., :o] + v[..., o:2 * o]
        o //= 2
    return v[..., 0]


def _block_sum(v: torch.Tensor) -> torch.Tensor:
    """K1's block_sum over the last dimension, the block's threads in order
    (threads past it hold 0): a butterfly in each warp, then the warps in
    order."""
    t = v.shape[-1]
    lanes = LANES if t >= LANES else 1 << (t - 1).bit_length()
    v = torch.nn.functional.pad(v, (0, -t % lanes))
    warps = _butterfly(v.reshape(*v.shape[:-1], -1, lanes))
    total = torch.zeros(warps.shape[:-1], dtype=warps.dtype)
    for w in range(warps.shape[-1]):
        total = total + warps[..., w]
    return total


def _rbf(d2: torch.Tensor, alphas) -> torch.Tensor:
    pd2 = EPS + d2.abs()
    k = torch.zeros_like(pd2)
    for a in alphas:
        k = k + torch.exp(-a * pd2)
    return k


def _drbf(d2: torch.Tensor, alphas) -> torch.Tensor:
    pd2 = EPS + d2.abs()
    c = torch.zeros_like(pd2)
    for a in alphas:
        c = c + (-a) * torch.exp(-a * pd2)
    return c * torch.sign(d2)


def _emulated_mmd(x, y, mask, alphas, tile: int) -> float:
    """MMD^2 by K1's decomposition with tiles of ``tile`` rows."""
    B = x.shape[0]
    nt = -(-B // tile)
    pad = nt * tile - B
    xs = torch.nn.functional.pad(x, (0, 0, 0, pad)).view(nt, tile, -1)
    ys = torch.nn.functional.pad(y, (0, 0, 0, pad)).view(nt, tile, -1)
    ms = torch.nn.functional.pad(mask, (0, pad)).view(nt, tile)
    nx, ny = (xs * xs).sum(-1), (ys * ys).sum(-1)  # each row's norm, once
    ti, tj = (torch.tensor(t) for t in zip(
        *[(a, b) for a in range(nt) for b in range(a, nt)]))  # block order
    diag = (ti == tj)[:, None, None]

    def pairs(A, nA, mA, ta, C, nC, mC, tc):
        # [blocks, tile (i), tile (j)]: k(A_i, C_j) m_i m_j in fp32
        d2 = nA[ta][:, :, None] + nC[tc][:, None, :] \
            - 2.0 * (A[ta] @ C[tc].transpose(1, 2))
        return _rbf(d2, alphas) * (mA[ta][:, :, None] * mC[tc][:, None, :])

    upper = torch.triu(torch.ones(tile, tile, dtype=torch.bool), 1)
    xy1 = pairs(xs, nx, ms, ti, ys, ny, ms, tj)
    xy2 = torch.where(diag, 0.0, pairs(xs, nx, ms, tj, ys, ny, ms, ti))
    xx = torch.where(diag & ~upper, 0.0, pairs(xs, nx, ms, ti, xs, nx, ms, tj))
    yy = torch.where(diag & ~upper, 0.0, pairs(ys, ny, ms, ti, ys, ny, ms, tj))

    # a block has tile^2 threads; thread j * tile + i takes the pairs (i, j)
    threads = tile * tile
    blocks = len(ti)

    def thread_sums(*subs):
        acc = torch.zeros(blocks, tile, tile, dtype=torch.float64)
        for sub in subs:
            acc += sub.transpose(1, 2).double()
        return acc.reshape(blocks, threads)

    parts = torch.stack([_block_sum(thread_sums(xy1, xy2)),
                         _block_sum(thread_sums(xx)),
                         _block_sum(thread_sums(yy))], 1)  # [blocks, 3]
    # the last block: thread t adds blocks t, t + threads, ... in order (a
    # cumulative sum runs in order; the zeros padded at the end add nothing)
    rounds = -(-blocks // threads)
    strided = torch.nn.functional.pad(parts.T, (0, rounds * threads - blocks))
    strided = strided.view(3, rounds, threads).cumsum(1)[:, -1]
    s_xy, s_xx, s_yy = _block_sum(strided[:, :min(blocks, threads)]).tolist()
    n = float(mask.double().sum())
    a00, a01 = 1.0 / (n * (n - 1.0)), -1.0 / (n * n)
    return float(np.float32(2.0 * a01 * s_xy + a00 * (2.0 * s_xx)
                            + a00 * (2.0 * s_yy)))


def _emulated_mmd_grad(x, y, mask, alphas, g: float = 1.0):
    """(dx, dy) of g * MMD^2 by K2's decomposition: one warp per output
    row, lane l taking j = l, l + 32, ... in fp32, then the butterfly."""
    B, d = x.shape
    n = mask.sum()
    a00, a01 = 1.0 / (n * (n - 1.0)), -1.0 / (n * n)
    w_cross, w_self = g * 2.0 * a01, g * a00
    nx, ny = (x * x).sum(1), (y * y).sum(1)
    own = torch.cat([x, y])                   # [2B, d]: rows of dx, then dy
    n_own = torch.cat([nx, ny])
    half = torch.arange(2 * B) // B           # 0: a dx row, 1: a dy row
    r = torch.arange(2 * B) % B
    m_own = mask[r]
    acc = torch.zeros(2 * B, LANES, d)
    for j0 in range(0, B, LANES):
        js = torch.arange(j0, min(j0 + LANES, B))
        L = len(js)
        # the rows j of the other sample and of the own sample, per row q
        cj = torch.where(half[:, None, None] == 0, y[js][None], x[js][None])
        ncj = torch.where(half[:, None] == 0, ny[js][None], nx[js][None])
        sj = torch.where(half[:, None, None] == 0, x[js][None], y[js][None])
        nsj = torch.where(half[:, None] == 0, nx[js][None], ny[js][None])
        mm = m_own[:, None] * mask[js][None]
        o = own[:, None, :]
        d2c = n_own[:, None] + ncj - 2.0 * (o * cj).sum(-1)
        cc = 2.0 * w_cross * _drbf(d2c, alphas) * mm
        acc[:, :L] += cc[..., None] * (o - cj)
        d2s = n_own[:, None] + nsj - 2.0 * (o * sj).sum(-1)
        cs = 4.0 * w_self * _drbf(d2s, alphas) * mm
        cs = torch.where(js[None] == r[:, None], 0.0, cs)  # j != r only
        acc[:, :L] += cs[..., None] * (o - sj)
    grad = _butterfly(acc.transpose(1, 2))  # [2B, d]
    return grad[:B], grad[B:]


class _Float64Numpy:
    """jax.numpy with ``float32`` read as ``float64``: JAX's XLA MMD casts
    its inputs and mask to float32, and this lets its formula run in float64
    without a change to it."""

    float32 = jnp.float64

    def __getattr__(self, name):
        return getattr(jnp, name)


@functools.lru_cache(maxsize=None)
def _jax_reference(B: int, alphas, impl: str):
    """(value, dx, dy) of JAX's MMD: the Pallas kernel in interpret mode in
    fp32, or the XLA formula in float64."""
    x, y, mask = _problem(B)
    if impl == "pallas":
        val, (dx, dy) = jax.value_and_grad(
            lambda a, b: mmd_pallas(a, b, alphas, jnp.asarray(mask)),
            argnums=(0, 1))(x, y)
        return float(val), np.asarray(dx), np.asarray(dy)
    x, y, mask = (a.astype(np.float64) for a in (x, y, mask))
    with pytest.MonkeyPatch.context() as mp, jax.enable_x64(True):
        mp.setattr(j_pairwise, "jnp", _Float64Numpy())
        val, (dx, dy) = jax.value_and_grad(
            lambda a, b: j_pairwise.mmd_statistic(a, b, alphas,
                                                  mask=jnp.asarray(mask)),
            argnums=(0, 1))(jnp.asarray(x), jnp.asarray(y))
        assert dx.dtype == np.float64
        return float(val), np.asarray(dx), np.asarray(dy)


@functools.lru_cache(maxsize=None)
def _plain_reference(B: int, alphas):
    x, y, mask = (torch.tensor(a) for a in _problem(B))
    xp, yp = x.clone().requires_grad_(), y.clone().requires_grad_()
    val = cuda_pairwise.mmd_statistic_plain(xp, yp, alphas, mask)
    dx, dy = torch.autograd.grad(val, (xp, yp))
    return float(val.detach()), dx.numpy(), dy.numpy()


def _references(B: int, alphas):
    return {"pallas": _jax_reference(B, alphas, "pallas"),
            "xla": _jax_reference(B, alphas, "xla"),
            "plain": _plain_reference(B, alphas)}


@pytest.mark.parametrize("tile", [1, cuda_pairwise.MMD_TILE_ROWS])
@pytest.mark.parametrize("alphas", sorted(ALPHAS))
@pytest.mark.parametrize("B", sorted(MASKED))
def test_emulated_forward_matches_the_references(B, alphas, tile):
    al = ALPHAS[alphas]
    x, y, mask = (torch.tensor(a) for a in _problem(B))
    got = _emulated_mmd(x, y, mask, al, tile)
    for name, (want, _, _) in _references(B, al).items():
        assert abs(got - want) <= 1e-5 * abs(want), name


@pytest.mark.parametrize("alphas", sorted(ALPHAS))
@pytest.mark.parametrize("B", sorted(MASKED))
def test_emulated_backward_matches_the_references(B, alphas):
    al = ALPHAS[alphas]
    x, y, mask = (torch.tensor(a) for a in _problem(B))
    got = [t.numpy() for t in _emulated_mmd_grad(x, y, mask, al)]
    for name, (_, *want) in _references(B, al).items():
        for u, w in zip(got, want):
            assert np.linalg.norm(u - w) <= 1e-5 * np.linalg.norm(w), name
            np.testing.assert_allclose(u, w, rtol=1e-5,
                                       atol=1e-6 * np.abs(w).max(),
                                       err_msg=name)
    masked = MASKED[B]
    if masked:
        assert not got[0][-masked:].any() and not got[1][-masked:].any()


def test_k1_blocks_cover_every_pair_once():
    """K1's blocks, as the emulation enumerates them, take each xy pair
    once and each unordered xx (and yy) pair once, for ragged B."""
    tile = cuda_pairwise.MMD_TILE_ROWS
    for B in (1, 2, 15, 16, 17, 63, 65, 1000):
        nt = -(-B // tile)
        xy = np.zeros((nt * tile, nt * tile), np.int64)
        xx = np.zeros_like(xy)
        for ti in range(nt):
            for tj in range(ti, nt):
                rows_i = np.arange(ti * tile, (ti + 1) * tile)
                rows_j = np.arange(tj * tile, (tj + 1) * tile)
                xy[np.ix_(rows_i, rows_j)] += 1
                if ti != tj:
                    xy[np.ix_(rows_j, rows_i)] += 1
                block = np.ones((tile, tile), np.int64)
                if ti == tj:
                    block = np.triu(block, 1)
                xx[np.ix_(rows_i, rows_j)] += block
        assert (xy[:B, :B] == 1).all()
        assert (xx[:B, :B] + xx[:B, :B].T == 1 - np.eye(B, dtype=np.int64)
                ).all()
