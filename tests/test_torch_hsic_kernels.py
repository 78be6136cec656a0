"""The arithmetic of the HSIC backward kernel K6, on the CPU.

K6 runs only on the card. It gives each output row to a warp (rows of dx,
then of dy: warp q takes row q mod B of dx if q < B, else of dy). With the
residuals of K5 (the row sums of both masked Grams, n and their totals) the
warp rebuilds its row of the centred other Gram: lane l takes j = l, l + 32,
... in order (the rows pass through shared memory in chunks of 64, a
multiple of 32, which leaves that order as it is), skips a masked j, forms
both squared distances sum_k (a_k - b_k)^2 of (i, j) in double and adds
W_ij (z_i - z_j) into its d accumulators, W_ij = center(Other)_ij Self_ij
with the centred entry formed explicitly from the row sums and the total
times 1 / n. The warp then merges its lanes by recursive halving: at
offset 16, 8, 4, 2, 1 a lane keeps half of its values, the upper half if
that bit of its lane is set, and adds its partner's copy, so that lane k
ends with coordinate k (for d <= 16, R = 8 or 16 values a lane, zero past
d, and lane k * 32 / R ends with coordinate k). The row is scaled by
-4 g / (s (n - 1)^2) and rounded to fp32; a masked row gets exactly 0.

``_emulated_hsic_grad`` repeats that cut of the work in float64 PyTorch
(K5's residuals as plain float64 sums) and is held, before the final
rounding to fp32, against three float64 references on the same fp32 inputs:
JAX's ``hsic_pallas`` in interpret mode and ``carel_tpu.ops.pairwise.hsic``,
both with x64 on and their float32 casts read as float64 (as
tests/test_torch_hsic.py runs them), and the port's plain version in
float64; and against the same function in numpy's extended precision.
Tolerance: normwise relative error 1e-10 on dx and dy, masked rows exactly
0; at both input scales (0.2, and 0.002 where K and L are nearly all ones),
s_x != s_y and g = 0.5, at B in {2, 13, 61 with 3 masked rows, 64, 1,000
with 7}; and at d of 1, 8, 13, 17 and 32 (K6 is instantiated for rows of 8,
16, 24 and 32 coordinates, and merges 8, 16 or 32 values a lane), at B = 61
and 64, against the plain version and the extended-precision value (with
an allowance for d = 1 and tight latents, given with that test). Inputs
come from a numpy seed.

With tight latents the float64 evaluations lose digits to cancellation, in
amounts that differ between formulas. Against the extended-precision value,
at B = 1,000: the emulation 5.6e-11 (dy), JAX's Pallas formula 7.9e-13 (it
centres the centred Gram a second time, which removes the rounding of the
first centring's row terms), JAX's XLA formula 1.0e-10 and the port's plain
version 1.1e-10 (both centre by products with H). So the comparison with a
reference allows 1e-10 plus that reference's own distance from the
extended-precision value; the emulation's own distance from it is held at
1e-10 by itself.

The merge itself is checked to give, bit for bit, the sum of an xor
butterfly of each value, which is what makes the gradients repeat bit for
bit on the card.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import carel_tpu.ops.pairwise as j_pairwise
import carel_tpu.ops.pallas_pairwise as j_pallas_pairwise
from carel_tpu.ops.pairwise import hsic as j_hsic
from carel_tpu.ops.pallas_pairwise import hsic_pallas

from carel_tpu_torch.ops import cuda_pairwise

D = 24
LANES = 32
S_X, S_Y = 1.0, 0.7
G = 0.5
SCALES = {"spread": 0.2, "tight": 0.2e-2}
MASKED = {2: 0, 13: 0, 61: 3, 64: 0, 1000: 7}


@functools.lru_cache(maxsize=None)
def _problem(B: int, scale: str, d: int = D):
    """fp32 latents (what the kernel reads), as float64 arrays."""
    rng = np.random.default_rng(B)
    s = SCALES[scale]
    x = (rng.normal(size=(B, d)) * s).astype(np.float32)
    y = (rng.normal(size=(B, d)) * 1.3 * s + 0.1 * s).astype(np.float32)
    mask = np.ones(B, np.float32)
    if MASKED[B]:
        mask[-MASKED[B]:] = 0.0
    return tuple(a.astype(np.float64) for a in (x, y, mask))


def _butterfly(v: torch.Tensor) -> torch.Tensor:
    """The sum over the last dimension (32 lanes) by the xor butterfly of
    ``__shfl_xor_sync`` (offsets 16, 8, 4, 2, 1), as lane 0 forms it."""
    o = v.shape[-1] // 2
    while o:
        v = v[..., :o] + v[..., o:2 * o]
        o //= 2
    return v[..., 0]


def _reduce_scatter(v: torch.Tensor) -> torch.Tensor:
    """K6's merge of v [..., 32 lanes, R values] (R a power of two, at most
    32), shuffle by shuffle: returns [..., 32], what lane l ends with, the
    sum of value l // (32 // R)."""
    lane = torch.arange(LANES)
    r = v.shape[-1]
    o = LANES // 2
    while o:
        partner = lane ^ o
        if r > 1:
            upper = ((lane & o) != 0)[:, None]
            lo, hi = v[..., :r // 2], v[..., r // 2:]
            send = torch.where(upper, lo, hi)
            keep = torch.where(upper, hi, lo)
            v = keep + send[..., partner, :]
            r //= 2
        else:
            v = v + v[..., partner, :]
        o //= 2
    return v[..., 0]


def _gram(a: torch.Tensor, b: torch.Tensor, inv_s: float) -> torch.Tensor:
    """exp(-sum_k (a_k - b_k)^2 / s) over the last dimension, in float64."""
    t = a - b
    return torch.exp(-(t * t).sum(-1) * inv_s)


def _centred(g, mi, mj, ri, rj, tot, inv_n):
    """The centred entry, formed explicitly as the kernel forms it, with the
    row sums and the total times 1 / n."""
    return g - mi * (rj * inv_n) - (ri * inv_n) * mj \
        + (mi * mj) * (tot * inv_n * inv_n)


def _emulated_hsic_grad(x, y, mask, g: float = G):
    """(dx, dy) of g * HSIC by K6's cut of the work, in float64 and before
    the final rounding to fp32."""
    B, d = x.shape
    inv = (1.0 / S_X, 1.0 / S_Y)
    # K5's residuals: the row sums of the masked Grams, n and the totals
    mm = mask[:, None] * mask[None, :]
    rK = (_gram(x[:, None], x[None], inv[0]) * mm).sum(1)
    rL = (_gram(y[:, None], y[None], inv[1]) * mm).sum(1)
    n = mask.sum()
    # warp q: row q % B of dx (q < B) or of dy
    side = torch.arange(2 * B) // B
    i = torch.arange(2 * B) % B
    on_y = (side == 1)[:, None]
    zi = torch.where(on_y, y[i], x[i])      # [2B, d]: this sample's row i
    oi = torch.where(on_y, x[i], y[i])      # the other sample's row i
    inv_self = torch.tensor(inv, dtype=torch.float64)[side]
    inv_other = torch.tensor(inv, dtype=torch.float64)[1 - side]
    r_other = torch.where(on_y, rK[None], rL[None])   # [2B, B]
    tot_other = torch.where(side == 1, rK.sum(), rL.sum())
    mi = mask[i]
    ri = r_other[torch.arange(2 * B), i]
    acc = torch.zeros(2 * B, LANES, d, dtype=torch.float64)
    for j0 in range(0, B, LANES):  # lane l takes j = j0 + l, in order
        js = torch.arange(j0, min(j0 + LANES, B))
        L = len(js)
        zj = torch.where(on_y[:, :, None], y[js][None], x[js][None])
        oj = torch.where(on_y[:, :, None], x[js][None], y[js][None])
        t = zi[:, None] - zj                 # [2B, L, d]
        u = oi[:, None] - oj
        mj = mask[js][None]
        pm = mi[:, None] * mj
        kij = torch.exp(-(t * t).sum(-1) * inv_self[:, None]) * pm
        oij = torch.exp(-(u * u).sum(-1) * inv_other[:, None]) * pm
        w = _centred(oij, mi[:, None], mj, ri[:, None], r_other[:, js],
                     tot_other[:, None], 1.0 / n) * kij
        w = torch.where(mj == 0.0, 0.0, w)  # a masked j is skipped
        acc[:, :L] += w[..., None] * t
    # R values a lane (d rounded up to 8, 16 or 32), zero past d; lane
    # k * 32 / R ends with coordinate k
    R = 8 if d <= 8 else (16 if d <= 16 else LANES)
    merged = _reduce_scatter(torch.nn.functional.pad(acc, (0, R - d)))
    merged = merged[:, ::LANES // R][:, :d]
    scale = -4.0 * inv_self * g / ((n - 1.0) * (n - 1.0))
    grad = torch.where(mi[:, None] != 0.0, merged * scale[:, None], 0.0)
    return grad[:B], grad[B:]


class _Float64Numpy:
    """jax.numpy with ``float32`` read as ``float64``: the JAX HSIC modules
    cast their inputs, mask and products to float32, and this lets their
    formulas run in float64 without a change to them."""

    float32 = jnp.float64

    def __getattr__(self, name):
        return getattr(jnp, name)


@functools.lru_cache(maxsize=None)
def _reference(B: int, scale: str, impl: str, d: int = D):
    """(dx, dy) of G * HSIC in float64: JAX's Pallas kernel (interpret
    mode) or XLA formula, or the port's plain version."""
    x, y, mask = _problem(B, scale, d)
    if impl == "plain":
        a, b = (torch.tensor(t, requires_grad=True) for t in (x, y))
        val = cuda_pairwise.hsic_plain(a, b, S_X, S_Y, torch.tensor(mask))
        return tuple(t.numpy() for t in torch.autograd.grad(G * val, (a, b)))

    def fn(a, b):
        if impl == "pallas":
            return G * hsic_pallas(a, b, S_X, S_Y, jnp.asarray(mask))
        return G * j_hsic(a, b, S_X, S_Y, mask=jnp.asarray(mask))

    with pytest.MonkeyPatch.context() as mp, jax.enable_x64(True):
        for module in (j_pairwise, j_pallas_pairwise):
            mp.setattr(module, "jnp", _Float64Numpy())
        dx, dy = jax.grad(fn, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(y))
        assert dx.dtype == np.float64
        return np.asarray(dx), np.asarray(dy)


@functools.lru_cache(maxsize=None)
def _extended(B: int, scale: str, d: int = D):
    """(dx, dy) of G * HSIC in numpy's extended precision (a 64-bit
    significand or more), by the explicit centring and
    dz_i = c (z_i sum_j W_ij - (W z)_i): the yardstick of the float64
    evaluations."""
    assert np.finfo(np.longdouble).eps < 1e-18
    x, y, m = (np.asarray(a, np.longdouble) for a in _problem(B, scale, d))
    n = m.sum()
    mm = m[:, None] * m[None, :]

    def gram(z, s):
        d2 = np.stack([((z[i] - z) ** 2).sum(1) for i in range(B)])
        return np.exp(-d2 / np.longdouble(s)) * mm

    def centred(A):
        r = A.sum(1)
        return (A - m[:, None] * r[None, :] / n - r[:, None] * m[None, :] / n
                + mm * (A.sum() / (n * n)))

    K, L = gram(x, S_X), gram(y, S_Y)
    c = -4 * np.longdouble(G) / ((n - 1) ** 2)
    out = []
    for z, W, s in ((x, centred(L) * K, S_X), (y, centred(K) * L, S_Y)):
        out.append(c / np.longdouble(s) * (z * W.sum(1)[:, None] - W @ z))
    return tuple(out)


@functools.lru_cache(maxsize=None)
def _emulated(B: int, scale: str, d: int = D):
    x, y, mask = (torch.tensor(a) for a in _problem(B, scale, d))
    return tuple(t.numpy() for t in _emulated_hsic_grad(x, y, mask))


def _relnorm(got, want) -> float:
    got, want = (np.asarray(a, np.longdouble) for a in (got, want))
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


@pytest.mark.parametrize("scale", sorted(SCALES))
@pytest.mark.parametrize("B", sorted(MASKED))
def test_emulated_k6_matches_extended_precision(B, scale):
    got = _emulated(B, scale)
    for u, w in zip(got, _extended(B, scale)):
        assert _relnorm(u, w) <= 1e-10
        if MASKED[B]:
            assert not u[-MASKED[B]:].any()


@pytest.mark.parametrize("impl", ["pallas", "xla", "plain"])
@pytest.mark.parametrize("scale", sorted(SCALES))
@pytest.mark.parametrize("B", sorted(MASKED))
def test_emulated_k6_matches_the_references(B, scale, impl):
    """1e-10, plus the reference's own distance from the extended-precision
    value: with tight latents at B = 1,000 the float64 XLA formula and the
    port's plain version are 1.0e-10 and 1.1e-10 from it, and no float64
    evaluation could come closer to them than that allows."""
    got = _emulated(B, scale)
    for u, w, e in zip(got, _reference(B, scale, impl), _extended(B, scale)):
        assert _relnorm(u, w) <= 1e-10 + _relnorm(w, e)
        if MASKED[B]:
            assert not u[-MASKED[B]:].any()
            assert not w[-MASKED[B]:].any()


@pytest.mark.parametrize("scale", sorted(SCALES))
@pytest.mark.parametrize("B", [61, 64])
@pytest.mark.parametrize("d", [1, 8, 13, 17, 32])
def test_emulated_k6_at_every_width(d, B, scale):
    """K6's instances for rows of 8, 16 and 32 coordinates merge 8, 16 and
    32 values a lane. At d of 1, 8, 13, 17 and 32 the emulation is held
    against the extended-precision value within 1e-10 plus twice the
    distance of the port's plain version in float64 from it, and against
    that plain version within 1e-10 plus three times it. The allowance is
    for d = 1 with tight latents, where every float64 evaluation loses
    digits to cancellation: at B = 64 the plain version is 2.8e-10 (dx) and
    7.4e-10 (dy) from the extended-precision value, the emulation 6.0e-10
    and 1.1e-9; from d = 8 on both stay under 1e-10 at either scale."""
    got = _emulated(B, scale, d)
    for u, w, e in zip(got, _reference(B, scale, "plain", d),
                       _extended(B, scale, d)):
        own = _relnorm(w, e)
        assert _relnorm(u, e) <= 1e-10 + 2 * own
        assert _relnorm(u, w) <= 1e-10 + 3 * own
        if d > 1:
            assert _relnorm(u, e) <= 1e-10
        if MASKED[B]:
            assert not u[-MASKED[B]:].any()


@pytest.mark.parametrize("R", [8, 16, 32])
def test_merge_gives_the_bits_of_a_butterfly(R):
    """Lane l ends with value l // (32 // R), summed bit for bit as the xor
    butterfly of that value alone would sum it (float addition commutes, and
    the pairs of lanes meet in the same tree)."""
    rng = np.random.default_rng(R)
    v = torch.tensor(rng.normal(size=(5, LANES, R)) * 10.0 ** rng.integers(
        -8, 8, size=(5, LANES, R)))
    got = _reduce_scatter(v)
    e = torch.arange(LANES) // (LANES // R)
    want = _butterfly(v.transpose(1, 2))[:, e]  # [5, 32]
    assert torch.equal(got, want)
