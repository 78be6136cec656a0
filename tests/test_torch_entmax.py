"""The port's sparsemax and entmax15 (carel_tpu_torch/ops/entmax.py)
against the JAX package's (carel_tpu/ops/entmax.py), and the properties and
finite-difference checks of the JAX package's own tests
(tests/test_ops.py), parametrised over both functions.

Inputs are numpy draws from fixed seeds, with masked positions (-1e9, as the
sparse adapters mask their scores) and ties. Tolerance: 1e-6 abs on the
forward and the VJP (both sides compute in fp32 with the same steps; the
cumulative sums may run in another order). An all-masked row (a padded
batch row) is the one place the port departs from JAX: sparsemax gives it
weight 0 where JAX gives inf; entmax15 gives both uniform weights."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from carel_tpu.ops.entmax import entmax15 as j_entmax15
from carel_tpu.ops.entmax import sparsemax as j_sparsemax

from carel_tpu_torch.ops.entmax import entmax15, sparsemax

FNS = {"sparsemax": (sparsemax, j_sparsemax),
       "entmax15": (entmax15, j_entmax15)}


def _scores(seed: int, rows: int = 12, n: int = 24, scale: float = 3.0):
    """Random score rows with masked tails of several lengths (one row
    without a mask) and ties: repeated values, a constant row, a row whose
    top two are equal."""
    rng = np.random.default_rng(seed)
    z = (rng.normal(size=(rows, n)) * scale).astype(np.float32)
    z[1, 5:9] = z[1, 4]  # ties in the support
    z[2, :] = 0.7  # a constant row
    z[3, 0] = z[3, 1] = z.max() + 1.0  # the top two equal
    z[4] = np.round(z[4])  # many ties
    lengths = rng.integers(1, n + 1, rows)
    lengths[0] = n
    lengths[5] = 1  # one real position
    mask = np.arange(n)[None, :] < lengths[:, None]
    return np.where(mask, z, np.float32(-1e9)).astype(np.float32)


@pytest.mark.parametrize("name", sorted(FNS))
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_forward_and_vjp_match_jax(name, seed):
    fn, j_fn = FNS[name]
    z = _scores(seed)
    g = np.random.default_rng(seed + 10).normal(size=z.shape).astype(
        np.float32)
    j_p, j_vjp = jax.vjp(j_fn, jnp.asarray(z))
    (j_dz,) = j_vjp(jnp.asarray(g))
    zt = torch.tensor(z, requires_grad=True)
    p = fn(zt)
    p.backward(torch.tensor(g))
    np.testing.assert_allclose(p.detach().numpy(), np.asarray(j_p), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(zt.grad.numpy(), np.asarray(j_dz), rtol=0,
                               atol=1e-6)
    # masked positions take no weight and no gradient
    masked = z == np.float32(-1e9)
    assert masked.any()
    assert np.all(p.detach().numpy()[masked] == 0.0)
    assert np.all(zt.grad.numpy()[masked] == 0.0)


@pytest.mark.parametrize("name", sorted(FNS))
def test_batched_leading_axes_match_rowwise(name):
    """The adapters call it on [B, 1, L]: leading axes are rows."""
    fn, _ = FNS[name]
    z = torch.tensor(_scores(3)).view(3, 4, 24)
    torch.testing.assert_close(fn(z).view(12, 24), fn(z.view(12, 24)),
                               rtol=0, atol=0)


def test_all_masked_row():
    """A padded batch row has no real position: entmax15 gives uniform
    weights in both packages; sparsemax gives weight 0 and a zero gradient
    in the port, inf in JAX (its gather at index -1 reads the row total)."""
    z = np.full((1, 6), -1e9, np.float32)
    ent = entmax15(torch.tensor(z))
    np.testing.assert_allclose(ent.numpy(), np.asarray(j_entmax15(z)),
                               atol=1e-6)
    np.testing.assert_allclose(ent.numpy(), 1.0 / 6, rtol=1e-5)
    zt = torch.tensor(z, requires_grad=True)
    p = sparsemax(zt)
    p.backward(torch.arange(6.0)[None])
    assert torch.equal(p.detach(), torch.zeros(1, 6))
    assert torch.equal(zt.grad, torch.zeros(1, 6))
    assert np.all(np.isinf(np.asarray(j_sparsemax(z))))


@pytest.mark.parametrize("name", sorted(FNS))
def test_properties(name):
    """On the simplex; uniform in, uniform out; a dominant entry takes all
    the weight (tests/test_ops.py:115-128, :142-155)."""
    fn, _ = FNS[name]
    rng = np.random.default_rng(5)
    z = torch.tensor(rng.normal(size=(4, 10)).astype(np.float32)) * 3
    p = fn(z)
    np.testing.assert_allclose(p.sum(-1).numpy(), 1.0, rtol=1e-5)
    assert bool((p >= 0).all())
    np.testing.assert_allclose(fn(torch.zeros(1, 5)).numpy(), 0.2,
                               rtol=1e-6)
    np.testing.assert_allclose(
        fn(torch.tensor([[10.0, 0.0, 0.0, 0.0]])).numpy(), [[1, 0, 0, 0]],
        atol=1e-6)


def test_entmax15_between_softmax_and_sparsemax():
    """entmax15 is sparser than softmax and denser than sparsemax on the
    same logits (tests/test_ops.py:142-155)."""
    rng = np.random.default_rng(7)
    z = torch.tensor(rng.normal(size=(4, 12)).astype(np.float32)) * 2
    ent, spm = entmax15(z), sparsemax(z)
    sm = torch.softmax(z, -1)
    assert int((ent == 0).sum()) >= int((sm < 1e-6).sum())
    assert int((ent == 0).sum()) <= int((spm == 0).sum())
    assert int((spm == 0).sum()) > 0


@pytest.mark.parametrize("name", sorted(FNS))
def test_grad_matches_finite_diff(name):
    """The closed-form VJP against central differences of the forward
    (tests/test_ops.py:131-139, :158-166), in float64 inputs cast to fp32
    by the forward, eps 1e-3, atol 5e-3 as there."""
    fn, _ = FNS[name]
    rng = np.random.default_rng(8)
    z = torch.tensor(rng.normal(size=(8,)).astype(np.float32))
    w = torch.tensor(rng.normal(size=(8,)).astype(np.float32))

    def f(v):
        return float((fn(v[None, :]) * w).sum())

    zt = z.clone().requires_grad_(True)
    (fn(zt[None, :]) * w).sum().backward()
    eps = 1e-3
    for i in range(8):
        dz = torch.zeros(8)
        dz[i] = eps
        num = (f(z + dz) - f(z - dz)) / (2 * eps)
        np.testing.assert_allclose(float(zt.grad[i]), num, atol=5e-3)
