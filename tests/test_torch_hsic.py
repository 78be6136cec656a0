"""The port's plain HSIC against the JAX package's, on the CPU.

Inputs come from numpy with a seed and go through the port's ``hsic``
(through ``hsic_statistic``, which takes the plain version for CPU tensors),
``carel_tpu.ops.pairwise.hsic`` and ``hsic_pallas`` (interpret mode, as
tests/test_pallas_ops.py runs it), for values and gradients, unmasked and
with masked tail rows, with s_x != s_y.

Two input scales:

- spread: latents N(0, 0.2^2) per coordinate, squared distances ~2, so the
  Grams are informative. Tolerances: value rtol 1e-5, gradients normwise
  relative error 1e-4, masked-row gradients exactly 0.
- tight: the same latents times 1e-2, so K and L are nearly all ones and the
  centred entries are small differences of O(1) numbers. Every fp32
  implementation loses precision there: against the float64 evaluation of
  the same formula, the port's fp32 value is off by 2.9e-4-3.7e-4 relative,
  JAX's hsic by 2.5e-4-3.9e-4 and hsic_pallas by 0.8e-4-1.2e-4, and their
  gradients by up to 4.3e-3 normwise (measured at B = 64 unmasked and B = 61
  with 3 masked rows). Two fp32 implementations therefore cannot agree to
  1e-5 there. Each one is held against the float64 value at rtol 2e-3 and
  gradients 2e-2 normwise, and the port's float64 evaluation, the yardstick
  the CUDA kernels are held against on the card, against an independent
  numpy float64 formula tr(K H L H) / (n - 1)^2 at rtol 1e-10.

The JAX formulas themselves are also run in float64 (x64 on, the float32
casts of both JAX modules read as float64) on float64 inputs and held against
the port's float64 plain version at rtol 1e-10, value and gradients, at both
scales: a formula difference that shows only with nearly-all-ones Grams
cannot hide below fp32 rounding there (measured ~1e-12).
"""

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

SPREAD, TIGHT = 0.2, 0.2e-2
S_X, S_Y = 1.0, 0.7


def _problem(B, masked, scale, d=24, seed=0):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(B, d)) * scale).astype(np.float32)
    y = (rng.normal(size=(B, d)) * 1.3 * scale + 0.1 * scale).astype(
        np.float32)
    mask = np.ones(B, np.float32)
    if masked:
        mask[-masked:] = 0.0
    return x, y, mask


def _port(x, y, mask, dtype=torch.float32):
    a = torch.tensor(x, dtype=dtype, requires_grad=True)
    b = torch.tensor(y, dtype=dtype, requires_grad=True)
    val = cuda_pairwise.hsic_statistic(a, b, S_X, S_Y,
                                       torch.tensor(mask, dtype=dtype))
    dx, dy = torch.autograd.grad(val, (a, b))
    return float(val.detach()), dx.numpy(), dy.numpy()


def _jax(impl, x, y, mask):
    def fn(a, b):
        if impl == "pallas":
            return hsic_pallas(a, b, S_X, S_Y, jnp.asarray(mask))
        return j_hsic(a, b, S_X, S_Y, mask=jnp.asarray(mask))

    val, (dx, dy) = jax.value_and_grad(fn, argnums=(0, 1))(x, y)
    return float(val), np.asarray(dx), np.asarray(dy)


def _relnorm(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


@pytest.mark.parametrize("B,masked", [(64, 0), (61, 3)])
@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_plain_hsic_matches_jax(impl, B, masked):
    x, y, mask = _problem(B, masked, SPREAD)
    val, dx, dy = _port(x, y, mask)
    j_val, j_dx, j_dy = _jax(impl, x, y, mask)
    np.testing.assert_allclose(val, j_val, rtol=1e-5)
    assert _relnorm(dx, j_dx) <= 1e-4
    assert _relnorm(dy, j_dy) <= 1e-4
    if masked:
        assert np.abs(dx[-masked:]).max() == 0.0
        assert np.abs(dy[-masked:]).max() == 0.0


def _numpy_hsic64(x, y, mask):
    x, y, m = (np.asarray(a, np.float64) for a in (x, y, mask))
    n = m.sum()

    def gram(z, s):
        d2 = ((z[:, None, :] - z[None, :, :]) ** 2).sum(-1)
        return np.exp(-d2 / s)

    H = np.diag(m) - np.outer(m, m) / n
    return np.trace(gram(x, S_X) @ H @ gram(y, S_Y) @ H) / (n - 1.0) ** 2


@pytest.mark.parametrize("B,masked", [(64, 0), (61, 3)])
@pytest.mark.parametrize("impl", ["port", "xla", "pallas"])
def test_tight_latents_fp32_within_bound_of_float64(impl, B, masked):
    x, y, mask = _problem(B, masked, TIGHT)
    want, w_dx, w_dy = _port(x, y, mask, torch.float64)
    np.testing.assert_allclose(want, _numpy_hsic64(x, y, mask), rtol=1e-10)
    val, dx, dy = (_port(x, y, mask) if impl == "port"
                   else _jax(impl, x, y, mask))
    np.testing.assert_allclose(val, want, rtol=2e-3)
    assert _relnorm(dx, w_dx) <= 2e-2
    assert _relnorm(dy, w_dy) <= 2e-2
    if masked:
        assert np.abs(dx[-masked:]).max() == 0.0


def test_float64_plain_matches_numpy_at_spread_scale():
    x, y, mask = _problem(61, 3, SPREAD, seed=4)
    val, _, _ = _port(x, y, mask, torch.float64)
    np.testing.assert_allclose(val, _numpy_hsic64(x, y, mask), rtol=1e-10)


class _Float64Numpy:
    """jax.numpy with ``float32`` read as ``float64``: the JAX HSIC modules
    cast their inputs, mask and products to float32, and this lets their
    formulas run in float64 without a change to them."""

    float32 = jnp.float64

    def __getattr__(self, name):
        return getattr(jnp, name)


@pytest.mark.parametrize("B,masked", [(64, 0), (61, 3)])
@pytest.mark.parametrize("scale", [SPREAD, TIGHT])
@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_jax_float64_matches_port_float64(monkeypatch, impl, scale, B,
                                          masked):
    x, y, mask = (a.astype(np.float64) for a in _problem(B, masked, scale))
    want, w_dx, w_dy = _port(x, y, mask, torch.float64)
    for module in (j_pairwise, j_pallas_pairwise):
        monkeypatch.setattr(module, "jnp", _Float64Numpy())
    with jax.enable_x64(True):
        val, dx, dy = _jax(impl, jnp.asarray(x), jnp.asarray(y), mask)
    assert dx.dtype == np.float64
    np.testing.assert_allclose(val, want, rtol=1e-10)
    assert _relnorm(dx, w_dx) <= 1e-10
    assert _relnorm(dy, w_dy) <= 1e-10
    if masked:
        assert np.abs(dx[-masked:]).max() == 0.0
        assert np.abs(dy[-masked:]).max() == 0.0


def test_kernel_wrappers_refuse_cpu_tensors():
    x, y, mask = (torch.tensor(a) for a in _problem(4, 0, SPREAD))
    with pytest.raises(ValueError, match="CUDA"):
        cuda_pairwise.hsic_forward_kernel(x, y, mask, S_X, S_Y)


def test_registry_hsic_term_matches_jax():
    from carel_tpu.config import LossConfig as JLossConfig
    from carel_tpu.config import Regularizer as JRegularizer
    from carel_tpu.losses.registry import regularizer_loss as j_reg

    from carel_tpu_torch.config import LossConfig, Regularizer
    from carel_tpu_torch.losses.registry import regularizer_loss

    x, y, mask = _problem(16, 3, SPREAD, seed=2)
    kw = dict(hsic_weight=2.5, hsic_sigma=1.5)
    got = regularizer_loss({"z_emotion": torch.tensor(x),
                            "z_cause": torch.tensor(y)},
                           LossConfig(regularizer=Regularizer.HSIC, **kw),
                           torch.tensor(mask))
    want = j_reg({"z_emotion": jnp.asarray(x), "z_cause": jnp.asarray(y)},
                 JLossConfig(regularizer=JRegularizer.HSIC, **kw),
                 jnp.asarray(mask), impl="pallas")
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
