"""The port's flash attention (``attention_impl="flash"``) on the CPU, where
its wrapper takes the plain version, against the JAX side.

The stock Pallas kernel cannot run on the CPU (it has no interpret switch and
refuses ``block_q = 128 > L``), so the plain version is held against the
stock module's own plain reference, ``mha_reference_no_custom_vjp`` with
``SegmentIds`` (the form that differentiates), in fp32 from inputs made with
a numpy seed: value rtol 1e-5, gradients normwise relative error 1e-4 (both
sides compute in fp32; the sums run in another order). The encoder with
``attention_impl="flash"`` is held against the JAX encoder, which takes its
XLA path on the CPU: without dropout the two paths agree at real positions
(``pooled`` and the hidden states there, atol 1e-5) and differ at pad
positions, where a pad query attends to pad keys under the segment mask.

The kernels themselves run only on the card. Their arithmetic for bf16
inputs is repeated here in plain PyTorch (``_emulated_kernels``: the online
softmax over tiles of 32 keys, ``exp(s - running max)`` rounded to bf16
before the product with v, fp32 row sums of the unrounded values, ``p`` and
``ds`` rounded to bf16 before the backward's products, results rounded to
bf16; ``delta`` the fp32 sum of the rounded output times the cotangent; in
the dQ kernel ``p`` stays fp32, ``ds`` is rounded to bf16 and dq is summed
in fp32 tile by tile over the keys) and held against the plain version in
fp32 and against the stock reference: normwise 6e-3 (output) and 8e-3
(gradients), the gates that
chip_smoke.py and tests/test_torch_kernels.py put on the kernels, which
therefore are the arithmetic's own and not luck.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas.ops.tpu.flash_attention import (
    DEFAULT_MASK_VALUE, SegmentIds, mha_reference_no_custom_vjp)

from carel_tpu.models.encoder import TransformerEncoder as JEncoder
from carel_tpu.models.encoder import tiny_encoder_config as j_tiny

from carel_tpu_torch.convert import jax_params_to_state_dict
from carel_tpu_torch.models.encoder import (SelfAttention,
                                            TransformerEncoder, init_flax_,
                                            tiny_encoder_config)
from carel_tpu_torch.ops import cuda_attention as ca

B, H = 4, 3


def _mask(pads: str, L: int) -> np.ndarray:
    """[B, L] attention mask: 'tails' has pad tails of varied length, one
    all-pad row and one row without pads; 'none' has no pads."""
    mask = np.ones((B, L), np.int32)
    if pads == "tails":
        mask[1, L // 2:] = 0
        mask[2, :] = 0
        mask[3, 1:] = 0
    return mask


def _problem(L: int, hd: int, pads: str, seed: int = 0):
    rng = np.random.default_rng(seed)
    q, k, v, g = (rng.normal(size=(B, H, L, hd)).astype(np.float32)
                  for _ in range(4))
    return q, k, v, g, _mask(pads, L)


def _relnorm(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def test_mask_value_is_the_stock_one():
    assert ca.MASK_VALUE == DEFAULT_MASK_VALUE


@pytest.mark.parametrize("pads", ["tails", "none"])
@pytest.mark.parametrize("hd", [16, 64])
@pytest.mark.parametrize("L", [16, 37, 96])
def test_plain_flash_matches_the_stock_reference(L, hd, pads):
    q, k, v, g, mask = _problem(L, hd, pads)
    scale = 1.0 / float(np.sqrt(hd))
    seg = jnp.asarray(mask) + 1  # as carel_tpu's encoder builds them

    def j_fn(q, k, v):
        return mha_reference_no_custom_vjp(
            q, k, v, segment_ids=SegmentIds(q=seg, kv=seg), sm_scale=scale)

    want = j_fn(q, k, v)
    want_grads = jax.grad(lambda *a: jnp.sum(j_fn(*a) * g),
                          argnums=(0, 1, 2))(q, k, v)

    leaves = [torch.tensor(a, requires_grad=True) for a in (q, k, v)]
    got = ca.flash_attention(*leaves, torch.tensor(mask), scale)
    got_grads = torch.autograd.grad(got, leaves, torch.tensor(g))
    assert np.isfinite(got.detach().numpy()).all()  # the all-pad row too
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-6)
    for name, a, b in zip("qkv", got_grads, want_grads):
        assert _relnorm(a.numpy(), b) <= 1e-4, name


KERNEL_TILE = 32  # keys per tile of the tensor-core kernels' online softmax


def _emulated_kernels(q, k, v, g, mask, scale):
    """The arithmetic of K7-K9 for bf16 q, k, v, g ``[B, h, L, hd]`` in
    plain PyTorch, every rounding where the kernels round; returns out, dq,
    dk, dv in bf16."""
    bf = torch.bfloat16
    qf, kf, vf, gf = (t.float() for t in (q, k, v, g))
    seg = ca.segment_ids(mask)
    same = seg[:, None, :, None] == seg[:, None, None, :]
    s = (qf @ kf.transpose(-1, -2)) * scale + torch.where(same, 0.0,
                                                          ca.MASK_VALUE)
    L = s.shape[-1]
    m = torch.full(s.shape[:-1], -torch.inf)
    row_sum = torch.zeros(s.shape[:-1])
    acc = torch.zeros_like(qf)
    for k0 in range(0, L, KERNEL_TILE):
        tile = s[..., k0:k0 + KERNEL_TILE]
        m_new = torch.maximum(m, tile.amax(-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(tile - m_new[..., None])
        row_sum = row_sum * alpha + p.sum(-1)
        acc = acc * alpha[..., None] \
            + p.to(bf).float() @ vf[..., k0:k0 + KERNEL_TILE, :]
        m = m_new
    out = (acc / row_sum[..., None]).to(bf)
    lse = m + torch.log(row_sum)
    # backward, from the rounded output as the kernels read it: delta is
    # the dQ kernel's prologue, and the dK/dV kernel reads the same values
    delta = (out.float() * gf).sum(-1, keepdim=True)
    p = torch.exp(s - lse[..., None])
    ds = ((gf @ vf.transpose(-1, -2) - delta) * p) * scale
    p16, ds16 = p.to(bf).float(), ds.to(bf).float()
    dv = p16.transpose(-1, -2) @ gf
    dk = ds16.transpose(-1, -2) @ qf
    # dq: a warp's fp32 accumulator takes one tile of keys after another
    dq = torch.zeros_like(qf)
    for k0 in range(0, L, KERNEL_TILE):
        dq = dq + ds16[..., k0:k0 + KERNEL_TILE] \
            @ kf[..., k0:k0 + KERNEL_TILE, :]
    return out, dq.to(bf), dk.to(bf), dv.to(bf)


@pytest.mark.parametrize("reference", ["plain", "stock"])
@pytest.mark.parametrize("L,hd", [(37, 16), (96, 64), (200, 64), (513, 32),
                                  (96, 128)])
def test_emulated_kernel_arithmetic_is_inside_the_card_gates(L, hd,
                                                             reference):
    """bf16 inputs with pad tails (row 1's is L // 2, over one tile from
    L = 96 on), an all-pad row and a row with one real token. Gates: 6e-3
    on the output, 8e-3 on each gradient, normwise against fp32."""
    q, k, v, g, mask = _problem(L, hd, "tails", seed=L)
    q, k, v, g = (torch.tensor(a).bfloat16() for a in (q, k, v, g))
    mask_t = torch.tensor(mask)
    scale = 1.0 / float(np.sqrt(hd))
    got = [t.float().numpy() for t in _emulated_kernels(q, k, v, g, mask_t,
                                                        scale)]
    assert all(np.isfinite(a).all() for a in got)  # the all-pad row too
    if reference == "plain":
        leaves = [t.float().requires_grad_() for t in (q, k, v)]
        ref = ca.flash_attention_plain(*leaves, mask_t, scale)
        want = [ref.detach().numpy()] + [
            a.numpy() for a in torch.autograd.grad(ref, leaves, g.float())]
    else:
        seg = jnp.asarray(mask) + 1
        args = [jnp.asarray(t.float().numpy()) for t in (q, k, v)]

        def j_fn(q, k, v):
            return mha_reference_no_custom_vjp(
                q, k, v, segment_ids=SegmentIds(q=seg, kv=seg),
                sm_scale=scale)

        want = [j_fn(*args)] + list(jax.grad(
            lambda *a: jnp.sum(j_fn(*a) * g.float().numpy()),
            argnums=(0, 1, 2))(*args))
    assert _relnorm(got[0], want[0]) <= 6e-3
    for name, a, b in zip(("dq", "dk", "dv"), got[1:], want[1:]):
        assert _relnorm(a, b) <= 8e-3, name


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("L,hd", [(200, 64), (513, 32), (96, 128)])
def test_cpu_wrappers_take_the_plain_version_at_the_new_shapes(L, hd, dtype):
    """CPU tensors at the shapes the tensor-core kernels added (L over one
    block, hd = 128) still go to the plain version, in both layouts."""
    q, k, v, _, mask = _problem(L, hd, "tails", seed=hd)
    q, k, v = (torch.tensor(a[:2, :2]).to(dtype) for a in (q, k, v))
    mask_t = torch.tensor(mask[1:3])  # a pad tail over one tile, all pads
    scale = 1.0 / float(np.sqrt(hd))
    want = ca.flash_attention_plain(q, k, v, mask_t, scale)
    assert torch.equal(ca.flash_attention(q, k, v, mask_t, scale), want)
    qkv = torch.stack([t.transpose(1, 2) for t in (q, k, v)], dim=2)
    ctx = ca.flash_attention_packed(qkv, mask_t, scale)
    assert ctx.dtype == dtype and ctx.shape == (2, L, 2 * hd)
    assert torch.equal(ctx.view(2, L, 2, hd).transpose(1, 2), want)
    assert bool(torch.isfinite(ctx).all())


def test_cpu_wrappers_take_the_plain_version_in_both_layouts():
    q, k, v, g, mask = _problem(37, 16, "tails", seed=1)
    scale = 0.25
    mask_t = torch.tensor(mask)
    leaves = [torch.tensor(a, requires_grad=True) for a in (q, k, v)]
    out = ca.flash_attention(*leaves, mask_t, scale)
    plain = ca.flash_attention_plain(*leaves, mask_t, scale)
    assert torch.equal(out, plain)
    grads = torch.autograd.grad(out, leaves, torch.tensor(g))
    # the encoder's packed projection [B, L, 3, h, hd] -> [B, L, h * hd]
    qkv = torch.stack([t.detach().transpose(1, 2) for t in leaves],
                      dim=2).requires_grad_()
    ctx = ca.flash_attention_packed(qkv, mask_t, scale)
    assert ctx.shape == (B, 37, H * 16)
    assert torch.equal(ctx.view(B, 37, H, 16).transpose(1, 2), out)
    (dqkv,) = torch.autograd.grad(
        ctx, qkv, torch.tensor(g).transpose(1, 2).reshape(B, 37, H * 16))
    for got, want in zip(dqkv.unbind(2), grads):
        torch.testing.assert_close(got.transpose(1, 2), want, rtol=1e-6,
                                   atol=1e-6)
    with pytest.raises(ValueError, match="qkv must be"):
        ca.flash_attention_packed(qkv[:, :, :2], mask_t, scale)


def test_bf16_plain_flash_rounds_the_unnormalised_probabilities():
    """bf16 inputs: the scores and sums are fp32 and ``exp(s - max)`` is
    rounded to bf16 before the product with v, then divided by the fp32 row
    sum. Rounding the normalised probabilities instead (the XLA attention,
    the stock kernel's single-block form) gives another value."""
    q, k, v, _, mask = _problem(37, 16, "tails", seed=2)
    q, k, v = (torch.tensor(a).bfloat16() for a in (q, k, v))
    mask_t = torch.tensor(mask)
    scale = 0.25
    got = ca.flash_attention_plain(q, k, v, mask_t, scale,
                                   out_dtype=torch.float32)
    s = (q.float() @ k.float().transpose(-1, -2)) * scale
    same = mask_t[:, None, :, None] == mask_t[:, None, None, :]
    s = s + torch.where(same, 0.0, ca.MASK_VALUE)
    e = torch.exp(s - s.amax(-1, keepdim=True))
    row_sum = e.sum(-1, keepdim=True)
    unnormalised = (e.bfloat16().float() @ v.float()) / row_sum
    normalised = (e / row_sum).bfloat16().float() @ v.float()
    torch.testing.assert_close(got, unnormalised, rtol=1e-6, atol=1e-6)
    assert float((got - normalised).abs().max()) > 1e-4
    # and the output takes the input type
    out = ca.flash_attention(q, k, v, mask_t, scale)
    assert out.dtype == torch.bfloat16
    assert torch.equal(out, got.bfloat16())


def test_flash_and_default_attention_agree_at_real_positions_only():
    kw = dict(vocab_size=128, dropout=0.0)
    rng = np.random.default_rng(3)
    x = torch.tensor(rng.normal(size=(B, 16, 64)).astype(np.float32))
    mask = _mask("tails", 16)
    bias = torch.tensor(((1.0 - mask) * -1e9)[:, None, None, :],
                        dtype=torch.float32)
    default = SelfAttention(tiny_encoder_config(**kw))
    init_flax_(default, torch.Generator().manual_seed(0))
    flash = SelfAttention(tiny_encoder_config(attention_impl="flash", **kw))
    flash.load_state_dict(default.state_dict())  # flash adds no parameters
    with torch.no_grad():
        want = default(x, bias, True)
        got = flash(x, ca.segment_ids(torch.tensor(mask)), True)
    real = torch.tensor(mask).bool()
    torch.testing.assert_close(got[real], want[real], rtol=0, atol=1e-5)
    assert float((got[~real] - want[~real]).abs().max()) > 1e-3
    assert bool(torch.isfinite(got).all())


def test_flash_has_no_dropout_on_the_probabilities():
    """In training the default path drops probabilities; the flash path
    does not, as the JAX flash path: two training-mode calls agree."""
    cfg = tiny_encoder_config(vocab_size=128, dropout=0.5,
                              attention_impl="flash")
    attn = SelfAttention(cfg)
    init_flax_(attn, torch.Generator().manual_seed(0))
    x = torch.randn(2, 8, 64, generator=torch.Generator().manual_seed(1))
    seg = torch.ones(2, 8, dtype=torch.int32)
    assert torch.equal(attn(x, seg, False), attn(x, seg, False))


def test_unknown_attention_impl_raises():
    with pytest.raises(ValueError, match="attention_impl 'nope'"):
        TransformerEncoder(tiny_encoder_config(attention_impl="nope"))


@pytest.mark.parametrize("arch", ["bert", "roberta"])
def test_flash_encoder_matches_jax_at_real_positions(arch):
    kw = dict(vocab_size=128, dropout=0.0, arch=arch, pad_token_id=1)
    rng = np.random.default_rng(0)
    ids = rng.integers(2, 128, (4, 16)).astype(np.int32)
    mask = np.ones((4, 16), np.int32)
    mask[1, 10:] = 0
    mask[3, 5:] = 0
    ids[mask == 0] = 1
    types = np.zeros((4, 16), np.int32)
    types[:, 8:] = 1
    jenc = JEncoder(j_tiny(**kw))
    variables = jenc.init(jax.random.key(0), ids, mask, types)
    j_hidden, j_pooled = jenc.apply(variables, ids, mask, types,
                                    deterministic=True)
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    tenc = TransformerEncoder(tiny_encoder_config(attention_impl="flash",
                                                  **kw))
    # the converter's keys serve both attention paths
    tenc.load_state_dict(jax_params_to_state_dict(params), strict=True)
    with torch.no_grad():
        t_hidden, t_pooled = tenc(torch.tensor(ids), torch.tensor(mask),
                                  torch.tensor(types))
    real = mask.astype(bool)
    np.testing.assert_allclose(t_pooled.numpy(), np.asarray(j_pooled),
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(t_hidden.numpy()[real],
                               np.asarray(j_hidden)[real], atol=1e-5, rtol=0)
    assert np.abs(t_hidden.numpy()[~real]
                  - np.asarray(j_hidden)[~real]).max() > 1e-3
