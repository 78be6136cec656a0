"""The encoder's xla attention core (ops/xla_attention.py).

On the CPU the core is the plain ops the encoder ran before the kernel pair,
bit for bit: the output, the gradient of the packed projection and the
generator's state after dropout's draw. The kernels' arithmetic in plain ops
(``kernel_arithmetic``: normalised probabilities rounded to bf16, torch's
CUDA dropout arithmetic, the fp32 ``ds`` as a bf16 hi/lo pair) stays within a
bf16 rounding of those ops. The encoder picks the core by the projection's
device and dtype. The ``cuda`` cases hold the kernels on the card against
both, and the keep mask against ``F.dropout``'s draw.
"""

import math
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from carel_tpu_torch import ops
from carel_tpu_torch.models import encoder
from carel_tpu_torch.models.encoder import SelfAttention, tiny_encoder_config
from carel_tpu_torch.ops import xla_attention as xa


def _relnorm(a, b):
    return float(torch.linalg.vector_norm((a - b).double())
                 / torch.linalg.vector_norm(b.double()))


def _problem(B, L, h, hd, seed, device="cpu", dtype=torch.bfloat16):
    """qkv [B, L, 3, h, hd], the fp32 key bias [B, 1, 1, L] with ragged pad
    tails (one row all pads), and a context gradient."""
    g = torch.Generator().manual_seed(seed)
    qkv = torch.randn((B, L, 3, h, hd), generator=g) * 1.5
    lengths = torch.randint(1, L + 1, (B,), generator=g)
    lengths[0] = L
    mask = (torch.arange(L)[None, :] < lengths[:, None]).float()
    if B > 2:
        mask[2] = 0.0
    bias = ((1.0 - mask) * -1e9)[:, None, None, :]
    dout = torch.randn((B, L, h * hd), generator=g)
    return (qkv.to(device, dtype), bias.to(device), dout.to(device, dtype))


def _old_core(qkv, bias, dropout, training):
    """The encoder's xla attention as SelfAttention ran it before the kernel
    pair (on the CPU its scores are the upcast product)."""
    B, L, _, h, hd = qkv.shape
    q, k, v = (t.transpose(1, 2) for t in qkv.unbind(2))
    with torch.autocast(device_type=qkv.device.type, enabled=False):
        scores = (q.float() @ k.float().transpose(-1, -2)) / math.sqrt(hd)
    probs = torch.softmax(scores + bias, dim=-1).to(v.dtype)
    probs = F.dropout(probs, dropout, training=training)
    return (probs @ v).transpose(1, 2).reshape(B, L, -1)


def _run(core, qkv, bias, dout, dropout, training, seed=11):
    """core's output, the packed projection's gradient and the generator's
    state after it, from one generator state, under bf16 autocast."""
    torch.manual_seed(seed)
    leaf = qkv.clone().requires_grad_()
    with torch.autocast(qkv.device.type, dtype=torch.bfloat16,
                        enabled=qkv.dtype == torch.bfloat16):
        out = core(leaf, bias, dropout, training)
    state = (torch.cuda.get_rng_state() if qkv.is_cuda
             else torch.get_rng_state())
    out.backward(dout)
    return out.detach(), leaf.grad, state


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("training", [True, False])
@pytest.mark.parametrize("L", [37, 96])
def test_cpu_core_is_the_old_ops_bit_for_bit(L, training, dtype):
    qkv, bias, dout = _problem(3, L, 4, 16, seed=L, dtype=dtype)
    got = _run(xa.xla_attention, qkv, bias, dout, 0.1, training)
    want = _run(_old_core, qkv, bias, dout, 0.1, training)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("training", [True, False])
@pytest.mark.parametrize("L", [37, 96])
def test_cpu_self_attention_is_the_old_layer_bit_for_bit(L, training):
    """The whole bf16 layer (projections under autocast, the core, the out
    projection): output, every parameter's gradient, the generator."""
    cfg = tiny_encoder_config(dtype="bfloat16", dropout=0.1)
    torch.manual_seed(0)
    attn = SelfAttention(cfg)
    _, bias, _ = _problem(3, L, 4, 16, seed=L)
    x = torch.randn(3, L, cfg.hidden_dim).bfloat16()
    dy = torch.randn(3, L, cfg.hidden_dim).bfloat16()

    def layer(old):
        attn.zero_grad()
        torch.manual_seed(5)
        with torch.autocast("cpu", dtype=torch.bfloat16):
            if old:
                qkv = attn._qkv(x)
                y = attn._out(_old_core(qkv, bias, attn.dropout, training))
            else:
                y = attn(x, bias, not training)
        state = torch.get_rng_state()
        y.backward(dy)
        return [y.detach(), state] + [p.grad.clone()
                                      for p in attn.parameters()]

    for a, b in zip(layer(False), layer(True)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dropout,training", [(0.1, True), (0.1, False),
                                              (0.0, True)])
@pytest.mark.parametrize("L", [37, 96])
def test_kernel_arithmetic_is_within_a_bf16_rounding_of_the_ops(
        L, dropout, training):
    """Without dropout the two round at the same points and differ by sum
    orders and fp32 ulps of the softmax (forward 0 to 5.5e-6 read) and by dq
    and dk's products, the hi/lo pair against the fp32 ds (3.6e-5 to 6.3e-5
    read): 1e-3. With dropout the CPU's ops multiply by 1 / (1 - p) in bf16
    (1.109375 at p 0.1), the kernels in fp32 (torch's CUDA arithmetic,
    1.1111112): a bf16 rounding apart (0.0035 to 0.0036 read), 1e-2. Against
    fp64 the arithmetic is within 1e-2 too, on the rows with a real token
    (the all-pad row's fp32 logits s - 1e9 round to one value, so its softmax
    is uniform, as in the ops and in JAX)."""
    qkv, bias, dout = _problem(4, L, 4, 16, seed=100 + L)
    want = _run(xa.attention_ops, qkv, bias, dout, dropout, training)
    torch.manual_seed(11)
    keep = None
    if training and dropout:
        keep = F.dropout(torch.ones((4, 4, L, L), dtype=torch.bfloat16),
                         dropout) != 0
    got = _run(lambda t, b, p, tr: xa.kernel_arithmetic(
        t, b.reshape(4, L), keep, p), qkv, bias, dout, dropout, training)
    tol = 1e-2 if keep is not None else 1e-3
    assert _relnorm(got[0], want[0]) <= tol
    assert _relnorm(got[1], want[1]) <= tol

    truth = qkv.double().requires_grad_()
    q, k, v = (t.transpose(1, 2) for t in truth.unbind(2))
    probs = torch.softmax(q @ k.transpose(-1, -2) / 4.0 + bias.double(), -1)
    if keep is not None:
        probs = probs * keep / (1.0 - dropout)
    out = (probs @ v).transpose(1, 2).reshape(4, L, -1)
    out.backward(dout.double())
    real = [0, 1, 3]
    for a, b in ((got[0], out), (got[1], truth.grad)):
        assert _relnorm(a[real], b.detach()[real]) <= 1e-2


def test_hi_lo_ds_keeps_the_fp32_product():
    """dq = ds . k with the fp32 ds split into bf16 hi + lo, two products
    into one fp32 sum, is the fp32 product up to fp32 round-off (2e-6
    read); one bf16 ds (the lower precision JAX's transpose does not take)
    is 500x further (1e-3 read)."""
    g = torch.Generator().manual_seed(0)
    ds = torch.randn((64, 96, 96), generator=g) * 1e-3
    k = torch.randn((64, 96, 64), generator=g).bfloat16().float()
    want = ds.double() @ k.double()
    hi = ds.bfloat16().float()
    lo = (ds - hi).bfloat16().float()
    pair = _relnorm(hi @ k + lo @ k, want)
    single = _relnorm(hi @ k, want)
    assert pair <= 1e-5
    assert single >= 100 * pair


@pytest.mark.parametrize("device_is_cuda,dtype,want", [
    (True, torch.bfloat16, "xla_attention"), (True, torch.float32, "ops"),
    (False, torch.bfloat16, "xla_attention"),
    (False, torch.float32, "xla_attention")])
def test_the_encoder_picks_the_core_by_device_and_dtype(
        monkeypatch, device_is_cuda, dtype, want):
    """bf16 on CUDA goes to ``xla_attention`` (the kernel pair), fp32 on
    CUDA to ``attention_ops``; a CPU projection goes to ``xla_attention``,
    which takes the plain ops itself. No option of the config enters."""
    attn = SelfAttention(tiny_encoder_config())
    fake = SimpleNamespace(is_cuda=device_is_cuda, dtype=dtype)
    called = []
    monkeypatch.setattr(attn, "_qkv", lambda x: fake)
    monkeypatch.setattr(attn, "_out", lambda ctx: ctx)
    monkeypatch.setattr(encoder, "xla_attention",
                        lambda *a: called.append("xla_attention") or "ctx")
    monkeypatch.setattr(encoder, "attention_ops",
                        lambda *a: called.append("ops") or "ctx")
    assert attn(None, None, True) == "ctx"
    assert called == [want]


def test_cpu_core_launches_nothing():
    ops.reset_launch_counts()
    qkv, bias, _ = _problem(2, 37, 4, 16, seed=0)
    xa.xla_attention(qkv, bias, 0.1, True)
    assert xa.launches == {"xla_attn_fwd": 0, "xla_attn_bwd": 0}


def test_the_kernels_scales_are_torchs():
    """1 / sqrt(hd) is exact at hd 64 and 16; at p 0.1 the forward's and the
    backward's dropout factors are both the fp32 1.1111112."""
    assert xa.scales(64, 0.1)[0] == 0.125
    assert xa.scales(16, 0.0)[0] == 0.25
    _, f, b = xa.scales(64, 0.1)
    assert f == b == float(np.float32(1.0 / 0.9))


# -- on the card -------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    from carel_tpu_torch.device import resolve_device

    return resolve_device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("B,L,h,hd", [(4, 37, 4, 16), (8, 96, 12, 64),
                                      (2, 200, 2, 64), (3, 128, 2, 32)])
def test_kernels_match_the_arithmetic_and_the_ops(cuda, B, L, h, hd):
    """Forward and packed gradient against ``kernel_arithmetic`` (the same
    roundings: sum orders and bf16 flips apart, 5e-3) and ``attention_ops``
    (1e-2), from one generator state, so the three drop the same keys; one
    launch of each kernel a call; the generator ends where the ops leave
    it."""
    qkv, bias, dout = _problem(B, L, h, hd, seed=L, device=cuda)
    ops.reset_launch_counts()
    got = _run(xa.xla_attention, qkv, bias, dout, 0.1, True)
    assert ops.launch_counts()["xla_attn_fwd"] == 1
    assert ops.launch_counts()["xla_attn_bwd"] == 1
    want = _run(xa.attention_ops, qkv, bias, dout, 0.1, True)
    assert torch.equal(got[2], want[2])
    torch.manual_seed(11)
    keep = xa.draw_keep((B, h, L, L), 0.1, cuda)
    arith = _run(lambda t, b, p, tr: xa.kernel_arithmetic(
        t, b.reshape(B, L), keep, p), qkv, bias, dout, 0.1, True)
    for i in (0, 1):
        assert _relnorm(got[i], arith[i]) <= 5e-3
        assert _relnorm(got[i], want[i]) <= 1e-2


@pytest.mark.cuda
def test_keep_mask_is_dropouts_draw(cuda):
    """The keep mask is ``F.dropout``'s on bf16 ones of the shape, and the
    generator ends at the same offset."""
    shape = (8, 12, 96, 96)
    torch.cuda.manual_seed(7)
    keep = xa.draw_keep(shape, 0.1, cuda)
    after = torch.cuda.get_rng_state()
    torch.cuda.manual_seed(7)
    want = F.dropout(torch.ones(shape, dtype=torch.bfloat16, device=cuda),
                     0.1) != 0
    assert torch.equal(keep, want)
    assert torch.equal(after, torch.cuda.get_rng_state())


@pytest.mark.cuda
def test_kernels_repeat_their_bits_and_replay_in_a_graph(cuda):
    qkv, bias, dout = _problem(8, 96, 12, 64, seed=3, device=cuda)
    keep = xa.draw_keep((8, 12, 96, 96), 0.1, cuda)
    b2 = bias.reshape(8, 96)
    sc = xa.scales(64, 0.1)

    def call():
        out, m, l = xa.xla_attention_forward_kernel(qkv, b2, keep, *sc[:2])
        dq = xa.xla_attention_backward_kernel(qkv, b2, keep, dout, m, l, *sc)
        return out, dq

    first = call()
    assert all(torch.equal(a, b) for a, b in zip(first, call()))
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        call()
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = call()
    graph.replay()
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, outs))
