"""The DeepSeek-V2 encoder of carel_tpu_torch (``models/deepseek_v2.py``,
``ops/moe.py``) against the plain fp32 version of ``deepseek_v2_plain.py``
at a tiny size on the CPU: hidden 64, 4 heads, nope 16 / rope 8 / v 16,
latent 32, 8 routed experts of width 24 with top-3, one shared expert, one
dense layer and two mixture layers, experts 2-5 held unless a test says
otherwise. Both sides compute in fp32 in another order, so values agree to
fp32 rounding, ~1e-6 relative; the tolerances below say where more is
allowed and why. The last test needs the card: the captured epoch step
against the eager one, bit for bit. Imports no JAX.
"""

from __future__ import annotations

import dataclasses
import math
import os
import sys

import numpy as np
import pytest
import torch
from torch import nn

from carel_tpu_torch.config import (CarelConfig, DataConfig, DeepseekV2Config,
                                    LossConfig, ModelConfig, Regularizer,
                                    TrainConfig)
from carel_tpu_torch.data.batching import PairArrays, cut_batch
from carel_tpu_torch.models import deepseek_v2 as ds
from carel_tpu_torch.models.drl import DrlModel
from carel_tpu_torch.models.encoder import init_flax_
from carel_tpu_torch.ops import moe
from carel_tpu_torch.train.scan_epoch import make_epoch_step, stack_epoch
from carel_tpu_torch.train.state import create_train_state
from carel_tpu_torch.train.steps import batch_to_device, make_train_step

# the plain version beside this file (the card's machine has another
# package named tests on its path)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import deepseek_v2_plain as plain  # noqa: E402

VOCAB, BOW, EC, B, L = 97, 40, 8, 6, 12
HELD = (2, 4)
CPU = torch.device("cpu")


def tiny_cfg(held=HELD, dtype="float32", **kw) -> DeepseekV2Config:
    base = dict(vocab_size=VOCAB, hidden_dim=64, num_layers=3, num_heads=4,
                mlp_dim=96, kv_lora_rank=32, qk_nope_head_dim=16,
                qk_rope_head_dim=8, v_head_dim=16, moe_intermediate_size=24,
                n_routed_experts=8, n_shared_experts=1,
                num_experts_per_tok=3, first_k_dense_replace=1,
                rope_original_max_position=64, pad_token_id=0, dtype=dtype,
                experts_held=held)
    base.update(kw)
    return DeepseekV2Config(**base)


def hf_keys(cfg: DeepseekV2Config) -> dict:
    """The model's config.json keys of ``cfg``."""
    return dict(
        model_type="deepseek_v2", vocab_size=cfg.vocab_size,
        hidden_size=cfg.hidden_dim, num_hidden_layers=cfg.num_layers,
        num_attention_heads=cfg.num_heads, num_key_value_heads=cfg.num_heads,
        intermediate_size=cfg.mlp_dim, kv_lora_rank=cfg.kv_lora_rank,
        q_lora_rank=None, qk_nope_head_dim=cfg.qk_nope_head_dim,
        qk_rope_head_dim=cfg.qk_rope_head_dim, v_head_dim=cfg.v_head_dim,
        moe_intermediate_size=cfg.moe_intermediate_size,
        n_routed_experts=cfg.n_routed_experts,
        n_shared_experts=cfg.n_shared_experts,
        num_experts_per_tok=cfg.num_experts_per_tok,
        first_k_dense_replace=cfg.first_k_dense_replace, moe_layer_freq=1,
        rms_norm_eps=cfg.layer_norm_eps, rope_theta=cfg.rope_theta,
        norm_topk_prob=cfg.norm_topk_prob,
        routed_scaling_factor=cfg.routed_scaling_factor,
        max_position_embeddings=cfg.max_position, topk_method="greedy",
        scoring_func="softmax", n_group=1, topk_group=1, hidden_act="silu",
        attention_bias=False, tie_word_embeddings=False,
        pad_token_id=cfg.pad_token_id,
        rope_scaling=dict(type="yarn", factor=cfg.rope_factor,
                          beta_fast=cfg.rope_beta_fast,
                          beta_slow=cfg.rope_beta_slow,
                          mscale=cfg.rope_mscale,
                          mscale_all_dim=cfg.rope_mscale_all_dim,
                          original_max_position_embeddings=(
                              cfg.rope_original_max_position)))


def seeded(cfg: DeepseekV2Config, seed: int = 0) -> dict:
    """{name: fp32 tensor} of the plain spec: matrices N(0, 1/fan_in),
    norm weights 1 + 0.02 N."""
    g = torch.Generator().manual_seed(seed)
    out = {}
    for name, shape in plain.encoder_spec(hf_keys(cfg), cfg.held_range(),
                                          prefix=""):
        t = torch.randn(shape, generator=g)
        out[name] = t / math.sqrt(shape[1]) if len(shape) == 2 \
            else 1.0 + 0.02 * t
    return out


def port_state(enc: nn.Module, P: dict) -> dict:
    sd = enc.state_dict()
    return {n: P[n].view(sd[n].shape).clone() for n in sd}


def inputs(seed=0, b=B, l=L):
    g = torch.Generator().manual_seed(seed)
    ids = torch.randint(1, VOCAB, (b, l), generator=g)
    lengths = torch.randint(2, l + 1, (b,), generator=g)
    lengths[0] = l
    mask = (torch.arange(l)[None] < lengths[:, None]).long()
    return ids * mask, mask


def test_encoder_matches_plain():
    """Hidden states at real positions and the pooled output (last real
    token) against the plain encoder: fp32 on both sides, atol 2e-5 over
    values of ~1-4 (three layers of sums in another order)."""
    cfg = tiny_cfg()
    P = seeded(cfg)
    enc = ds.DeepseekV2Encoder(cfg)
    enc.load_state_dict(port_state(enc, P))
    ids, mask = inputs()
    with torch.no_grad():
        h, pooled = enc(ids, mask)
        hr, pr = plain.encode(P, hf_keys(cfg), ids, mask, HELD, prefix="")
    real = mask.bool()
    torch.testing.assert_close(h[real], hr[real], atol=2e-5, rtol=0)
    torch.testing.assert_close(pooled, pr, atol=2e-5, rtol=0)
    last = mask.sum(1) - 1
    assert torch.equal(pooled, h[torch.arange(B), last])


class PlainEncoder(nn.Module):
    """The plain encoder as a module over its own parameters, for a
    DrlModel whose heads, loss and optimizer are the port's."""

    def __init__(self, cfg: DeepseekV2Config, P: dict):
        super().__init__()
        self.c, self.held = hf_keys(cfg), cfg.held_range()
        self.p = nn.ParameterDict({n.replace(".", "__"): nn.Parameter(
            t.clone()) for n, t in P.items()})

    def forward(self, ids, mask, token_type_ids=None, deterministic=True,
                pool=True):
        P = {n.replace("__", "."): t for n, t in self.p.items()}
        return plain.encode(P, self.c, ids, mask, self.held, prefix="")


def carel_cfg(enc_cfg, lr=1e-3) -> CarelConfig:
    return CarelConfig(
        model=ModelConfig(encoder=enc_cfg, ec_dim=EC, bow_dim=BOW,
                          dropout=0.0),
        loss=LossConfig(regularizer=Regularizer.MMD),
        data=DataConfig(max_len=L),
        train=TrainConfig(batch_size=B, vae_lr=lr))


def pair_arrays(n, seed=0):
    rng = np.random.default_rng(seed)
    ids, mask = inputs(seed, n)
    idx = rng.integers(0, BOW, (n, 5)).astype(np.int32)
    idx[:, -1] = -1
    return PairArrays(
        input_ids=ids.numpy().astype(np.int32),
        attention_mask=mask.numpy().astype(np.int32),
        token_type_ids=np.zeros((n, L), np.int32),
        pair_labels=(np.arange(n) % 3 == 0).astype(np.float32),
        emotion_labels=rng.integers(0, 6, n).astype(np.int32),
        temporal_order=np.zeros(n, bool), bow_indices=idx,
        bow_weights=np.where(idx >= 0, 0.25, 0.0).astype(np.float32))


def port_and_plain_states(cfg: CarelConfig):
    """Two TrainStates from one seeded DrlModel: the port's, and one whose
    encoder is the plain one over the same weights."""
    P = seeded(cfg.model.encoder)
    port = DrlModel(cfg.model)
    init_flax_(port, torch.Generator().manual_seed(3))
    port.encoder.load_state_dict(port_state(port.encoder, P))
    ref = DrlModel(cfg.model)
    ref.load_state_dict(port.state_dict())
    ref.encoder = PlainEncoder(cfg.model.encoder, P)
    noise = [torch.Generator().manual_seed(5) for _ in range(2)]
    return (create_train_state(cfg, port, noise[0]),
            create_train_state(cfg, ref, noise[1]))


def port_name(name: str) -> str:
    if name.startswith("encoder.p."):
        return "encoder." + name[len("encoder.p."):].replace("__", ".")
    return name


def test_carel_loss_gradients_and_adam_steps_match_plain():
    """The CAREL loss of a batch, every leaf's gradient and three Adam
    steps (lr 1e-3) of the port against the same DrlModel over the plain
    encoder, noise fixed. Loss rtol 1e-5; gradients within 1e-4 of the
    leaf's norm (fp32 sums in another order through three layers and the
    heads); parameters after three steps within 1e-6 absolute, and the
    routed experts that received no rows not moved on either side."""
    cfg = carel_cfg(tiny_cfg())
    a, b = port_and_plain_states(cfg)
    batch = batch_to_device(cut_batch(pair_arrays(B), np.arange(B),
                                      B).as_dict(), CPU)
    eps = (torch.randn(EC, generator=torch.Generator().manual_seed(9)),
           torch.randn(EC, generator=torch.Generator().manual_seed(10)))
    losses_a, losses_b, grads = [], [], []
    for st, losses in ((a, losses_a), (b, losses_b)):
        step = make_train_step(cfg)
        for i in range(3):
            out = step(st, batch, i, 0.0, eps=eps)
            losses.append(float(out["loss"]))
            if i == 0:
                grads.append({port_name(n): p.grad.clone()
                              for n, p in st.model.named_parameters()
                              if p.grad is not None})
    np.testing.assert_allclose(losses_a, losses_b, rtol=1e-5)
    ga, gb = grads
    assert set(ga) == set(gb)
    for n in gb:
        scale = float(gb[n].norm())
        err = float((ga[n].reshape(-1) - gb[n].reshape(-1)).norm())
        assert err <= 1e-4 * max(scale, 1e-6), (n, err, scale)
    pb = {port_name(n): p for n, p in b.model.named_parameters()}
    for n, p in a.model.named_parameters():
        q = pb[n].reshape(p.shape)
        torch.testing.assert_close(p, q, atol=1e-6, rtol=0, msg=n)


def test_expert_shares_add_up_to_the_layer():
    """Eight experts held as four shares of two: the shares' routed parts
    plus the shared expert, counted once, equal the uncut layer, and the
    uncut layer equals the plain one (atol 1e-6: fp32, another order)."""
    full_cfg = tiny_cfg(held=None)
    full = ds.MoE(full_cfg)
    init_flax_(full, torch.Generator().manual_seed(1))
    x = torch.randn(30, 64, generator=torch.Generator().manual_seed(2))
    total = full.shared_experts(x)
    for share in range(4):
        part = ds.MoE(tiny_cfg(held=(2 * share, 2)))
        with torch.no_grad():
            part.gate.copy_(full.gate)
            part.experts.gate_up.copy_(full.experts.gate_up[2 * share:
                                                            2 * share + 2])
            part.experts.down.copy_(full.experts.down[2 * share:
                                                      2 * share + 2])
        total = total + part.routed(x)
    with torch.no_grad():
        whole = full(x[None])[0]
        P = {"l.mlp.gate": full.gate,
             "l.mlp.experts.gate_up": full.experts.gate_up.reshape(-1, 64),
             "l.mlp.experts.down": full.experts.down.reshape(-1, 24)}
        for n in ("gate_proj", "up_proj", "down_proj"):
            P[f"l.mlp.shared_experts.{n}.weight"] = getattr(
                full.shared_experts, n).weight
        want = plain.moe(P, "l.", hf_keys(full_cfg), x, (0, 8))
    torch.testing.assert_close(total.detach(), whole, atol=1e-6, rtol=0)
    torch.testing.assert_close(whole, want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("T,k,first,held", [(37, 3, 2, 4), (5, 6, 0, 8),
                                            (64, 2, 60, 4), (9, 4, 3, 1)])
def test_dispatch_places_every_held_choice_once(T, k, first, held):
    """Every choice of a held expert has a row of its own inside that
    expert's tile-aligned segment, in token order; the rest of the buffer
    is padding; the tiles name their expert; nothing needs the host."""
    E = 64
    g = torch.Generator().manual_seed(T)
    ids = torch.stack([torch.randperm(E, generator=g)[:k] for _ in range(T)])
    plan = moe.dispatch(ids, first, held)
    assert plan.rows == moe.buffer_rows(T, k, held)
    local = ids - first
    is_held = (local >= 0) & (local < held)
    assert torch.equal(plan.choice_rows >= 0, is_held)
    starts = plan.starts.tolist()
    for e in range(held):
        assert int(plan.counts[e]) == int((local == e).sum())
        assert starts[e] % moe.BLOCK_M == 0
        rows = plan.choice_rows[local == e]
        assert sorted(rows.tolist()) == list(range(starts[e], starts[e]
                                                   + len(rows)))
        # the stable sort keeps the expert's choices in token order
        assert torch.equal(rows, rows.sort().values)
    flat = plan.choice_rows.reshape(-1)
    placed = flat[flat >= 0]
    assert torch.equal(plan.row_choice[placed],
                       torch.arange(T * k)[flat >= 0])
    assert int((plan.row_choice >= 0).sum()) == int(is_held.sum())
    for i, e in enumerate(plan.tile_expert.tolist()):
        lo = i * moe.BLOCK_M
        if e < 0:
            assert lo >= starts[-1]
        else:
            assert starts[e] <= lo < starts[e + 1]


@pytest.mark.parametrize("T,k,E,first,held", [(37, 3, 8, 2, 4),
                                               (5, 3, 8, 0, 8)])
def test_routed_experts_backward_matches_autograd_of_the_plain_functions(
        T, k, E, first, held):
    """The routed experts' hand-written backward (``_RoutedExperts``: the
    gathered rows and the SwiGLU formed again, its derivative, the weight
    gradients, the combine of the input's gradient, the weights' row dots)
    against autograd through the plain functions composed as the forward
    composes the kernels, in fp32: the output and every gradient within
    1e-5 normwise (sums in another order)."""
    D, I = 16, 12
    g = torch.Generator().manual_seed(T)
    x = torch.randn(T, D, generator=g)
    w, ids = torch.topk(torch.softmax(torch.randn(T, E, generator=g), -1),
                        k, dim=-1)
    wgu = torch.randn(held, 2 * I, D, generator=g) / D ** 0.5
    wd = torch.randn(held, D, I, generator=g) / I ** 0.5
    gy = torch.randn(T, D, generator=g)
    plan = moe.dispatch(ids, first, held)

    def plain_routed(x, w, wgu, wd):
        h = moe.expert_gemm_plain(moe.gather_rows_plain(x, plan, k), wgu,
                                  plan)
        y = moe.expert_gemm_plain(moe.swiglu_plain(h), wd, plan)
        return moe.combine_plain(y, plan, w, x.dtype)

    def grads(fn):
        leaves = [t.clone().requires_grad_(True) for t in (x, w, wgu, wd)]
        out = fn(*leaves)
        out.backward(gy)
        return [out.detach()] + [t.grad for t in leaves]

    got = grads(lambda x, w, wgu, wd: moe.routed_experts(x, w, plan, wgu,
                                                         wd))
    want = grads(plain_routed)
    for name, a, b in zip(("out", "dx", "dweights", "dgate_up", "ddown"),
                          got, want):
        assert float((a - b).norm() / b.norm()) <= 1e-5, name


def test_dropless_gate_fills_the_bound_and_computes_every_row():
    """A gate forced to send every token to held experts (k 3, two of the
    eight held, so each token sends min(k, held) = 2 rows here) fills the
    T min(k, held) bound, every row is computed as the plain layer computes
    it with the same choices, and the counters say so."""
    cfg = tiny_cfg(held=(5, 2))
    enc = ds.DeepseekV2Encoder(cfg)
    init_flax_(enc, torch.Generator().manual_seed(4))
    layer = enc.moe_layers()[0]
    T = 50
    x = torch.randn(T, 64, generator=torch.Generator().manual_seed(6))
    other = torch.randint(0, 5, (T, 1), generator=torch.Generator()
                          .manual_seed(7))
    ids = torch.cat([torch.full((T, 1), 6), other, torch.full((T, 1), 5)],
                    1)
    scores = torch.softmax(x @ layer.gate.T, -1)
    layer.route = lambda x_: (scores.gather(1, ids), ids)
    got = layer.routed(x)
    held_rows, buffer, most = enc.moe_counters.tolist()
    assert held_rows == T * 2 and most == T
    assert buffer == moe.buffer_rows(T, 3, 2)
    P = {"l.mlp.gate": layer.gate.detach(),
         "l.mlp.experts.gate_up": layer.experts.gate_up.detach()
         .reshape(-1, 64),
         "l.mlp.experts.down": layer.experts.down.detach().reshape(-1, 24)}
    for n in ("gate_proj", "up_proj", "down_proj"):
        P[f"l.mlp.shared_experts.{n}.weight"] = torch.zeros_like(
            getattr(layer.shared_experts, n).weight)
    want = plain.moe(P, "l.", hf_keys(cfg), x, (5, 2), force=ids)
    torch.testing.assert_close(got.detach(), want, atol=1e-6, rtol=0)
    assert bool((got.abs().sum(1) > 0).all())


def test_epoch_step_reads_the_moe_counters_with_the_losses():
    """The eager epoch step (CPU) over two batches: its one fetch gives the
    losses and the counters of the epoch, which equal the plans' counts."""
    cfg = carel_cfg(tiny_cfg())
    state, _ = port_and_plain_states(cfg)
    arrays = pair_arrays(2 * B, seed=3)
    stacked = stack_epoch(arrays, B)
    layer_ids = []
    for m in state.model.encoder.moe_layers():
        m.record = layer_ids
    step = make_epoch_step(cfg)
    losses = step.fetch(step(state, stacked, 0.0))
    assert losses.shape == (2,) and np.isfinite(losses).all()
    first, held = HELD
    want = sum(int(((ids >= first) & (ids < first + held)).sum())
               for ids in layer_ids)
    counts = step.moe_counts
    assert counts["held_rows"] == want and counts["steps"] == 2
    assert counts["layers"] == 2 and len(layer_ids) == 4
    assert counts["buffer_rows"] == 4 * moe.buffer_rows(B * L, 3, held)
    assert 0 < counts["max_expert_rows"] <= B * L


def test_a_frozen_router_takes_no_gradient_and_stays():
    """Gates taken out of training (``requires_grad_(False)`` before the
    TrainState is made, as the benchmark freezes its random gates) take no
    gradient and keep their values over two steps of the epoch step, while
    the experts and the rest train."""
    cfg = carel_cfg(tiny_cfg())
    model = DrlModel(cfg.model)
    init_flax_(model, torch.Generator().manual_seed(3))
    model.encoder.load_state_dict(port_state(model.encoder,
                                             seeded(cfg.model.encoder)))
    for m in model.encoder.moe_layers():
        m.gate.requires_grad_(False)
    state = create_train_state(cfg, model, torch.Generator().manual_seed(5))
    gates = [m.gate.detach().clone()
             for m in state.model.encoder.moe_layers()]
    experts = state.model.encoder.moe_layers()[0].experts.gate_up
    before = experts.detach().clone()
    stacked = stack_epoch(pair_arrays(2 * B, seed=5), B)
    make_epoch_step(cfg)(state, stacked, 0.0)
    for m, g in zip(state.model.encoder.moe_layers(), gates):
        assert m.gate.grad is None and torch.equal(m.gate, g)
    assert not torch.equal(experts, before)


def test_tensor_parallel_mesh_refuses_the_encoder():
    from carel_tpu_torch.parallel.tp import shard_params_tp

    model = DrlModel(carel_cfg(tiny_cfg()).model)
    with pytest.raises(NotImplementedError, match="DeepSeek-V2"):
        shard_params_tp(object(), model)


def test_yarn_tables_match_the_published_formula():
    """The port's YaRN frequencies and softmax scale at the published
    DeepSeek-V2-Lite settings against the plain tables."""
    cfg = DeepseekV2Config()
    cos, sin = ds.rope_cos_sin(cfg, 96, CPU)
    c = hf_keys(cfg)
    pc, ps, scale = plain.rope_tables(c, 96, CPU)
    torch.testing.assert_close(cos, pc, atol=1e-6, rtol=0)
    torch.testing.assert_close(sin, ps, atol=1e-6, rtol=0)
    m = 0.1 * 0.707 * math.log(40) + 1
    assert math.isclose(ds.softmax_scale(cfg), 192 ** -0.5 * m * m,
                        rel_tol=1e-12)
    assert math.isclose(scale, ds.softmax_scale(cfg), rel_tol=1e-12)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the expert kernels have no CPU "
                    "mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_captured_epoch_step_is_bit_equal_to_the_eager_one(cuda):
    """Two epochs of three batches of the tiny encoder in bf16 on the card,
    with head dropout: the captured epoch step (one capture, six replays)
    and the eager per-step loop from equal states and generators give the
    same losses, parameters and counters, bit for bit, and each replay ran
    the expert kernels."""
    from carel_tpu_torch import ops
    from carel_tpu_torch.train.state import dropout_generator

    cfg = carel_cfg(tiny_cfg(dtype="bfloat16"))
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, dropout=0.3))

    def state():
        torch.manual_seed(0)
        model = DrlModel(cfg.model)
        init_flax_(model, torch.Generator().manual_seed(3))
        model.to(cuda)
        return create_train_state(
            cfg, model, torch.Generator(device=cuda).manual_seed(5))

    arrays = pair_arrays(3 * B, seed=4)
    epochs = [stack_epoch(arrays, B, np.random.default_rng(e))
              for e in range(2)]
    a, b = state(), state()
    step, eager = make_epoch_step(cfg), make_train_step(cfg)
    dropout = dropout_generator(cuda)
    got, want, counts = [], [], []
    for stacked in epochs:
        start = dropout.get_state()
        got.append(step.fetch(step(a, stacked, 0.0)))
        counts.append(dict(step.moe_counts))
        end = dropout.get_state()
        dropout.set_state(start)
        b.model.encoder.moe_counters.zero_()
        want.append(torch.stack([eager(b, {k: torch.from_numpy(v[i]).to(
            cuda) for k, v in stacked.items()}, i)["loss"]
            for i in range(3)]).cpu().numpy())
        assert torch.equal(dropout.get_state(), end)
        eager_counts = b.model.encoder.moe_counters.tolist()
        assert eager_counts == [counts[-1]["held_rows"],
                                counts[-1]["buffer_rows"],
                                counts[-1]["max_expert_rows"]]
    assert step.captures == 1 and step.replays == 6
    np.testing.assert_array_equal(np.concatenate(got), np.concatenate(want))
    for (n, p), q in zip(a.model.named_parameters(), b.model.parameters()):
        assert torch.equal(p, q), n
    # a mixture layer a step: two products forward, two for the input's
    # gradient, two weight gradients
    assert step.captured_launches["expert_gemm"] == 2 * 4
    assert step.captured_launches["expert_gemm_wgrad"] == 2 * 2
    # and the row passes: the gather forward and twice backward, the
    # SwiGLU forward and again backward, its derivative, the combine
    # forward and of the input's gradient, the weights' gradient
    for name, n in (("moe_gather", 3), ("moe_swiglu", 2),
                    ("moe_swiglu_bwd", 1), ("moe_combine", 2),
                    ("moe_row_dot", 1)):
        assert step.captured_launches[name] == n * 2, name
    assert ops.launch_counts()["expert_gemm"] >= 6 * 8
