"""The port's encoder and DrlModel against the JAX ones, from the same
weights (carel_tpu_torch.convert), in fp32 at tiny widths with dropout 0.
Tolerance: atol 1e-5 on every output (both sides compute in fp32; the sums
run in another order). One test runs a bf16 attention layer and one the
whole bf16 encoder, each with its own tolerance."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from carel_tpu.config import ModelConfig as JModelConfig
from carel_tpu.models.drl import DrlModel as JDrlModel
from carel_tpu.models.encoder import TransformerEncoder as JEncoder
from carel_tpu.models.encoder import tiny_encoder_config as j_tiny

from carel_tpu_torch.config import CarelConfig, DataConfig, LossConfig
from carel_tpu_torch.config import ModelConfig, Regularizer
from carel_tpu_torch.convert import jax_params_to_state_dict
from carel_tpu_torch.models.drl import DrlModel
from carel_tpu_torch.models.encoder import TransformerEncoder, init_flax_
from carel_tpu_torch.models.encoder import tiny_encoder_config
from carel_tpu_torch.data.batching import PairArrays, cut_batch
from carel_tpu_torch.models.heads import sample_prior
from carel_tpu_torch.pipeline import init_state
from carel_tpu_torch.train.loop import evaluate
from carel_tpu_torch.train.steps import make_eval_step, make_train_step

VOCAB, BOW, EC = 128, 64, 8


def _configs(arch):
    kw = dict(vocab_size=VOCAB, dropout=0.0, arch=arch, pad_token_id=1)
    jc = JModelConfig(encoder=j_tiny(**kw), ec_dim=EC, bow_dim=BOW,
                      dropout=0.0)
    tc = ModelConfig(encoder=tiny_encoder_config(**kw), ec_dim=EC,
                     bow_dim=BOW, dropout=0.0)
    return jc, tc


def _inputs(seed=0, B=4, L=16):
    rng = np.random.default_rng(seed)
    ids = rng.integers(2, VOCAB, (B, L)).astype(np.int32)
    mask = np.ones((B, L), np.int32)
    mask[1, 10:] = 0
    mask[3, 5:] = 0
    ids[mask == 0] = 1
    types = np.zeros((B, L), np.int32)
    types[:, L // 2:] = 1
    return ids, mask, types


def _np_params(variables):
    return jax.tree_util.tree_map(np.asarray, variables["params"])


@pytest.mark.parametrize("arch", ["bert", "roberta"])
def test_encoder_matches_jax(arch):
    jc, tc = _configs(arch)
    ids, mask, types = _inputs()
    jenc = JEncoder(jc.encoder)
    variables = jenc.init(jax.random.key(0), ids, mask, types)
    j_hidden, j_pooled = jenc.apply(variables, ids, mask, types,
                                    deterministic=True)
    tenc = TransformerEncoder(tc.encoder)
    tenc.load_state_dict(jax_params_to_state_dict(_np_params(variables)))
    with torch.no_grad():
        t_hidden, t_pooled = tenc(torch.tensor(ids), torch.tensor(mask),
                                  torch.tensor(types))
    np.testing.assert_allclose(t_hidden.numpy(), np.asarray(j_hidden),
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(t_pooled.numpy(), np.asarray(j_pooled),
                               atol=1e-5, rtol=0)


@pytest.mark.parametrize("scale", [1.0, 4.0])
def test_bf16_attention_scores_accumulate_in_fp32(scale):
    """One bf16 self-attention layer of the tiny encoder, JAX against the
    port, on the same bf16 input and converted weights, dropout 0. JAX sums
    q @ k^T into fp32 (preferred_element_type); rounding the scores to bf16
    before the softmax, as the port once did under autocast, gave a
    normwise relative error of 4.3e-3 (scale 1) and 6.0e-3 (scale 4) on the
    attention output; with fp32 scores the error is 0.0 at both scales.
    Tolerance 1e-3, between the two."""
    from carel_tpu.models.encoder import SelfAttention as JSelfAttention

    from carel_tpu_torch.models.encoder import SelfAttention

    kw = dict(vocab_size=VOCAB, dropout=0.0, dtype="bfloat16")
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.normal(size=(4, 16, 64)) * scale, jnp.bfloat16)
    mask = np.ones((4, 16), np.float32)
    mask[1, 10:] = 0.0
    bias = ((1.0 - mask) * -1e9)[:, None, None, :]
    jattn = JSelfAttention(j_tiny(**kw))
    variables = jattn.init(jax.random.key(0), x, jnp.asarray(bias), True)
    want = np.asarray(jattn.apply(variables, x, jnp.asarray(bias), True)
                      .astype(jnp.float32))
    tattn = SelfAttention(tiny_encoder_config(**kw))
    tattn.load_state_dict(jax_params_to_state_dict(_np_params(variables)))
    with torch.no_grad(), torch.autocast("cpu", dtype=torch.bfloat16):
        got = tattn(torch.tensor(np.asarray(x.astype(jnp.float32)))
                    .bfloat16(), torch.tensor(bias), True)
    got = got.float().numpy()
    err = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert err <= 1e-3, err


@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_bf16_encoder_against_jax(impl):
    """The whole tiny bf16 encoder against JAX's bf16 encoder (which takes
    its XLA attention on the CPU) from the same weights, dropout 0, at real
    positions. The two frameworks round to bf16 at different places (fused
    bias adds, each Linear's output, where the probabilities are rounded),
    so they differ by about as much as each differs from the fp32 encoder.
    Measured normwise relative errors over seeds 0-2 at [4, 16] and [8, 32]:
    port vs JAX bf16 7.9e-3 to 8.9e-3 (hidden) and 8.3e-3 to 1.06e-2
    (pooled), with either attention path; JAX bf16 vs JAX fp32 6.9e-3 to
    8.9e-3; port bf16 vs JAX fp32 6.3e-3 to 9.2e-3. Tolerances: 1.5e-2
    against JAX's bf16, and 1.2e-2 against JAX's fp32 (the port's bf16 is
    no farther from the fp32 values than JAX's own bf16 is, within a
    third)."""
    kw = dict(vocab_size=VOCAB, dropout=0.0, dtype="bfloat16")
    ids, mask, types = _inputs(seed=1)
    jenc = JEncoder(j_tiny(**kw))
    variables = jenc.init(jax.random.key(1), ids, mask, types)
    want16 = jenc.apply(variables, ids, mask, types, deterministic=True)
    want32 = JEncoder(j_tiny(**dict(kw, dtype="float32"))).apply(
        variables, ids, mask, types, deterministic=True)
    tenc = TransformerEncoder(tiny_encoder_config(attention_impl=impl, **kw))
    tenc.load_state_dict(jax_params_to_state_dict(_np_params(variables)))
    with torch.no_grad():
        got = tenc(torch.tensor(ids), torch.tensor(mask), torch.tensor(types))
    assert got[0].dtype == torch.bfloat16
    real = mask.astype(bool)

    def err(a, b, rows):
        a = a.float().numpy()[rows]
        b = np.asarray(b.astype(jnp.float32))[rows]
        return np.linalg.norm(a - b) / np.linalg.norm(b)

    for name, g, w16, w32, rows in (
            ("hidden", got[0], want16[0], want32[0], real),
            ("pooled", got[1], want16[1], want32[1], slice(None))):
        assert err(g, w16, rows) <= 1.5e-2, name
        assert err(g, w32, rows) <= 1.2e-2, name


@pytest.mark.parametrize("arch", ["bert", "roberta"])
def test_drl_model_matches_jax_on_every_key(arch):
    jc, tc = _configs(arch)
    ids, mask, types = _inputs(seed=1)
    jm = JDrlModel(jc)
    variables = jm.init({"params": jax.random.key(3),
                         "sample": jax.random.key(4)}, ids, mask, types)
    j_out = jm.apply(variables, ids, mask, types, deterministic=True,
                     sample=False)
    tm = DrlModel(tc)
    tm.load_state_dict(jax_params_to_state_dict(_np_params(variables)),
                       strict=True)
    with torch.no_grad():
        t_out = tm(torch.tensor(ids), torch.tensor(mask), torch.tensor(types),
                   deterministic=True, sample=False)
        # the aux outputs that the gan and vi train steps add
        t_out.update(tm.gan_outputs(t_out, deterministic=True))
        t_out.update(tm.club_approx_outputs(t_out["z_cause"]))
        t_out.update(tm.club_bound_outputs(t_out["z_cause"]))
    assert set(t_out) == set(j_out)
    for key in j_out:
        np.testing.assert_allclose(t_out[key].numpy(), np.asarray(j_out[key]),
                                   atol=1e-5, rtol=0, err_msg=key)


AUX_KEYS = {"disc": {"ec_disc_logits_sg", "ce_disc_logits_sg",
                     "ec_disc_logits", "ce_disc_logits"},
            "club": {"club_mu_sg", "club_lv_sg", "club_mu", "club_lv"}}


def _aux_calls(model):
    """Forward-hook counters of the discriminators' and the CLUB net's
    calls."""
    calls = {"disc": 0, "club": 0}
    for name, mod in (("disc", model.ec_disc), ("disc", model.ce_disc),
                      ("club", model.club)):
        mod.register_forward_hook(
            lambda *_, name=name: calls.__setitem__(name, calls[name] + 1))
    return calls


def _regularizer_model(reg):
    """The tiny model as init_state builds it for a run of ``reg``."""
    _, tc = _configs("bert")
    cfg = CarelConfig(model=tc, loss=LossConfig(regularizer=Regularizer(reg)),
                      data=DataConfig(max_len=16))
    return cfg, init_state(cfg, "cpu")


@pytest.mark.parametrize("deterministic", [True, False])
@pytest.mark.parametrize("reg", ["none", "mmd", "hsic", "gan", "vi"])
def test_aux_networks_run_only_for_the_regularizer_that_reads_them(
        reg, deterministic):
    """The forward never runs the discriminators or the CLUB net, under any
    regularizer, in eval or training mode (where their dropout would draw
    too): the gan and vi train steps add their own aux outputs
    (test_aux_networks_run_in_the_train_step_only). A forward hook counts
    the calls, and the aux keys are absent."""
    _, state = _regularizer_model(reg)
    tm = state.model
    calls = _aux_calls(tm)
    ids, mask, types = _inputs(seed=2)
    out = tm(torch.tensor(ids), torch.tensor(mask), torch.tensor(types),
             deterministic=deterministic, sample=True,
             generator=torch.Generator().manual_seed(0))
    assert calls == {"disc": 0, "club": 0}
    assert not set().union(*AUX_KEYS.values()) & set(out)
    assert "pair_logits" in out


@pytest.mark.parametrize("reg,step_runs", [
    ("gan", {"disc": 4, "club": 0}), ("vi", {"disc": 0, "club": 2})])
def test_aux_networks_run_in_the_train_step_only(reg, step_runs):
    """Under gan and vi, evaluate and pair_probabilities call neither the
    discriminators nor the CLUB net; the train step calls its own: the
    discriminators twice each (detached and live latents), the CLUB net
    twice (phase 1 on the detached latent, phase 2 on the live one)."""
    cfg, state = _regularizer_model(reg)
    model = state.model
    calls = _aux_calls(model)
    ids, mask, types = _inputs(seed=2)
    rng = np.random.default_rng(0)
    n = 6
    arrays = PairArrays(
        input_ids=np.resize(ids, (n, ids.shape[1])),
        attention_mask=np.resize(mask, (n, mask.shape[1])),
        token_type_ids=np.resize(types, (n, types.shape[1])),
        pair_labels=(np.arange(n) % 2).astype(np.float32),
        emotion_labels=rng.integers(0, 6, n).astype(np.int32),
        temporal_order=np.zeros(n, bool),
        bow_indices=rng.integers(0, BOW, (n, 4)).astype(np.int32),
        bow_weights=np.full((n, 4), 0.25, np.float32))
    gen = torch.Generator().manual_seed(0)
    res = evaluate(make_eval_step(), model, arrays, 0, gen, batch_size=4)
    assert res.probs.shape == (n,)
    model.pair_probabilities(torch.tensor(ids), torch.tensor(mask),
                             torch.tensor(types), generator=gen)
    assert calls == {"disc": 0, "club": 0}
    batch = {k: torch.from_numpy(v) for k, v in
             cut_batch(arrays, np.arange(4), 4).as_dict().items()}
    make_train_step(cfg)(state, batch, 0)
    assert calls == step_runs


@pytest.mark.parametrize("compat", [True, False])
def test_sample_prior_with_given_eps(compat):
    rng = np.random.default_rng(5)
    mu = torch.tensor(rng.normal(size=(6, EC)).astype(np.float32))
    lv = torch.tensor(rng.normal(size=(6, EC)).astype(np.float32) * 0.3)
    eps = torch.tensor(rng.normal(size=(EC,) if compat else (6, EC))
                       .astype(np.float32))
    z = sample_prior(mu, lv, compat=compat, eps=eps)
    if compat:  # one shared vector, std exp(log_var)
        want = mu.numpy() + eps.numpy()[None, :] * np.exp(lv.numpy())
    else:
        want = mu.numpy() + eps.numpy() * np.exp(0.5 * lv.numpy())
    np.testing.assert_allclose(z.numpy(), want, rtol=1e-6)


def test_sample_prior_draws_from_generator():
    mu = torch.zeros(3, EC)
    lv = torch.zeros(3, EC)
    a = sample_prior(mu, lv, generator=torch.Generator().manual_seed(0))
    b = sample_prior(mu, lv, generator=torch.Generator().manual_seed(0))
    torch.testing.assert_close(a, b)
    assert torch.equal(a[0], a[1])  # compat: shared across the batch


def test_flax_init_statistics():
    _, tc = _configs("bert")
    model = DrlModel(tc)
    init_flax_(model, torch.Generator().manual_seed(0))
    w = model.encoder.layers[0].mlp_in.weight.detach()  # [128, 64], fan_in 64
    assert abs(float(w.std()) - math.sqrt(1 / 64)) < 0.1 * math.sqrt(1 / 64)
    assert float(w.abs().max()) <= 2.0 * math.sqrt(1 / 64) / 0.8796256610342398
    emb = model.encoder.word_embeddings.weight.detach()  # N(0, 1/features)
    assert abs(float(emb.std()) - math.sqrt(1 / 64)) < 0.1 * math.sqrt(1 / 64)
    assert float(model.heads.decoder.bias.detach().abs().max()) == 0.0
    assert float((model.encoder.embeddings_ln.weight.detach() - 1).abs().max()) == 0.0


@pytest.mark.parametrize("lam", [1.0, 0.3])
def test_domain_discriminator_matches_jax(lam):
    """DomainDiscriminator: the logits of seeded features from JAX's
    weights, and the features' gradient reversed (-lam times the
    forward's), as JAX's vjp gives it."""
    from carel_tpu.models.discriminators import \
        DomainDiscriminator as JDomainDiscriminator

    from carel_tpu_torch.models import DomainDiscriminator

    feats = np.random.default_rng(4).normal(size=(6, 16)).astype(np.float32)
    up = np.random.default_rng(5).normal(size=(6, 1)).astype(np.float32)
    jd = JDomainDiscriminator(hidden_dim=12, grl_lambda=lam)
    params = jd.init(jax.random.key(0), jnp.asarray(feats))["params"]
    logits, vjp = jax.vjp(lambda x: jd.apply({"params": params}, x),
                          jnp.asarray(feats))
    (j_grad,) = vjp(jnp.asarray(up))

    td = DomainDiscriminator(16, hidden_dim=12, grl_lambda=lam)
    td.load_state_dict(jax_params_to_state_dict(
        jax.tree_util.tree_map(np.asarray, params)))
    x = torch.from_numpy(feats).requires_grad_(True)
    out = td(x)
    out.backward(torch.from_numpy(up))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(logits),
                               atol=1e-5)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(j_grad),
                               atol=1e-5)
    # reversed: the plain head's gradient times -lam
    x2 = torch.from_numpy(feats).requires_grad_(True)
    plain = td.out(torch.relu(td.fc2(torch.relu(td.fc1(x2)))))
    plain.backward(torch.from_numpy(up))
    np.testing.assert_allclose(x.grad.numpy(), -lam * x2.grad.numpy(),
                               rtol=1e-6, atol=1e-7)
