"""One training step of the port against the JAX step, from identical
params and batch, on the CPU at tiny widths, for the mmd and the hsic
regularizers. The hsic case runs as the ec_hsic preset does, with the binary
emotion head, and with emo_mul_loss_weight != cau_mul_loss_weight, so that
the cause term taking the EMOTION weight under hsic is held. The mmd_flash
case sets attention_impl="flash" on both sides: the port takes the plain
flash attention (segment mask, no dropout on the probabilities), JAX takes
its XLA attention on the CPU; with dropout 0 the pooled output, and so the
loss and every gradient, are the same function of the params.

JAX side: value_and_grad over model.apply(deterministic=True, sample=False,
compute_recon=False) + vae_and_classifier_loss(ops_impl="pallas", fused MMD
or HSIC and BoW in interpret mode) + create_train_state(...).apply_main. Port side:
make_train_step with dropout 0 and zero sampling noise, which is sample=False
(z = mu + 0 * exp(log_var), and no gradient reaches log_var through z).

Tolerances: loss and every metric rtol 1e-5, the KL terms after dividing out
their annealing weight (at iteration 0 the JAX package computes it as an
fp32 1 + tanh(-4.5) = 2.5e-4, which keeps ~2.4e-4 relative precision; the
port computes it in double); gradients normwise relative error 1e-4; Adam's
first and second moments against optax's mu and nu, normwise relative error
1e-4 and 2e-4 (nu is quadratic in g); params after the step atol 2 * vae_lr
everywhere, because Adam's first update is lr * g / (|g| + 1e-8) and flips
sign for a gradient at rounding level, and atol 1e-3 * vae_lr where
|g| > 1e-3 * max|g| of its tensor, where the sign is safe: a zero step, plain
SGD, another lr or eps inside the sqrt all fail there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from carel_tpu.config import CarelConfig as JCarelConfig
from carel_tpu.config import DataConfig as JDataConfig
from carel_tpu.config import LossConfig as JLossConfig
from carel_tpu.config import ModelConfig as JModelConfig
from carel_tpu.config import Regularizer as JRegularizer
from carel_tpu.config import TrainConfig as JTrainConfig
from carel_tpu.losses.vae import annealed_kl_weight as j_kl_weight
from carel_tpu.models.drl import DrlModel as JDrlModel
from carel_tpu.models.encoder import tiny_encoder_config as j_tiny
from carel_tpu.train.state import create_train_state as j_create_state
from carel_tpu.train.steps import vae_and_classifier_loss as j_loss

from carel_tpu_torch.config import CarelConfig, DataConfig, LossConfig
from carel_tpu_torch.config import ModelConfig, Regularizer, TrainConfig
from carel_tpu_torch.convert import jax_params_to_state_dict
from carel_tpu_torch.losses.vae import annealed_kl_weight
from carel_tpu_torch.models.drl import DrlModel
from carel_tpu_torch.models.encoder import tiny_encoder_config
from carel_tpu_torch.train.state import MAIN, create_train_state
from carel_tpu_torch.train.steps import batch_to_device, make_train_step

VOCAB, BOW, EC, B, L = 128, 300, 8, 8, 16
LR = 1e-3


def _cfgs(case: str):
    reg, _, impl = case.partition("_")
    enc = dict(vocab_size=VOCAB, dropout=0.0, attention_impl=impl or "xla")
    binary = reg == "hsic"
    # unequal emotion and cause weights tell the hsic weighting apart
    loss = dict(emo_mul_loss_weight=7.0, cau_mul_loss_weight=3.0) \
        if reg == "hsic" else {}
    j = JCarelConfig(
        model=JModelConfig(encoder=j_tiny(**enc), ec_dim=EC, bow_dim=BOW,
                           dropout=0.0, binary_emotion=binary),
        loss=JLossConfig(regularizer=JRegularizer(reg), **loss),
        data=JDataConfig(max_len=L),
        train=JTrainConfig(batch_size=B, vae_lr=LR, donate=False))
    t = CarelConfig(
        model=ModelConfig(encoder=tiny_encoder_config(**enc), ec_dim=EC,
                          bow_dim=BOW, dropout=0.0, binary_emotion=binary),
        loss=LossConfig(regularizer=Regularizer(reg), **loss),
        data=DataConfig(max_len=L),
        train=TrainConfig(batch_size=B, vae_lr=LR))
    return j, t


def _batch(seed=3):
    rng = np.random.default_rng(seed)
    mask = np.ones((B, L), np.int32)
    mask[2, 9:] = 0
    idx = rng.integers(0, BOW, (B, 6)).astype(np.int32)
    idx[:, -2:] = -1
    idx[1, 1] = idx[1, 0]
    wts = np.where(idx >= 0, 0.25, 0.0).astype(np.float32)
    ex_mask = np.ones(B, np.float32)
    ex_mask[-2:] = 0.0
    return {
        "input_ids": (rng.integers(2, VOCAB, (B, L)) * mask).astype(np.int32),
        "attention_mask": mask,
        "token_type_ids": np.zeros((B, L), np.int32),
        "pair_labels": np.array([1, 0, 1, 0, 0, 1, 1, 0], np.float32),
        "emotion_labels": rng.integers(0, 6, B).astype(np.int32),
        "bow_indices": idx,
        "bow_weights": wts,
        "example_mask": ex_mask,
    }


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _adam_moments(opt_state, params):
    """optax's Adam mu and nu as full trees, zeros where the group mask
    leaves a MaskedNode."""
    adam = jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
    adam = [a for a in adam if isinstance(a, optax.ScaleByAdamState)]
    assert len(adam) == 1

    def fill(m, p):
        if isinstance(m, optax.MaskedNode):
            return np.zeros_like(np.asarray(p))
        return np.asarray(m)

    masked = lambda x: isinstance(x, optax.MaskedNode)
    return tuple(jax.tree_util.tree_map(fill, t, params, is_leaf=masked)
                 for t in (adam[0].mu, adam[0].nu))


@pytest.fixture(scope="module", params=["mmd", "hsic", "mmd_flash"])
def both_steps(request):
    jcfg, tcfg = _cfgs(request.param)
    batch = _batch()
    jm = JDrlModel(jcfg.model)
    params = jm.init({"params": jax.random.key(0), "sample": jax.random.key(1)},
                     batch["input_ids"], batch["attention_mask"],
                     batch["token_type_ids"])["params"]
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def loss_fn(p):
        out = jm.apply({"params": p}, jb["input_ids"], jb["attention_mask"],
                       jb["token_type_ids"], deterministic=True, sample=False,
                       compute_recon=False)
        return j_loss(jcfg, out, jb, 0, ops_impl="pallas",
                      decoder_params=p["heads"]["decoder"])

    (_, j_metrics), j_grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
    j_state = j_create_state(jcfg, params, jax.random.key(2)).apply_main(
        j_grads)
    j_mu, j_nu = _adam_moments(j_state.main_opt_state, _np(params))

    model = DrlModel(tcfg.model)
    model.load_state_dict(jax_params_to_state_dict(_np(params)))
    before = {k: v.detach().clone() for k, v in model.state_dict().items()}
    state = create_train_state(tcfg, model, torch.Generator())
    zeros = torch.zeros(EC)
    t_metrics = make_train_step(tcfg)(
        state, batch_to_device(batch, torch.device("cpu")), 0,
        eps=(zeros, zeros))
    return dict(
        j_metrics=_np(j_metrics),
        j_grads=jax_params_to_state_dict(_np(j_grads)),
        j_after=jax_params_to_state_dict(_np(j_state.params)),
        j_mu=jax_params_to_state_dict(j_mu),
        j_nu=jax_params_to_state_dict(j_nu),
        t_metrics={k: float(v) for k, v in t_metrics.items()},
        state=state, before=before, reg=request.param)


def test_loss_and_metrics_match(both_steps):
    jm, tm = both_steps["j_metrics"], both_steps["t_metrics"]
    lc = LossConfig()
    j_w = float(j_kl_weight(0, lc.kl_ann_iterations, lc.ec_kl_lambda))
    t_w = annealed_kl_weight(0, lc.kl_ann_iterations, lc.ec_kl_lambda)
    np.testing.assert_allclose(t_w, j_w, rtol=3e-4)
    assert set(jm) == set(tm)
    for k in jm:
        want, got = float(jm[k]), tm[k]
        if k.startswith("kl_"):
            want, got = want / j_w, got / t_w
        np.testing.assert_allclose(got, want, rtol=1e-5, err_msg=k)
    assert tm["reg_loss"] != 0.0 and tm["recon_loss"] > 0.0
    if both_steps["reg"] == "hsic":
        # the cause term takes the emotion weight: 7 * (emo + cau)
        rest = (tm["reg_loss"] + 30.0 * tm["pair_loss"] + tm["kl_emotion"]
                + tm["kl_cause"] + tm["recon_loss"])
        np.testing.assert_allclose(
            tm["loss"], rest + 7.0 * (tm["emo_loss"] + tm["cau_loss"]),
            rtol=1e-6)


def test_grads_match(both_steps):
    state, jg = both_steps["state"], both_steps["j_grads"]
    checked = 0
    for name, p in state.model.named_parameters():
        if state.labels[name] != MAIN:
            continue
        want = jg[name]
        err = torch.linalg.vector_norm(p.grad - want)
        assert float(err) <= 1e-4 * float(torch.linalg.vector_norm(want)), name
        checked += 1
    assert checked > 20


@pytest.mark.parametrize("moment, key, tol", [
    ("exp_avg", "j_mu", 1e-4), ("exp_avg_sq", "j_nu", 2e-4)])
def test_adam_moments_match(both_steps, moment, key, tol):
    state, want_all = both_steps["state"], both_steps[key]
    checked = 0
    for name, p in state.model.named_parameters():
        if state.labels[name] != MAIN:
            assert p not in state.optimizer.state, name
            continue
        got, want = state.optimizer.state[p][moment], want_all[name]
        err = torch.linalg.vector_norm(got - want)
        assert float(err) <= tol * float(torch.linalg.vector_norm(want)), name
        checked += 1
    assert checked > 20


def test_params_after_step_match(both_steps):
    state, after = both_steps["state"], both_steps["j_after"]
    grads = both_steps["j_grads"]
    tight = 0
    for name, p in state.model.named_parameters():
        torch.testing.assert_close(p.detach(), after[name], rtol=0,
                                   atol=2 * LR, msg=name)
        if state.labels[name] != MAIN:
            continue
        g = grads[name].abs()
        safe = g > 1e-3 * g.max()
        torch.testing.assert_close(p.detach()[safe], after[name][safe],
                                   rtol=0, atol=1e-3 * LR, msg=name)
        tight += int(safe.sum())
    assert tight > 1000


def test_frozen_heads_and_disc_club_unchanged(both_steps):
    state, before = both_steps["state"], both_steps["before"]
    moved, still = 0, 0
    for name, p in state.model.named_parameters():
        delta = float((p.detach() - before[name]).abs().max())
        if state.labels[name] == MAIN:
            moved += delta > 0
        else:
            assert delta == 0.0, name
            still += 1
    assert moved > 20
    # four latent heads (weight+bias) + two discs + the club's four layers
    assert still == 8 + 4 + 8
    assert not state.model.heads.emotion_mu.weight.requires_grad
