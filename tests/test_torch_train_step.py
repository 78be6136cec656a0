"""One training step of the port against the JAX step, from identical
params and batch, on the CPU at tiny widths, for the mmd, hsic, gan and vi
regularizers. The hsic and gan cases run as the ec_hsic and ec_gan presets
do, with the binary emotion head, and with emo_mul_loss_weight !=
cau_mul_loss_weight, so that the cause term taking the EMOTION weight under
hsic and gan is held. The mmd_flash
case sets attention_impl="flash" on both sides: the port takes the plain
flash attention (segment mask, no dropout on the probabilities), JAX takes
its XLA attention on the CPU; with dropout 0 the pooled output, and so the
loss and every gradient, are the same function of the params.

JAX side: value_and_grad over model.apply(deterministic=True, sample=False,
compute_recon=False) + vae_and_classifier_loss(ops_impl="pallas", fused MMD
or HSIC and BoW in interpret mode) + create_train_state(...).apply_main, as
carel_tpu/train/steps.py composes them: under gan the disc BCEs join the
loss and apply_main(with_disc=True) steps the disc RMSprop too; under vi
club_aprx_loss's gradient goes to apply_club first, then the main loss with
vi_beta * club_upper_loss (its permutation from jax.random.permutation) is
taken at the updated params and apply_main(with_disc=False) steps. Port
side: make_train_step with dropout 0, zero sampling noise, which is
sample=False (z = mu + 0 * exp(log_var), and no gradient reaches log_var
through z), and the same permutation as ``perm``. The vi case's aprx_lr is
large enough that reading the club from before its update misses the loss
tolerance by far; test_vi_reads_the_updated_club asserts that gap.

Tolerances: loss and every metric rtol 1e-5, the KL terms after dividing out
their annealing weight (at iteration 0 the JAX package computes it as an
fp32 1 + tanh(-4.5) = 2.5e-4, which keeps ~2.4e-4 relative precision; the
port computes it in double); gradients normwise relative error 1e-4; Adam's
first and second moments against optax's mu and nu, normwise relative error
1e-4 and 2e-4 (nu is quadratic in g), and so the club Adam's and the disc
RMSprop's against optax's masked states; params after the step, per group
with its own lr, atol 2 * lr everywhere, because Adam's first update is
lr * g / (|g| + 1e-8) and flips sign for a gradient at rounding level, and
atol 1e-3 * lr where |g| > 1e-3 * max|g| of its tensor, where the sign is
safe: a zero step, plain SGD, another lr or eps inside the sqrt all fail
there.
"""

import functools

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
from carel_tpu.losses.registry import club_aprx_loss as j_club_aprx_loss
from carel_tpu.losses.registry import gan_disc_losses as j_gan_disc_losses
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
from carel_tpu_torch.train.state import CLUB, DISC, FROZEN, MAIN
from carel_tpu_torch.train.state import create_train_state
from carel_tpu_torch.train.steps import batch_to_device, make_train_step

VOCAB, BOW, EC, B, L = 128, 300, 8, 8, 16
LR = 1e-3
ADV_LR, APRX_LR = 2e-3, 5e-2  # disc RMSprop, club Adam
VI_BETA = 0.3
GROUP_LR = {MAIN: LR, DISC: ADV_LR, CLUB: APRX_LR}
# the groups each regularizer's step updates
UPDATED = {"gan": {MAIN, DISC}, "vi": {MAIN, CLUB}}


def _cfgs(case: str):
    reg, _, impl = case.partition("_")
    enc = dict(vocab_size=VOCAB, dropout=0.0, attention_impl=impl or "xla")
    binary = reg in ("hsic", "gan")
    # unequal emotion and cause weights tell the hsic and gan weighting apart
    loss = dict(emo_mul_loss_weight=7.0, cau_mul_loss_weight=3.0) \
        if binary else {}
    j = JCarelConfig(
        model=JModelConfig(encoder=j_tiny(**enc), ec_dim=EC, bow_dim=BOW,
                           dropout=0.0, binary_emotion=binary),
        loss=JLossConfig(regularizer=JRegularizer(reg), **loss),
        data=JDataConfig(max_len=L),
        train=JTrainConfig(batch_size=B, vae_lr=LR, adv_lr=ADV_LR,
                           aprx_lr=APRX_LR, donate=False))
    t = CarelConfig(
        model=ModelConfig(encoder=tiny_encoder_config(**enc), ec_dim=EC,
                          bow_dim=BOW, dropout=0.0, binary_emotion=binary),
        loss=LossConfig(regularizer=Regularizer(reg), **loss),
        data=DataConfig(max_len=L),
        train=TrainConfig(batch_size=B, vae_lr=LR, adv_lr=ADV_LR,
                          aprx_lr=APRX_LR))
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


def _moments(opt_state, params, state_type, fields):
    """One optax state's moments (``fields`` of its ``state_type``) as full
    trees, zeros where the group mask leaves a MaskedNode."""
    found = jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda x: isinstance(x, state_type))
    found = [a for a in found if isinstance(a, state_type)]
    assert len(found) == 1

    def fill(m, p):
        if isinstance(m, optax.MaskedNode):
            return np.zeros_like(np.asarray(p))
        return np.asarray(m)

    masked = lambda x: isinstance(x, optax.MaskedNode)
    return tuple(
        jax_params_to_state_dict(jax.tree_util.tree_map(
            fill, getattr(found[0], f), params, is_leaf=masked))
        for f in fields)


def _jax_step(jcfg, jm, params, jb, reg, state=None, iteration=0):
    """carel_tpu/train/steps.py's step for ``reg`` at sample=False and
    dropout 0, from ``state`` (a new state of ``params`` when None) at
    within-epoch batch index ``iteration``. Returns the metrics, the main
    loss's gradients, the vi phase-1 gradients (None otherwise), the state
    after the step, the vi permutation (None otherwise) and the vi loss at
    the club params from before the club update (None otherwise)."""
    mask = jb["example_mask"]
    if state is None:
        state = j_create_state(jcfg, params, jax.random.key(2))
    params = state.params

    def forward(p):
        return jm.apply({"params": p}, jb["input_ids"], jb["attention_mask"],
                        jb["token_type_ids"], deterministic=True,
                        sample=False, compute_recon=False)

    def loss_fn(p, reg_rng=None):
        out = forward(p)
        total, metrics = j_loss(jcfg, out, jb, iteration, reg_rng=reg_rng,
                                vi_beta=VI_BETA, ops_impl="pallas",
                                decoder_params=p["heads"]["decoder"])
        if reg == "gan":
            ec, ce = j_gan_disc_losses(out, jcfg.loss,
                                       jnp.ones_like(jb["pair_labels"]),
                                       jb["pair_labels"], mask)
            metrics["ec_disc_loss"] = ec
            metrics["ce_disc_loss"] = ce
            total = total + ec + ce
        return total, metrics

    aprx_grads = perm = stale_loss = None
    reg_rng = jax.random.key(5)
    if reg == "vi":
        aprx_grads = jax.grad(
            lambda p: j_club_aprx_loss(forward(p), mask))(params)
        stale_loss = float(loss_fn(params, reg_rng)[1]["loss"])
        state = state.apply_club(aprx_grads)
        perm = np.array(jax.random.permutation(reg_rng, B))
    (_, metrics), grads = jax.value_and_grad(
        lambda p: loss_fn(p, reg_rng), has_aux=True)(state.params)
    state = state.apply_main(grads, with_disc=reg == "gan")
    return metrics, grads, aprx_grads, state, perm, stale_loss


@functools.lru_cache(maxsize=None)
def _both_steps(case):
    """One step of each side from the same params and batch for ``case``
    (a regularizer, or mmd_flash)."""
    return run_both_steps(*_cfgs(case), case.partition("_")[0])


def run_both_steps(jcfg, tcfg, reg):
    """One step of each side from the same params (JAX's init, converted)
    and batch under the configs ``jcfg`` and ``tcfg`` of regularizer
    ``reg``; the record the tests below read."""
    batch = _batch()
    jm = JDrlModel(jcfg.model)
    params = jm.init({"params": jax.random.key(0), "sample": jax.random.key(1)},
                     batch["input_ids"], batch["attention_mask"],
                     batch["token_type_ids"])["params"]
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    j_metrics, j_grads, j_aprx, j_state, perm, stale = _jax_step(
        jcfg, jm, params, jb, reg)
    np_params = _np(params)
    j_mu, j_nu = _moments(j_state.main_opt_state, np_params,
                          optax.ScaleByAdamState, ("mu", "nu"))
    (j_disc_nu,) = _moments(j_state.disc_opt_state, np_params,
                            optax.ScaleByRmsState, ("nu",))
    j_club_mu, j_club_nu = _moments(j_state.club_opt_state, np_params,
                                    optax.ScaleByAdamState, ("mu", "nu"))

    model = DrlModel(tcfg.model)
    model.load_state_dict(jax_params_to_state_dict(np_params))
    before = {k: v.detach().clone() for k, v in model.state_dict().items()}
    state = create_train_state(tcfg, model, torch.Generator())
    zeros = torch.zeros(EC)
    t_metrics = make_train_step(tcfg)(
        state, batch_to_device(batch, torch.device("cpu")), 0,
        vi_beta=VI_BETA, eps=(zeros, zeros),
        perm=None if perm is None else torch.from_numpy(perm).long())
    j_grads = jax_params_to_state_dict(_np(j_grads))
    return dict(
        j_metrics=_np(j_metrics),
        j_grads=j_grads,
        # the gradient each group's optimizer stepped from
        j_step_grads=j_grads if j_aprx is None else {
            **j_grads, **{k: v for k, v in jax_params_to_state_dict(
                _np(j_aprx)).items() if state.labels.get(k) == CLUB}},
        j_after=jax_params_to_state_dict(_np(j_state.params)),
        j_mu=j_mu, j_nu=j_nu, j_disc_nu=j_disc_nu, j_club_mu=j_club_mu,
        j_club_nu=j_club_nu, stale_loss=stale,
        t_metrics={k: float(v) for k, v in t_metrics.items()},
        state=state, before=before, reg=reg)


@pytest.fixture(scope="module",
                params=["mmd", "hsic", "mmd_flash", "gan", "vi"])
def both_steps(request):
    return _both_steps(request.param)


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
    if both_steps["reg"] in ("hsic", "gan"):
        # the cause term takes the emotion weight: 7 * (emo + cau); under
        # gan the loss metric leaves out the disc BCEs, as in JAX
        rest = (tm["reg_loss"] + 30.0 * tm["pair_loss"] + tm["kl_emotion"]
                + tm["kl_cause"] + tm["recon_loss"])
        np.testing.assert_allclose(
            tm["loss"], rest + 7.0 * (tm["emo_loss"] + tm["cau_loss"]),
            rtol=1e-6)


def _updated(both_steps):
    return UPDATED.get(both_steps["reg"], {MAIN})


def test_grads_match(both_steps):
    """The main loss's gradients of the groups it steps (main, and disc
    under gan); a group the step does not update keeps no gradient."""
    state, jg = both_steps["state"], both_steps["j_grads"]
    checked = 0
    for name, p in state.model.named_parameters():
        label = state.labels[name]
        if label not in _updated(both_steps) or label == CLUB:
            assert p.grad is None, name
            continue
        want = jg[name]
        err = torch.linalg.vector_norm(p.grad - want)
        assert float(err) <= 1e-4 * float(torch.linalg.vector_norm(want)), name
        checked += 1
    assert checked > 20 + (4 if both_steps["reg"] == "gan" else 0)


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


@pytest.mark.parametrize("reg, group, moment, key, tol", [
    ("gan", DISC, "nu", "j_disc_nu", 2e-4),
    ("vi", CLUB, "exp_avg", "j_club_mu", 1e-4),
    ("vi", CLUB, "exp_avg_sq", "j_club_nu", 2e-4)])
def test_disc_and_club_optimizer_states_match(reg, group, moment, key, tol):
    """The disc RMSprop's nu (gan) and the club Adam's moments (vi) against
    optax's masked states, normwise; the other groups have no state in
    these optimizers, and the optimizer a step does not use has none."""
    run = _both_steps(reg)
    state, want_all = run["state"], run[key]
    opt = {DISC: state.disc_optimizer, CLUB: state.club_optimizer}
    checked = 0
    for name, p in state.model.named_parameters():
        for label, o in opt.items():
            if label != group or state.labels[name] != label:
                assert p not in o.state, name
        if state.labels[name] != group:
            continue
        got, want = opt[group].state[p][moment], want_all[name]
        err = torch.linalg.vector_norm(got - want)
        assert float(err) <= tol * float(torch.linalg.vector_norm(want)), name
        assert float(torch.linalg.vector_norm(want)) > 0.0, name
        checked += 1
    assert checked == {DISC: 4, CLUB: 8}[group]


def test_vi_reads_the_updated_club():
    """The vi case has teeth: its loss read with the club from before the
    club update misses the rtol 1e-5 of test_loss_and_metrics_match more than
    tenfold (35-fold at this aprx_lr)."""
    run = _both_steps("vi")
    want = float(run["j_metrics"]["loss"])
    assert abs(run["stale_loss"] - want) > 10 * 1e-5 * abs(want)
    np.testing.assert_allclose(run["t_metrics"]["loss"], want, rtol=1e-5)


def test_params_after_step_match(both_steps):
    """Per group with its own lr: atol 2 * lr everywhere, 1e-3 * lr where
    the group's step gradient is safe from a sign flip."""
    state, after = both_steps["state"], both_steps["j_after"]
    grads = both_steps["j_step_grads"]
    tight = 0
    for name, p in state.model.named_parameters():
        label = state.labels[name]
        lr = GROUP_LR.get(label, LR)
        torch.testing.assert_close(p.detach(), after[name], rtol=0,
                                   atol=2 * lr, msg=name)
        if label not in _updated(both_steps):
            continue
        g = grads[name].abs()
        safe = g > 1e-3 * g.max()
        torch.testing.assert_close(p.detach()[safe], after[name][safe],
                                   rtol=0, atol=1e-3 * lr, msg=name)
        tight += int(safe.sum())
    assert tight > 1000


def test_frozen_heads_and_disc_club_unchanged(both_steps):
    """The step moves the groups it updates (main; disc under gan; club
    under vi) and leaves the frozen heads and every other group as they
    were."""
    state, before = both_steps["state"], both_steps["before"]
    updated = _updated(both_steps)
    moved = {MAIN: 0, DISC: 0, CLUB: 0}
    still = 0
    for name, p in state.model.named_parameters():
        delta = float((p.detach() - before[name]).abs().max())
        label = state.labels[name]
        if label in updated:
            moved[label] += delta > 0
        else:
            assert delta == 0.0, name
            still += 1
    assert moved[MAIN] > 20
    assert moved[DISC] == (4 if DISC in updated else 0)
    assert moved[CLUB] == (8 if CLUB in updated else 0)
    # four latent heads (weight+bias) + two discs + the club's four layers,
    # less the groups this step updates
    assert still == 8 + (0 if DISC in updated else 4) \
        + (0 if CLUB in updated else 8)
    assert not state.model.heads.emotion_mu.weight.requires_grad
    assert state.labels["heads.emotion_mu.weight"] == FROZEN
