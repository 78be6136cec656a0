"""The gan and vi pieces of the port against the JAX package on the CPU:
the regularizer losses (entropy, CLUB approximation and upper bound, the
discriminator BCEs) on random inputs with masked rows, value rtol 1e-6 and
gradients normwise 1e-5; the disc RMSprop against optax.rmsprop over five
steps, params rtol 1e-6; the vi_beta ramp of train_epochs against JAX's
train_epochs; ``--self_lr`` (the JAX CLI's never reaches the optimizer, the
port's reaches the main Adam only); and ``train`` of ec_gan, ec_vi_final
and ec_mmd_self_chain end to end on a synthetic zh corpus.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from carel_tpu.config import CarelConfig as JCarelConfig
from carel_tpu.config import LossConfig as JLossConfig
from carel_tpu.config import ModelConfig as JModelConfig
from carel_tpu.config import Regularizer as JRegularizer
from carel_tpu.config import TrainConfig as JTrainConfig
from carel_tpu.data.batching import PairArrays as JPairArrays
from carel_tpu.losses import registry as jreg
from carel_tpu.losses.classify import entropy_loss as j_entropy_loss
from carel_tpu.models.drl import DrlModel as JDrlModel
from carel_tpu.models.encoder import tiny_encoder_config as j_tiny
from carel_tpu.train.loop import train_epochs as j_train_epochs
from carel_tpu.train.state import create_train_state as j_create_state
from carel_tpu.train.steps import make_train_step as j_make_train_step

import carel_tpu_torch.selftrain
from carel_tpu_torch.cli.main import main
from carel_tpu_torch.config import PRESETS, CarelConfig, LossConfig
from carel_tpu_torch.config import Regularizer, TrainConfig
from carel_tpu_torch.losses import registry as treg
from carel_tpu_torch.losses.classify import entropy_loss
from carel_tpu_torch.train.loop import train_epochs
from carel_tpu_torch.train.state import DiscRMSprop
from tests.test_torch_data import write_oldsplit_corpus
from tests.test_torch_loop import _pair_arrays

B, D = 10, 6


def _out(seed):
    """A DrlModel output dict's gan/vi entries, rows 7 and 9 masked."""
    rng = np.random.default_rng(seed)
    f = lambda *shape, s=1.0: (rng.normal(size=shape) * s).astype(np.float32)
    out = {"z_emotion": f(B, D), "club_mu": f(B, D), "club_mu_sg": f(B, D),
           "club_lv": np.tanh(f(B, D)), "club_lv_sg": np.tanh(f(B, D)),
           "ec_disc_logits": f(B, 1, s=3.0), "ce_disc_logits": f(B, 1, s=3.0),
           "ec_disc_logits_sg": f(B, 1, s=3.0),
           "ce_disc_logits_sg": f(B, 1, s=3.0)}
    mask = np.ones(B, np.float32)
    mask[[7, 9]] = 0.0
    labels = (np.arange(B) % 3 == 0).astype(np.float32)
    return out, mask, labels


PERM_KEY = jax.random.key(11)


def _perm():
    """jax.random.permutation(PERM_KEY, B) as the port's ``perm``."""
    return torch.from_numpy(np.array(jax.random.permutation(PERM_KEY, B)))


LOSSES = {
    "entropy": (
        lambda o, m, y: j_entropy_loss(o["ec_disc_logits"], 1e-8, m),
        lambda o, m, y: entropy_loss(o["ec_disc_logits"], 1e-8, m)),
    "club_aprx": (
        lambda o, m, y: jreg.club_aprx_loss(o, m),
        lambda o, m, y: treg.club_aprx_loss(o, m)),
    "club_upper": (
        lambda o, m, y: jreg.club_upper_loss(o, PERM_KEY, m),
        lambda o, m, y: treg.club_upper_loss(o, _perm(), m)),
    "gan_disc": (
        lambda o, m, y: sum(jreg.gan_disc_losses(
            o, JLossConfig(), jnp.ones_like(y), y, m)),
        lambda o, m, y: sum(treg.gan_disc_losses(
            o, LossConfig(), torch.ones_like(y), y, m))),
    # the whole gan and vi terms of regularizer_loss
    "regularizer_gan": (
        lambda o, m, y: jreg.regularizer_loss(
            o, JLossConfig(regularizer=JRegularizer.GAN,
                           ecce_adv_loss_weight=0.7), m),
        lambda o, m, y: treg.regularizer_loss(
            o, LossConfig(regularizer=Regularizer.GAN,
                          ecce_adv_loss_weight=0.7), m)),
    "regularizer_vi": (
        lambda o, m, y: jreg.regularizer_loss(
            o, JLossConfig(regularizer=JRegularizer.VI), m, rng=PERM_KEY,
            vi_beta=0.3),
        lambda o, m, y: treg.regularizer_loss(
            o, LossConfig(regularizer=Regularizer.VI), m, vi_beta=0.3,
            perm=_perm())),
}


@pytest.mark.parametrize("name", sorted(LOSSES))
def test_regularizer_losses_match_jax(name):
    """Value rtol 1e-6; the gradient to every input normwise 1e-5 (the JAX
    functions' stop_gradient inputs get none on either side); masked rows
    get exactly zero gradient."""
    j_fn, t_fn = LOSSES[name]
    out, mask, labels = _out(seed=len(name))
    j_val, j_grads = jax.value_and_grad(
        lambda o: j_fn(o, jnp.asarray(mask), jnp.asarray(labels)))(
        {k: jnp.asarray(v) for k, v in out.items()})
    t_out = {k: torch.tensor(v, requires_grad=True) for k, v in out.items()}
    t_val = t_fn(t_out, torch.from_numpy(mask), torch.from_numpy(labels))
    t_val.backward()
    np.testing.assert_allclose(t_val.item(), float(j_val), rtol=1e-6)
    assert t_val.item() != 0.0
    reached = 0
    for k, g in j_grads.items():
        g = np.asarray(g)
        got = t_out[k].grad
        got = np.zeros_like(g) if got is None else got.numpy()
        err = np.linalg.norm(got - g)
        assert err <= 1e-5 * np.linalg.norm(g), k
        if np.any(g != 0.0):
            reached += 1
            assert not np.any(got[[7, 9]]), k
    assert reached >= 1


def test_disc_rmsprop_matches_optax():
    """Five steps on gradients spanning 1e-6 to 1: the port's RMSprop, eps
    inside the sqrt, matches optax.rmsprop(adv_lr, decay=0.99, eps=1e-8)
    to rtol 1e-6, and torch.optim.RMSprop, eps outside the sqrt, misses
    that tolerance."""
    rng = np.random.default_rng(0)
    lr = 3e-3
    p0 = rng.normal(size=(4, 50)).astype(np.float32)
    scales = np.logspace(-6, 0, 50, dtype=np.float32)
    grads = [(rng.normal(size=(4, 50)) * scales).astype(np.float32)
             for _ in range(5)]

    tx = optax.rmsprop(lr, decay=0.99, eps=1e-8)
    j_p = jnp.asarray(p0)
    j_state = tx.init(j_p)
    for g in grads:
        upd, j_state = tx.update(jnp.asarray(g), j_state, j_p)
        j_p = optax.apply_updates(j_p, upd)
    want = np.asarray(j_p)

    def run(make):
        p = torch.nn.Parameter(torch.from_numpy(p0.copy()))
        opt = make([p])
        for g in grads:
            p.grad = torch.from_numpy(g)
            opt.step()
        return p.detach().numpy(), opt

    got, opt = run(lambda ps: DiscRMSprop(ps, lr=lr, decay=0.99, eps=1e-8))
    np.testing.assert_allclose(got, want, rtol=1e-6)
    nu = np.asarray(j_state[0].nu)
    np.testing.assert_allclose(
        next(iter(opt.state.values()))["nu"].numpy(), nu, rtol=1e-6)
    other, _ = run(lambda ps: torch.optim.RMSprop(ps, lr=lr, alpha=0.99,
                                                  eps=1e-8))
    with pytest.raises(AssertionError):
        np.testing.assert_allclose(other, want, rtol=1e-6)


def test_disc_rmsprop_skips_params_without_grad():
    p = torch.nn.Parameter(torch.ones(3))
    opt = DiscRMSprop([p], lr=0.1)
    opt.step()
    assert torch.equal(p.detach(), torch.ones(3)) and not opt.state


@pytest.mark.parametrize("vi_beta_step", [0.1, 0.15])
def test_train_epochs_vi_beta_ramp_matches_jax(tmp_path, vi_beta_step):
    """A recording step sees, on every step of every epoch, the vi_beta that
    JAX's train_epochs gives its step over 9 epochs (the cap at 1 reached
    for vi_beta_step 0.15)."""
    epochs, n = 9, 20
    arrays = _pair_arrays(np.random.default_rng(0), n)
    seen = {"jax": [], "port": []}

    def j_step(state, batch, it, vi_beta):
        seen["jax"].append(float(vi_beta))
        return state, {"loss": 0.0}

    class _JState:
        params = None

    jcfg = JCarelConfig(
        loss=JLossConfig(vi_beta_step=vi_beta_step),
        train=JTrainConfig(batch_size=8, epochs=epochs,
                           checkpoint_dir=str(tmp_path / "j")))
    j_arrays = JPairArrays(**{f: getattr(arrays, f) for f in (
        "input_ids", "attention_mask", "token_type_ids", "pair_labels",
        "emotion_labels", "temporal_order", "bow_indices", "bow_weights")})
    j_train_epochs(jcfg, _JState(), j_step,
                   lambda params, batch, rng: np.zeros(
                       len(batch["pair_labels"]), np.float32),
                   j_arrays, j_arrays, 0, "m", best_f1_so_far=2.0)

    def t_step(state, batch, it, vi_beta):
        seen["port"].append(vi_beta)
        return {"loss": torch.zeros(())}

    class _State:
        model = torch.nn.Linear(1, 1)

    tcfg = CarelConfig(
        loss=LossConfig(vi_beta_step=vi_beta_step),
        train=TrainConfig(batch_size=8, epochs=epochs,
                          checkpoint_dir=str(tmp_path / "t")))
    train_epochs(tcfg, _State(), t_step,
                 lambda model, batch, gen: torch.zeros(
                     len(batch["pair_labels"])), arrays, arrays,
                 0, "m", best_f1_so_far=2.0)
    assert len(seen["port"]) == epochs * 3
    assert seen["port"] == seen["jax"]
    assert seen["port"][-1] == min((epochs - 1) * vi_beta_step, 1.0)
    assert (1.0 in seen["port"]) == (vi_beta_step == 0.15)


def test_jax_self_lr_does_not_reach_the_optimizer():
    """Recorded fault of the JAX package: its CLI rebuilds only the step
    for --self_lr, and the optax chain sits in the TrainState, so a step
    built with vae_lr = 1 moves a state made with vae_lr = 1e-3 exactly as
    a step built with 1e-3 does."""
    cfg = JCarelConfig(
        model=JModelConfig(encoder=j_tiny(vocab_size=64, dropout=0.0),
                           ec_dim=8, bow_dim=40, dropout=0.0),
        train=JTrainConfig(batch_size=8, vae_lr=1e-3, donate=False))
    batch = _pair_arrays(np.random.default_rng(1), 8)
    jb = {"input_ids": batch.input_ids, "attention_mask": batch.attention_mask,
          "token_type_ids": batch.token_type_ids,
          "pair_labels": batch.pair_labels,
          "emotion_labels": batch.emotion_labels,
          "bow_indices": batch.bow_indices, "bow_weights": batch.bow_weights,
          "example_mask": np.ones(8, np.float32)}
    model = JDrlModel(cfg.model)
    params = model.init({"params": jax.random.key(0),
                         "sample": jax.random.key(1)}, jb["input_ids"],
                        jb["attention_mask"], jb["token_type_ids"])["params"]
    state = j_create_state(cfg, params, jax.random.key(2))
    fast = JCarelConfig(model=cfg.model, train=JTrainConfig(
        batch_size=8, vae_lr=1.0, donate=False))
    moved = [j_make_train_step(c, model)(state, jb, 0)[0].params
             for c in (cfg, fast)]
    diffs = jax.tree_util.tree_leaves(jax.tree_util.tree_map(
        lambda a, b: float(jnp.max(jnp.abs(a - b))), *moved))
    assert max(diffs) == 0.0
    step = jax.tree_util.tree_leaves(jax.tree_util.tree_map(
        lambda a, b: float(jnp.max(jnp.abs(a - b))), moved[0], params))
    assert 0.0 < max(step) <= 1.5e-3


def _train_args(tmp_path, preset):
    return ["train", "--preset", preset,
            "--data_root", str(tmp_path / "corpus"), "--encoder", "tiny",
            "--device", "cpu", "--epochs", "1", "--batch_size", "4",
            "--self_iteration", "1", "--self_epochs", "1",
            "--cache_dir", str(tmp_path / "cache"),
            "--checkpoint_dir", str(tmp_path / "ckpt"),
            "--log_dir", str(tmp_path / "logs")]


def test_self_lr_sets_the_main_adam_only(tmp_path, monkeypatch):
    """The port's --self_lr: the fine-tunes' main Adam takes self_lr; the
    disc RMSprop and the club Adam keep adv_lr and aprx_lr."""
    write_oldsplit_corpus(str(tmp_path / "corpus"))
    lrs = {}

    def record(cfg, state, *args, **kwargs):
        for key, opt in (("main", state.optimizer),
                         ("disc", state.disc_optimizer),
                         ("club", state.club_optimizer)):
            lrs[key] = {g["lr"] for g in opt.param_groups}
        return state, (0.0, 0.0, 0.0)

    monkeypatch.setattr(carel_tpu_torch.selftrain, "self_train", record)
    assert main(_train_args(tmp_path, "ec_gan") + ["--self_lr", "5e-4"]) == 0
    train = PRESETS["ec_gan"].train
    assert lrs == {"main": {5e-4}, "disc": {train.adv_lr},
                   "club": {train.aprx_lr}}


@pytest.mark.parametrize("preset", ["ec_gan", "ec_vi_final",
                                    "ec_mmd_self_chain"])
def test_cli_train_gan_vi_self_chain_on_cpu(tmp_path, capsys, preset):
    """train of each preset on the old-split synthetic corpus: one base
    epoch (batch 4, so that the loop logs a loss), its evaluation, one
    self-training iteration; every logged loss finite, every P/R/F1 in
    [0, 1]. ec_mmd_self_chain tests on the
    self-chain documents of entertainment only."""
    write_oldsplit_corpus(str(tmp_path / "corpus"))
    assert main(_train_args(tmp_path, preset)) == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    logs = list((tmp_path / "logs").glob("*.jsonl"))
    events = [json.loads(line) for line in logs[0].read_text().splitlines()]
    names = [e["event"] for e in events]
    assert names[0] == "config" and names[-1] == "self_done"
    assert names.count("eval") == 2 and names.count("selftrain_iter") == 1
    losses = [e["loss"] for e in events if e["event"] == "train"]
    assert losses and all(np.isfinite(losses))
    keys = {"eval": ("precision", "recall", "f1"),
            "self_done": ("p", "r", "f1")}
    for e in events:
        if e["event"] in keys:
            assert all(0.0 <= e[k] <= 1.0 for k in keys[e["event"]]), e
    assert 0.0 <= summary["best_f1"] <= 1.0
    config = events[0]
    assert config["test_pairs"] > 0
    if preset == "ec_mmd_self_chain":
        assert config["num_unpred"] == 0
