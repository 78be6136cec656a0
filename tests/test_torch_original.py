"""The port's original 3-latent DRL (carel_tpu_torch/models/drl_original.py,
train/steps_original.py, train/original_driver.py, the original verb)
against the JAX package's, on the CPU at tiny widths (tiny_encoder_config,
ec_dim 8, con_dim 16, V 40, dropout 0, fp32). JAX draws its noise inside the
model; the tests replace carel_tpu.models.drl_original.sample_prior (for the
test's duration, by monkeypatch) with one that reads fixed noise vectors in
the model's call order (content, emotion, cause), and hand the port the
same vectors as ``eps``.

- the forward with sample=False, and with the fixed noise: every output
  within 1e-5 (max abs) of JAX's;
- original_losses in both variants (and at another iteration): vae, disc,
  pair and reconstruction losses within rtol 1e-6 of JAX's on the same
  outputs;
- three steps (iterations 0, 1, 2) of each variant from JAX's init, lr
  1e-3: losses within rtol 1e-5, every parameter within 1e-4 of JAX's
  (the attention key biases, whose gradient is 0 in exact arithmetic,
  within Adam's 2 lr a step), the moves from the init within 1e-3
  normwise; the six latent heads bit-unchanged and all five adversaries
  moved on both sides;
- the eval step: JAX's with zero noise equals the port's with
  sample=False, and the port's draws the three noise vectors from the
  generator it is given, in the order content, emotion, cause;
- _train_phase reloads the best checkpoint, also when it saved none;
- the original verb on the CPU over the synthetic old-split corpus
  (society -> finance), plain and --bow_loss, through evaluation, the best
  save and reload and one self-training iteration.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import carel_tpu.models.drl_original as jdo
from carel_tpu.models.drl_original import DrlOriginalModel as JModel
from carel_tpu.models.drl_original import OriginalModelConfig as JModelCfg
from carel_tpu.models.encoder import tiny_encoder_config as j_tiny
from carel_tpu.train.original_driver import make_original_eval_step as j_eval
from carel_tpu.train.steps_original import OriginalLossConfig as JLossCfg
from carel_tpu.train.steps_original import make_original_train_step as j_make
from carel_tpu.train.steps_original import original_losses as j_losses

from carel_tpu_torch.cli.main import main
from carel_tpu_torch.config import PRESETS
from carel_tpu_torch.convert import jax_params_to_state_dict
from carel_tpu_torch.models.drl_original import (ADVERSARIES, LATENT_HEADS,
                                                 DrlOriginalModel,
                                                 OriginalModelConfig)
from carel_tpu_torch.models.encoder import tiny_encoder_config
from carel_tpu_torch.train import checkpoint as ckpt
from carel_tpu_torch.train.original_driver import (_train_phase,
                                                   build_original_state)
from carel_tpu_torch.train.steps import make_eval_step
from carel_tpu_torch.train.steps_original import (FROZEN, OriginalLossConfig,
                                                  create_original_state,
                                                  make_original_train_step,
                                                  original_losses)

from tests.test_torch_adapters import _key_bias_entries
from tests.test_torch_data import write_oldsplit_corpus

V, EC, CON, B, L, VOCAB = 40, 8, 16, 8, 16, 64
LR = 1e-3


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    mask = np.ones((B, L), np.int32)
    mask[3, 10:] = 0
    mask[5, 4:] = 0
    idx = rng.integers(0, V, (B, 6)).astype(np.int32)
    idx[:, 4:] = -1  # padded BoW slots
    idx[0, 1] = idx[0, 0]  # a duplicate term
    return {
        "input_ids": (rng.integers(1, VOCAB, (B, L)) * mask).astype(np.int32),
        "attention_mask": mask,
        "token_type_ids": np.zeros((B, L), np.int32),
        "pair_labels": rng.integers(0, 2, B).astype(np.float32),
        "emotion_labels": rng.integers(0, 6, B).astype(np.int32),
        "bow_indices": idx,
        "bow_weights": np.where(idx >= 0, 0.25, 0.0).astype(np.float32),
        "example_mask": np.r_[np.ones(B - 2), np.zeros(2)].astype(np.float32),
    }


EPS = [np.random.default_rng(7).normal(size=d).astype(np.float32)
       for d in (CON, EC, EC)]


@pytest.fixture
def fixed_noise(monkeypatch):
    """JAX's sample_prior reads EPS in the model's call order."""
    calls = []

    def sample_prior(rng, mu, log_var, compat=True):
        eps = EPS[len(calls) % 3]
        calls.append(1)
        return mu + jnp.asarray(eps)[None, :] * jnp.exp(log_var)

    monkeypatch.setattr(jdo, "sample_prior", sample_prior)
    return [torch.from_numpy(e) for e in EPS]


@pytest.fixture(scope="module")
def setup():
    """JAX's model and init params, the port's model config and the
    converted params, and one batch both ways."""
    jm = JModel(JModelCfg(encoder=j_tiny(vocab_size=VOCAB, dropout=0.0),
                          ec_dim=EC, con_dim=CON, bow_dim=V, dropout=0.0))
    batch = _batch()
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    params = jm.init({"params": jax.random.key(0),
                      "sample": jax.random.key(1)}, jb["input_ids"],
                     jb["attention_mask"], jb["token_type_ids"])["params"]
    cfg = OriginalModelConfig(
        encoder=tiny_encoder_config(vocab_size=VOCAB, dropout=0.0),
        ec_dim=EC, con_dim=CON, bow_dim=V, dropout=0.0)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    return dict(jm=jm, jb=jb, params=params, cfg=cfg, tb=tb,
                init=jax_params_to_state_dict(_np(params)))


def _model(setup):
    model = DrlOriginalModel(setup["cfg"])
    model.load_state_dict(setup["init"])
    return model


def _forwards(setup, sample, eps=None):
    jb = setup["jb"]
    want = setup["jm"].apply({"params": setup["params"]}, jb["input_ids"],
                             jb["attention_mask"], jb["token_type_ids"],
                             deterministic=True, sample=sample,
                             rngs={"sample": jax.random.key(9)})
    tb = setup["tb"]
    with torch.no_grad():
        got = _model(setup)(tb["input_ids"], tb["attention_mask"],
                            tb["token_type_ids"], deterministic=True,
                            sample=sample, eps=eps)
    return got, _np(want)


def _assert_outputs(got, want):
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k], rtol=0,
                                   atol=1e-5, err_msg=k)


def test_forward_without_sampling_matches_jax(setup):
    got, want = _forwards(setup, sample=False)
    _assert_outputs(got, want)
    assert got["recon_logits"].shape == (B, V)
    assert torch.equal(got["z_content"], got["content_mu"])


def test_three_latent_sampling_matches_jax(setup, fixed_noise):
    got, want = _forwards(setup, sample=True, eps=fixed_noise)
    _assert_outputs(got, want)
    for i, name in enumerate(("content", "emotion", "cause")):
        torch.testing.assert_close(
            got[f"z_{name}"], got[f"{name}_mu"] + fixed_noise[i][None, :]
            * torch.exp(got[f"{name}_log_var"]), rtol=0, atol=0)
    # without eps the three vectors come from the generator, in that order
    tb, model = setup["tb"], _model(setup)
    with torch.no_grad():
        drawn = model(tb["input_ids"], tb["attention_mask"],
                      tb["token_type_ids"],
                      generator=torch.Generator().manual_seed(5))
        g = torch.Generator().manual_seed(5)
        eps = [torch.randn(d, generator=g) for d in (CON, EC, EC)]
        fixed = model(tb["input_ids"], tb["attention_mask"],
                      tb["token_type_ids"], eps=eps)
    assert all(torch.equal(drawn[k], fixed[k]) for k in fixed)


@pytest.mark.parametrize("learned", [False, True])
@pytest.mark.parametrize("iteration", [0, 7])
def test_original_losses_match_jax(setup, fixed_noise, learned, iteration):
    _, want_out = _forwards(setup, sample=True, eps=fixed_noise)
    out = {k: torch.from_numpy(np.array(v)) for k, v in want_out.items()}
    got = original_losses(OriginalLossConfig(learned_bow_weights=learned),
                          out, setup["tb"], iteration)[2]
    want = j_losses(JLossCfg(learned_bow_weights=learned),
                    {k: jnp.asarray(v) for k, v in want_out.items()},
                    setup["jb"], iteration)[2]
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-6,
                                   err_msg=k)


@pytest.mark.parametrize("learned", [False, True])
def test_three_steps_match_jax(setup, fixed_noise, learned):
    kw = dict(learned_bow_weights=learned, vae_lr=LR)
    j_state, j_step = j_make(JLossCfg(**kw), setup["jm"])(
        setup["params"], jax.random.key(3))
    model = _model(setup)
    init = setup["init"]
    state = create_original_state(OriginalLossConfig(**kw), model,
                                  torch.Generator())
    step = make_original_train_step(OriginalLossConfig(**kw))
    for it in range(3):
        j_state, j_metrics = j_step(j_state, setup["jb"], it)
        metrics = step(state, setup["tb"], it, eps=fixed_noise)
        for k in j_metrics:
            np.testing.assert_allclose(float(metrics[k]),
                                       float(j_metrics[k]), rtol=1e-5,
                                       err_msg=k)
        want = jax_params_to_state_dict(_np(j_state["params"]))
        err2 = ref2 = 0.0
        for name, p in model.named_parameters():
            got, w = p.detach(), want[name]
            keep = ~_key_bias_entries(name, got)
            assert float((got - w)[keep].abs().max()) <= 1e-4, name
            assert float((got - w).abs().max()) <= 2 * LR * (it + 1), name
            err2 += float(((got - w)[keep] ** 2).sum())
            ref2 += float(((w - init[name])[keep] ** 2).sum())
        assert (err2 / ref2) ** 0.5 <= 1e-3
    assert state.step == 3
    after = dict(model.named_parameters())
    for name, label in state.labels.items():
        moved = not torch.equal(after[name].detach(), init[name])
        j_moved = not np.array_equal(want[name], init[name])
        if label == FROZEN:
            assert not moved and not j_moved, name
    assert {n for n, l in state.labels.items() if l == FROZEN} == {
        f"{h}.{w}" for h in LATENT_HEADS for w in ("weight", "bias")}
    for adv in ADVERSARIES:
        assert not torch.equal(after[f"{adv}.weight"].detach(),
                               init[f"{adv}.weight"]), adv


def test_eval_step(setup, monkeypatch):
    monkeypatch.setattr(
        jdo, "sample_prior",
        lambda rng, mu, log_var, compat=True: mu + 0.0 * jnp.exp(log_var))
    jb, tb, model = setup["jb"], setup["tb"], _model(setup)
    want = np.asarray(j_eval(setup["jm"])(setup["params"], jb,
                                          jax.random.key(2)))
    with torch.no_grad():
        got = model.pair_probabilities(tb["input_ids"],
                                       tb["attention_mask"],
                                       tb["token_type_ids"], sample=False)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    # sampled: three draws from the generator given, content first
    probs = make_eval_step()(model, tb, torch.Generator().manual_seed(11))
    g = torch.Generator().manual_seed(11)
    eps = [torch.randn(d, generator=g) for d in (CON, EC, EC)]
    with torch.no_grad():
        out = model(tb["input_ids"], tb["attention_mask"],
                    tb["token_type_ids"], eps=eps)
    assert torch.equal(probs, torch.sigmoid(out["pair_logits"][:, 0]))
    assert probs.dtype == torch.float32 and probs.shape == (B,)


def test_train_phase_reloads_the_best(setup, tmp_path):
    """Two epochs save the best; the model ends at the saved bits. A phase
    that cannot beat its best saves nothing and still reloads it."""
    import dataclasses

    from carel_tpu_torch.data.batching import PairArrays

    arrays = PairArrays(**{
        k: np.concatenate([v] * 3) for k, v in _batch(1).items()
        if k != "example_mask"}, temporal_order=np.ones(3 * B, bool))
    base = PRESETS["ec_mmd_final_mul"]
    cfg = dataclasses.replace(base, train=dataclasses.replace(
        base.train, batch_size=B, checkpoint_dir=str(tmp_path)))
    loss_cfg = OriginalLossConfig(vae_lr=LR)
    state = build_original_state(cfg, loss_cfg, setup["cfg"], "cpu",
                                 params=setup["init"])
    step, ev = make_original_train_step(loss_cfg), make_eval_step()
    records = []

    class Log:
        def log(self, record):
            records.append(record)

    gen = torch.Generator().manual_seed(0)
    state, best = _train_phase(cfg, state, step, ev, arrays, arrays, 0, "m",
                               2, Log(), np.random.default_rng(0), gen,
                               (0.0, 0.0, -1.0))
    saved = ckpt.load_best(str(tmp_path), "m", torch.device("cpu"))
    assert "best" in [r["event"] for r in records]
    assert [r["steps"] for r in records if r["event"] == "eval"] == [3, 3]
    now = state.model.state_dict()
    assert all(torch.equal(now[k], saved[k]) for k in saved)
    with torch.no_grad():
        state.model.decoder.weight.add_(1.0)
    state, best2 = _train_phase(cfg, state, step, ev, arrays, arrays, 0,
                                "m", 1, Log(), np.random.default_rng(1), gen,
                                (1.0, 1.0, 2.0))
    assert best2 == (1.0, 1.0, 2.0)
    now = state.model.state_dict()
    assert all(torch.equal(now[k], saved[k]) for k in saved)


@pytest.mark.parametrize("bow_loss", [False, True])
def test_original_verb_runs_on_cpu(tmp_path, capsys, bow_loss):
    root = tmp_path / "corpus"
    write_oldsplit_corpus(str(root))
    args = ["original", "--data_root", str(root), "--encoder", "tiny",
            "--device", "cpu", "--epochs", "2", "--self_iteration", "1",
            "--self_epochs", "1", "--batch_size", "16", "--cache_dir",
            str(tmp_path / "cache"), "--log_dir", str(tmp_path / "logs"),
            "--checkpoint_dir", str(tmp_path / "ckpt")]
    assert main(args + (["--bow_loss"] if bow_loss else [])) == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(res) == {"model_id", "best_f1", "base_f1"}
    assert 0.0 <= res["best_f1"] <= 1.0
    (log,) = (tmp_path / "logs").glob("drl_original_*.jsonl")
    records = [json.loads(line) for line in log.read_text().splitlines()]
    events = [r["event"] for r in records]
    assert events[0] == "config" and records[0]["learned_bow_weights"] \
        == bow_loss and records[0]["train_pairs"] > 0
    assert events.count("eval") == 3 and "base_done" in events
    assert "selftrain_iter" in events and events[-1] == "self_done"
    assert all(np.isfinite(r["loss"]) for r in records
               if r["event"] == "eval")
    # a best F1 above 0 was saved (and reloaded); with none there is no file
    assert ("best" in events) == os.path.exists(
        ckpt.best_path(str(tmp_path / "ckpt"), res["model_id"]))
