"""The port's ``bench`` (carel_tpu_torch/bench.py) against the root bench.py
and the JAX package on the CPU:

- ``train_flops_per_step`` equals ``bench._train_flops_per_step`` exactly;
- ``bench_config()`` equals ``__graft_entry__._flagship_cfg()`` with
  bench.py:207-210's batch 64 and max_len 96, field by field (enums by
  value);
- ``bench_batch`` equals bench.py:213-225's arrays (transcribed below: that
  block is inline in JAX's ``main``, which needs a full-width JAX init);
- three steps of the bench's eager arm (``eager_steps``) over
  ``bench_batch`` at a tiny width (``tiny_encoder_config``, ec_dim 8, BoW V
  64, dropout 0) against three steps of JAX's jitted ``make_train_step``
  (ops_impl "xla", as bench.py builds it), from JAX's init converted by
  ``jax_params_to_state_dict`` and JAX's own sampling noise, read off the
  key its step derives (steps.py:150, :136) and passed in as ``eps``.
  Tolerances of tests/test_torch_train_step.py: every metric rtol 1e-5 at
  every step, the KL terms after dividing out their annealing weight (JAX
  forms it in fp32, ~2.4e-4 relative off; the port in double), and the
  total loss, which cancels, within 1e-5 of the sum of its weighted terms'
  sizes; the params after the three steps within 2 lr a step of JAX's
  (Adam's step is ~lr wherever the gradient is rounding noise) and the 99th
  percentile of every tensor within 0.05 lr, as
  tests/test_torch_scan_epoch.py holds its epochs;
- the captured arm (the epoch step, run eagerly on the CPU) and the eager
  arm give the same bits from one seed, dropout on;
- ``main`` prints one JSON line with every key, the verb parses and hands
  ``--device`` to ``bench.main``, every verb of the JAX CLI has its
  counterpart, and without a card the verb raises.
"""

import argparse
import dataclasses
import enum
import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import carel_tpu.models.drl as j_drl
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
from carel_tpu.train.steps import make_train_step as j_make_train_step

from carel_tpu_torch import bench
from carel_tpu_torch.cli import main as cli
from carel_tpu_torch.config import (CarelConfig, DataConfig, LossConfig,
                                    ModelConfig, Regularizer, TrainConfig)
from carel_tpu_torch.convert import jax_params_to_state_dict
from carel_tpu_torch.losses.vae import annealed_kl_weight
from carel_tpu_torch.models.drl import DrlModel
from carel_tpu_torch.models.encoder import tiny_encoder_config
from carel_tpu_torch.train.scan_epoch import make_epoch_step
from carel_tpu_torch.train.state import create_train_state
from carel_tpu_torch.train.steps import batch_to_device, make_train_step

VOCAB, BOW, EC, B, L = 128, 64, 8, 8, 16
LR = 1e-3
STEPS = 3
CPU = torch.device("cpu")


def _norm(x):
    if dataclasses.is_dataclass(x):
        return {f.name: _norm(getattr(x, f.name))
                for f in dataclasses.fields(x)}
    if isinstance(x, enum.Enum):
        return x.value
    return x


def _tiny_cfgs(dropout: float = 0.0):
    enc = dict(vocab_size=VOCAB, dropout=dropout)
    j = JCarelConfig(
        model=JModelConfig(encoder=j_tiny(**enc), ec_dim=EC, bow_dim=BOW,
                           dropout=dropout),
        loss=JLossConfig(regularizer=JRegularizer.MMD),
        data=JDataConfig(max_len=L),
        train=JTrainConfig(batch_size=B, vae_lr=LR, donate=False))
    t = CarelConfig(
        model=ModelConfig(encoder=tiny_encoder_config(**enc), ec_dim=EC,
                          bow_dim=BOW, dropout=dropout),
        loss=LossConfig(regularizer=Regularizer.MMD),
        data=DataConfig(max_len=L),
        train=TrainConfig(batch_size=B, vae_lr=LR))
    return j, t


@pytest.mark.parametrize("shape", [
    (64, 96, 768, 12, 3072, 23808, 24),
    (64, 128, 768, 12, 3072, 23808, 24),
    (256, 64, 768, 12, 3072, 40000, 24),
    (8, 16, 64, 2, 128, 64, 8),
    (1, 1, 1, 1, 1, 1, 1),
])
def test_train_flops_match_jax_bench(shape):
    import bench as j_bench

    assert bench.train_flops_per_step(*shape) == \
        j_bench._train_flops_per_step(*shape)


def test_train_flops_defaults_match_jax_bench():
    import bench as j_bench

    assert bench.train_flops_per_step(64, 96) == \
        j_bench._train_flops_per_step(64, 96)
    # 3.197 TFLOP a step at the bench's point
    assert round(bench.train_flops_per_step(64, 96) / 1e12, 3) == 3.197
    assert bench.A100_ENVELOPE_PAIRS_PER_SEC == \
        j_bench.A100_ENVELOPE_PAIRS_PER_SEC
    assert (bench.BENCH_BATCH, bench.BENCH_SEQ) == \
        (j_bench.BENCH_BATCH, j_bench.BENCH_SEQ)


def _jax_bench_config():
    """__graft_entry__._flagship_cfg() with bench.py:207-210's
    replacements."""
    from __graft_entry__ import _flagship_cfg

    cfg = _flagship_cfg()
    return dataclasses.replace(
        cfg, train=dataclasses.replace(cfg.train, batch_size=64),
        data=dataclasses.replace(cfg.data, max_len=96))


def test_bench_config_matches_flagship():
    got, want = _norm(bench.bench_config()), _norm(_jax_bench_config())
    assert got == want
    assert got["model"]["encoder"]["num_layers"] == 12
    assert got["model"]["encoder"]["dtype"] == "bfloat16"
    assert got["model"]["encoder"]["attention_impl"] == "xla"


def _jax_batch(cfg):
    """bench.py:212-225, transcribed."""
    model_cfg = cfg.model
    B, L = cfg.train.batch_size, cfg.data.max_len
    rng = np.random.default_rng(0)
    return {
        "input_ids": jnp.asarray(
            rng.integers(1, model_cfg.encoder.vocab_size, (B, L)), jnp.int32),
        "attention_mask": jnp.ones((B, L), jnp.int32),
        "token_type_ids": jnp.zeros((B, L), jnp.int32),
        "pair_labels": jnp.asarray(rng.integers(0, 2, B), jnp.float32),
        "emotion_labels": jnp.asarray(rng.integers(0, 6, B), jnp.int32),
        "bow_indices": jnp.asarray(
            rng.integers(0, model_cfg.bow_dim, (B, 32)), jnp.int32),
        "bow_weights": jnp.full((B, 32), 1.0 / 32, jnp.float32),
        "example_mask": jnp.ones(B, jnp.float32),
    }


@pytest.mark.parametrize("tiny", [False, True])
def test_bench_batch_matches_jax(tiny):
    j_cfg, t_cfg = _tiny_cfgs() if tiny else (_jax_bench_config(),
                                              bench.bench_config())
    got, want = bench.bench_batch(t_cfg), _jax_batch(j_cfg)
    assert list(got) == list(want)
    for k, v in want.items():
        v = np.asarray(v)
        assert got[k].dtype == v.dtype, k
        np.testing.assert_array_equal(got[k], v, err_msg=k)


def _jax_noise(jm, params, jb, rng):
    """The sampling noise (eps_emotion, eps_cause) of JAX's train step from
    state rng ``rng``: its forward splits rng into (next, fwd, reg) and fwd
    into (sample, dropout) (carel_tpu/train/steps.py:150, :136); the model
    splits its make_rng("sample") key into one key a latent
    (models/drl.py:85-89), read here off an unjitted forward."""
    _, fwd_rng, _ = jax.random.split(rng, 3)
    sample_rng, dropout_rng = jax.random.split(fwd_rng)
    keys = []
    real = j_drl.sample_prior

    def spy(key, mu, log_var, compat=True):
        keys.append(key)
        return real(key, mu, log_var, compat=compat)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_drl, "sample_prior", spy)
        jm.apply({"params": params}, jb["input_ids"], jb["attention_mask"],
                 jb["token_type_ids"], deterministic=False,
                 rngs={"sample": sample_rng, "dropout": dropout_rng})
    assert len(keys) == 2
    return tuple(torch.from_numpy(np.array(
        jax.random.normal(k, (EC,), jnp.float32))) for k in keys)


@pytest.fixture(scope="module")
def steps_against_jax():
    j_cfg, t_cfg = _tiny_cfgs()
    arrays = bench.bench_batch(t_cfg)
    jb = {k: jnp.asarray(v) for k, v in arrays.items()}
    jm = JDrlModel(j_cfg.model)
    params = jm.init({"params": jax.random.key(0),
                      "sample": jax.random.key(1)},
                     jb["input_ids"], jb["attention_mask"],
                     jb["token_type_ids"])["params"]
    np_params = jax.tree_util.tree_map(np.asarray, params)
    j_state = j_create_state(j_cfg, params, jax.random.key(2))
    j_step = j_make_train_step(j_cfg, jm)
    j_metrics, noise = [], []
    for i in range(STEPS):
        noise.append(_jax_noise(jm, j_state.params, jb, j_state.rng))
        j_state, m = j_step(j_state, jb, i, 0.0)
        j_metrics.append({k: float(v) for k, v in m.items()})

    model = DrlModel(t_cfg.model)
    model.load_state_dict(jax_params_to_state_dict(np_params))
    state = create_train_state(t_cfg, model, torch.Generator())
    step = make_train_step(t_cfg)
    t_metrics = []

    def noisy_step(st, batch, i):
        metrics = step(st, batch, i, eps=noise[i])
        t_metrics.append({k: float(v) for k, v in metrics.items()})
        return metrics

    losses = bench.eager_steps(noisy_step, state,
                               batch_to_device(arrays, CPU), STEPS)
    return dict(j_metrics=j_metrics, t_metrics=t_metrics, losses=losses,
                state=state, j_after=jax_params_to_state_dict(
                    jax.tree_util.tree_map(np.asarray, j_state.params)))


@pytest.mark.parametrize("i", range(STEPS))
def test_bench_step_metrics_match_jax(steps_against_jax, i):
    jm = steps_against_jax["j_metrics"][i]
    tm = steps_against_jax["t_metrics"][i]
    lc = LossConfig()
    j_w = float(j_kl_weight(i, lc.kl_ann_iterations, lc.ec_kl_lambda))
    t_w = annealed_kl_weight(i, lc.kl_ann_iterations, lc.ec_kl_lambda)
    assert set(jm) == set(tm)
    for k in jm:
        want, got = jm[k], tm[k]
        if k == "loss":
            continue
        if k.startswith("kl_"):
            want, got = want / j_w, got / t_w
        np.testing.assert_allclose(got, want, rtol=1e-5, err_msg=k)
    # the total cancels (-30 MMD against the rest: 9.63 from terms of up to
    # 42 at step 1), so its 1e-5 is taken of the sum of its terms' sizes
    terms = (abs(jm["reg_loss"]) + lc.emo_mul_loss_weight * abs(jm["emo_loss"])
             + lc.cau_mul_loss_weight * abs(jm["cau_loss"])
             + lc.pair_mul_loss_weight * abs(jm["pair_loss"])
             + abs(jm["kl_emotion"]) + abs(jm["kl_cause"])
             + abs(jm["recon_loss"]))
    np.testing.assert_allclose(
        tm["reg_loss"] + lc.emo_mul_loss_weight * tm["emo_loss"]
        + lc.cau_mul_loss_weight * tm["cau_loss"]
        + lc.pair_mul_loss_weight * tm["pair_loss"] + tm["kl_emotion"]
        + tm["kl_cause"] + tm["recon_loss"], tm["loss"], rtol=1e-6)
    assert abs(tm["loss"] - jm["loss"]) <= 1e-5 * terms
    assert float(steps_against_jax["losses"][i]) == tm["loss"]
    assert tm["reg_loss"] != 0.0 and tm["recon_loss"] > 0.0


def test_bench_step_params_match_jax(steps_against_jax):
    state, after = steps_against_jax["state"], steps_against_jax["j_after"]
    assert state.step == STEPS
    worst, bulk, moved = 0.0, 0.0, 0
    for name, p in state.model.named_parameters():
        err = (p.detach() - after[name]).abs().flatten() / LR
        worst = max(worst, float(err.max()))
        if name.endswith("attention.qkv.bias"):
            # the key bias's exact gradient is 0 (the softmax cancels it)
            hidden = err.numel() // 3  # laid out (q, k, v)
            err = torch.cat([err[:hidden], err[2 * hidden:]])
        bulk = max(bulk, float(torch.quantile(err.double(), 0.99)))
        moved += p.requires_grad
    assert worst <= 2.0 * STEPS, worst
    assert bulk <= 0.05, bulk
    assert moved > 20


def test_captured_and_eager_arms_give_the_same_bits():
    """bench's two arms from one seed, dropout on: the epoch step (run
    eagerly on the CPU, as the graph replays it on the card) and the eager
    step draw the same noise and masks and give the same losses and
    params."""
    _, cfg = _tiny_cfgs(dropout=0.1)
    arrays = bench.bench_batch(cfg)
    a = bench.bench_state(cfg, CPU)
    captured = make_epoch_step(cfg)(a, bench.stacked(arrays, STEPS), 0.0)
    b = bench.bench_state(cfg, CPU)
    eager = bench.eager_steps(make_train_step(cfg), b,
                              batch_to_device(arrays, CPU), STEPS)
    assert torch.equal(captured, eager)
    assert len(set(captured.tolist())) == STEPS
    for (name, p), q in zip(a.model.named_parameters(),
                            b.model.parameters()):
        assert torch.equal(p, q), name


def test_stacked_repeats_the_batch():
    _, cfg = _tiny_cfgs()
    arrays = bench.bench_batch(cfg)
    epoch = bench.stacked(arrays, 4)
    for k, v in arrays.items():
        assert epoch[k].shape == (4, *v.shape) and epoch[k].dtype == v.dtype
        for row in epoch[k]:
            np.testing.assert_array_equal(row, v)


def test_reference_is_bert_base_at_the_bench_config():
    from transformers import BertConfig

    got = bench.reference_bert_config(bench.bench_config()).to_dict()
    want = BertConfig(vocab_size=21128).to_dict()
    for key in ("transformers_version", "_name_or_path"):
        got.pop(key, None)
        want.pop(key, None)
    assert got == want


DETAIL_NUMBERS = ("ms_per_step", "ms_per_step_eager", "model_tflops_per_sec",
                  "mfu_pct_of_h100_bf16_peak", "a100_envelope_pairs_per_sec",
                  "torch_reference_ms_step", "torch_reference_pairs_per_sec",
                  "torch_reference_ratio")


def test_main_prints_one_json_line(capsys):
    _, cfg = _tiny_cfgs()
    line = bench.main(device="cpu", cfg=cfg, n_steps=2, rounds=1,
                      reference=dict(B=2, L=8, steps=1))
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 1
    printed = json.loads(out[0])
    assert printed == json.loads(json.dumps(line))
    assert set(printed) == {"metric", "value", "unit", "vs_baseline",
                            "details"}
    assert "captured step" in printed["metric"]
    assert printed["unit"] == "pairs/sec"
    details = printed["details"]
    for key in ("value", "vs_baseline"):
        assert math.isfinite(printed[key]) and printed[key] > 0, key
    for key in DETAIL_NUMBERS:
        assert math.isfinite(details[key]) and details[key] > 0, key
    assert details["rng_recipe"] == "philox"
    assert details["baseline_kind"] == "a100-envelope"
    assert details["device"] == details["torch_reference_device"] == "cpu"
    # the CPU runs the epoch step's body eagerly: no capture, no kernel
    assert details["captures"] == 0
    assert details["launches"] == {"captured": {}, "eager": {}}
    # pairs/s and ms/step are the same measurement
    np.testing.assert_allclose(
        printed["value"] * details["ms_per_step"] / 1e3, B, rtol=1e-9)
    np.testing.assert_allclose(
        details["torch_reference_ratio"],
        printed["value"] / details["torch_reference_pairs_per_sec"],
        rtol=1e-12)
    flops = bench.train_flops_per_step(B, L, 64, 2, 128, BOW, EC)
    np.testing.assert_allclose(
        details["model_tflops_per_sec"],
        flops / (details["ms_per_step"] / 1e3) / 1e12, rtol=1e-9)
    np.testing.assert_allclose(
        details["mfu_pct_of_h100_bf16_peak"],
        100 * details["model_tflops_per_sec"] / 989.0, rtol=1e-12)


def test_verb_parses_and_hands_device_to_bench(monkeypatch):
    args = cli.build_parser().parse_args(["bench", "--device", "cpu"])
    assert args.fn is cli.cmd_bench and args.device == "cpu"
    assert cli.build_parser().parse_args(["bench"]).device == "cuda"
    with pytest.raises(SystemExit):
        cli.build_parser().parse_args(["bench", "--steps", "3"])
    seen = []
    monkeypatch.setattr(bench, "main", lambda device: seen.append(device))
    assert cli.main(["bench", "--device", "cpu"]) == 0
    assert cli.main(["bench"]) == 0
    assert seen == ["cpu", "cuda"]


def _verbs(parser):
    (sub,) = [a for a in parser._actions
              if isinstance(a, argparse._SubParsersAction)]
    return set(sub.choices)


def test_every_jax_verb_has_a_counterpart():
    from carel_tpu.cli.main import build_parser as j_build_parser

    jax_verbs = _verbs(j_build_parser())
    assert "bench" in jax_verbs and len(jax_verbs) == 16
    assert jax_verbs <= _verbs(cli.build_parser())


def test_bench_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.main()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["bench"])
