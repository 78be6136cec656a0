"""The attention adapters (--adapter raw|sparsemax|entmax) of the port
against the JAX package's, from the same weights (convert.py), on the CPU at
tiny widths (tiny_encoder_config, dropout 0, zero sampling noise).

- DrlModel's outputs with each adapter kind: normwise relative 1e-5 (fp32 on
  both sides, sums in another order). A padded batch row (attention mask
  all 0) is compared too, except under sparsemax, where JAX gives it inf
  weights and the port weight 0 (tests/test_torch_entmax.py).
- Three flagship (MMD) train steps per kind at the preset's lr (1e-5),
  JAX's step as tests/test_torch_train_step.py composes it, jitted, with
  the loss's plain XLA ops in place of the Pallas kernels: every metric
  but the KL terms within rtol 1e-5 (the KL annealing weight is an fp32
  value in JAX, a double here); the params normwise within 1e-5, each
  weight tensor and the whole set, and every entry within 2 lr a step, the
  sign-flip bound of Adam's update for a gradient at rounding level. The
  key biases (the encoder's qkv bias's key third, the raw adapter's
  ``mha.key.bias``, the sparse adapters' ``k_proj.bias``) are left out of
  the whole set's norm: every key's score moves by the same q.b, which
  softmax, sparsemax and entmax15 ignore, so their gradient is 0 in exact
  arithmetic and both packages move them by rounding noise only. The
  pooler (which no adapter path reads) and the sparse kinds' v_proj (whose
  output is never used) stay bit-unchanged in both.
- The adapter params are the main group; the pooler and v_proj never get a
  gradient or optimizer state, so a step's capture key does not change.
- The CLI: train --adapter entmax --track_memorization writes
  memorization.png and infer --adapter entmax serves the checkpoint.
"""

import dataclasses
import functools
import json
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from carel_tpu.config import AdapterKind as JAdapterKind
from carel_tpu.config import ModelConfig as JModelConfig
from carel_tpu.models.drl import DrlModel as JDrlModel
from carel_tpu.models.encoder import tiny_encoder_config as j_tiny
from carel_tpu.train.state import create_train_state as j_create_state

from carel_tpu_torch.config import AdapterKind, ModelConfig
from carel_tpu_torch.convert import jax_params_to_state_dict
from carel_tpu_torch.models.drl import DrlModel
from carel_tpu_torch.models.encoder import tiny_encoder_config
from carel_tpu_torch.train.scan_epoch import capture_key, pack_epoch
from carel_tpu_torch.train.state import MAIN, create_train_state
from carel_tpu_torch.train.steps import batch_to_device, make_train_step

from tests import test_torch_train_step as ts
from tests.test_torch_data import write_newsplit_corpus

ROOT = pathlib.Path(__file__).resolve().parents[1]
KINDS = ("raw", "sparsemax", "entmax")
VOCAB, EC, BOW, HEADS, LR, STEPS = 128, 8, 64, 4, 1e-5, 3
SHIFT_INVARIANT = ("mha.key.bias", "k_proj.bias")


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _model_cfgs(kind: str):
    kw = dict(vocab_size=VOCAB, dropout=0.0)
    j = JModelConfig(encoder=j_tiny(**kw), ec_dim=EC, bow_dim=BOW,
                     dropout=0.0, adapter=JAdapterKind(kind),
                     head_number=HEADS)
    t = ModelConfig(encoder=tiny_encoder_config(**kw), ec_dim=EC,
                    bow_dim=BOW, dropout=0.0, adapter=AdapterKind(kind),
                    head_number=HEADS)
    return j, t


def _inputs(seed=0, B=5, L=16):
    """Rows of several lengths; the last row is a padded batch row."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(2, VOCAB, (B, L)).astype(np.int32)
    mask = np.ones((B, L), np.int32)
    mask[1, 10:] = 0
    mask[3, 3:] = 0
    mask[4, :] = 0
    ids[mask == 0] = 0
    types = np.zeros((B, L), np.int32)
    types[:, L // 2:] = 1
    return ids, mask, types


@pytest.mark.parametrize("kind", list(AdapterKind))
def test_drl_model_builds_every_adapter_kind(kind):
    _, tc = _model_cfgs(kind.value)
    model = DrlModel(tc)
    names = {n for n, _ in model.named_parameters()}
    has = {n.split(".")[0] for n in names}
    assert ("emotion_adapter" in has) == (kind != AdapterKind.NONE)
    assert ("cause_adapter" in has) == (kind != AdapterKind.NONE)
    if kind in (AdapterKind.SPARSEMAX, AdapterKind.ENTMAX):
        assert "emotion_adapter.v_proj.weight" in names
    if kind == AdapterKind.RAW:
        assert "cause_adapter.mha.out.weight" in names
    state = create_train_state(ts._cfgs("mmd")[1], model, torch.Generator())
    assert all(state.labels[n] == MAIN for n in names if "adapter" in n)


@pytest.mark.parametrize("kind", KINDS)
def test_adapter_model_matches_jax(kind):
    jc, tc = _model_cfgs(kind)
    ids, mask, types = _inputs()
    jm = JDrlModel(jc)
    variables = jm.init({"params": jax.random.key(0),
                         "sample": jax.random.key(1)}, ids, mask, types)
    j_out = jm.apply(variables, ids, mask, types, sample=False)
    model = DrlModel(tc)
    model.load_state_dict(jax_params_to_state_dict(_np(variables["params"])))
    with torch.no_grad():
        out = model(torch.tensor(ids), torch.tensor(mask),
                    torch.tensor(types), sample=False)
    rows = slice(0, 4) if kind == "sparsemax" else slice(None)
    for key in ("emotion_mu", "emotion_log_var", "cause_mu",
                "cause_log_var", "pair_logits", "emotion_logits",
                "cause_logits", "recon_logits"):
        got, want = out[key].numpy()[rows], np.asarray(j_out[key])[rows]
        err = np.linalg.norm(got - want) / np.linalg.norm(want)
        assert err <= 1e-5, (key, err)
        assert np.all(np.isfinite(out[key].numpy())), key
    # the two latents read different adapters
    assert not torch.allclose(out["emotion_mu"], out["cause_mu"])


def test_convert_raises_on_an_unknown_adapter_leaf():
    jc, _ = _model_cfgs("entmax")
    ids, mask, types = _inputs()
    params = _np(JDrlModel(jc).init({"params": jax.random.key(0),
                                     "sample": jax.random.key(1)},
                                    ids, mask, types)["params"])
    jax_params_to_state_dict(params)
    bad = dict(params, emotion_adapter=dict(params["emotion_adapter"],
                                            temperature=np.ones(1)))
    with pytest.raises(KeyError, match="temperature"):
        jax_params_to_state_dict(bad)
    # a leaf named query outside an adapter is not an adapter's query
    with pytest.raises(KeyError, match="query"):
        jax_params_to_state_dict({"heads": {"query": np.ones((1, 1, 4))}})


def _key_bias_entries(name: str, p: torch.Tensor) -> torch.Tensor:
    """The entries of ``name`` whose gradient is 0 in exact arithmetic."""
    mask = torch.zeros_like(p, dtype=torch.bool)
    if name.endswith("attention.qkv.bias"):  # laid out (3, heads, hd)
        d = p.shape[0] // 3
        mask[d:2 * d] = True
    if name.endswith(SHIFT_INVARIANT):
        mask[:] = True
    return mask


def _jax_steps(jc, jm, params, jb):
    """STEPS of carel_tpu/train/steps.py's mmd step at sample=False and
    dropout 0 (value_and_grad of the model's loss, then apply_main), jitted
    once, with the loss's plain XLA ops (the Pallas MMD and BoW kernels
    compute the same function; tests/test_torch_train_step.py holds them):
    the metrics of each step and the state after the last."""
    from carel_tpu.train.steps import vae_and_classifier_loss as j_loss

    @jax.jit
    def step(state, iteration):
        def loss_fn(p):
            out = jm.apply({"params": p}, jb["input_ids"],
                           jb["attention_mask"], jb["token_type_ids"],
                           deterministic=True, sample=False)
            return j_loss(jc, out, jb, iteration, ops_impl="xla")

        (_, metrics), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            state.params)
        return state.apply_main(grads), metrics

    state = j_create_state(jc, params, jax.random.key(2))
    metrics = []
    for i in range(STEPS):
        state, m = step(state, jnp.int32(i))
        metrics.append({k: float(v) for k, v in m.items()})
    return metrics, state


@functools.lru_cache(maxsize=None)
def _three_steps(kind: str):
    """STEPS flagship train steps of each package from JAX's init
    (converted) on tests/test_torch_train_step.py's batch."""
    jc, tc = ts._cfgs("mmd")
    j_model, t_model = _model_cfgs(kind)
    j_model = dataclasses.replace(j_model, encoder=jc.model.encoder,
                                  bow_dim=jc.model.bow_dim)
    t_model = dataclasses.replace(t_model, encoder=tc.model.encoder,
                                  bow_dim=tc.model.bow_dim)
    jc = dataclasses.replace(jc, model=j_model, train=dataclasses.replace(
        jc.train, vae_lr=LR))
    tc = dataclasses.replace(tc, model=t_model, train=dataclasses.replace(
        tc.train, vae_lr=LR))
    batch = ts._batch()
    jm = JDrlModel(jc.model)
    params = jm.init({"params": jax.random.key(0),
                      "sample": jax.random.key(1)}, batch["input_ids"],
                     batch["attention_mask"],
                     batch["token_type_ids"])["params"]
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    j_metrics, j_state = _jax_steps(jc, jm, params, jb)
    model = DrlModel(tc.model)
    model.load_state_dict(jax_params_to_state_dict(_np(params)))
    start = {n: p.detach().clone() for n, p in model.named_parameters()}
    state = create_train_state(tc, model, torch.Generator())
    step = make_train_step(tc)
    zeros = torch.zeros(EC)
    tb = batch_to_device(batch, torch.device("cpu"))
    metrics, keys, grads = [], [], []
    layout, _ = pack_epoch({k: v[None] for k, v in batch.items()}, [0.0],
                           0.0)
    for i in range(STEPS):
        t_metrics = step(state, tb, i, eps=(zeros, zeros))
        metrics.append((j_metrics[i],
                        {k: float(v) for k, v in t_metrics.items()}))
        keys.append(capture_key(state, layout))
        grads.append({n for n, p in model.named_parameters()
                      if p.grad is not None})
    return dict(metrics=metrics, state=state, start=start, keys=keys,
                grads=grads,
                j_start=jax_params_to_state_dict(_np(params)),
                j_after=jax_params_to_state_dict(_np(j_state.params)))


@pytest.mark.parametrize("kind", KINDS)
def test_three_train_steps_losses_match_jax(kind):
    for i, (want, got) in enumerate(_three_steps(kind)["metrics"]):
        assert set(want) == set(got)
        for k in want:
            if not k.startswith("kl_"):
                np.testing.assert_allclose(got[k], want[k], rtol=1e-5,
                                           err_msg=f"step {i}: {k}")


@pytest.mark.parametrize("kind", KINDS)
def test_three_train_steps_params_match_jax(kind):
    run = _three_steps(kind)
    after = run["j_after"]
    err2 = ref2 = 0.0
    weights = 0
    for name, p in run["state"].model.named_parameters():
        got, want = p.detach(), after[name]
        torch.testing.assert_close(got, want, rtol=0, atol=2 * LR * STEPS,
                                   msg=name)
        if got.dim() >= 2:
            err = torch.linalg.vector_norm(got - want)
            assert float(err) <= 1e-5 * float(
                torch.linalg.vector_norm(want)), name
            weights += 1
        keep = ~_key_bias_entries(name, got)
        err2 += float(((got - want)[keep] ** 2).sum())
        ref2 += float((want[keep] ** 2).sum())
    assert (err2 / ref2) ** 0.5 <= 1e-5
    assert weights > 20


@pytest.mark.parametrize("kind", KINDS)
def test_pooler_and_v_proj_stay_and_adapters_move(kind):
    run = _three_steps(kind)
    params = dict(run["state"].model.named_parameters())
    still = [n for n in params if n.startswith("encoder.pooler.")
             or ".v_proj." in n]
    assert len(still) == (2 if kind == "raw" else 6)
    for n in still:
        assert torch.equal(params[n].detach(), run["start"][n]), n
        assert torch.equal(run["j_after"][n], run["j_start"][n]), n
    moving = [n for n in params if "adapter" in n
              and not n.endswith(SHIFT_INVARIANT) and n not in still]
    assert moving
    for n in moving:
        assert not torch.equal(params[n].detach(), run["start"][n]), n


@pytest.mark.parametrize("kind", KINDS)
def test_unread_params_get_no_gradient_and_the_capture_key_holds(kind):
    """The pooler and v_proj keep .grad None on every step and never get
    optimizer state, so the capture key of every step is the same."""
    run = _three_steps(kind)
    state = run["state"]
    unread = {n for n, _ in state.model.named_parameters()
              if n.startswith("encoder.pooler.") or ".v_proj." in n}
    for grads in run["grads"]:
        assert not grads & unread
        assert grads == run["grads"][0]
    params = dict(state.model.named_parameters())
    assert all(params[n] not in state.optimizer.state for n in unread)
    assert run["keys"][1] == run["keys"][2]


def _cli(args, cwd):
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, "-m", "carel_tpu_torch.cli",
                          *args], cwd=str(cwd), env=env, capture_output=True,
                         text=True, timeout=600)
    assert res.returncode == 0, res.stdout + res.stderr
    return json.loads(res.stdout.strip().splitlines()[-1]), res.stderr


def test_cli_train_adapter_memorization_and_infer(tmp_path):
    """train --adapter entmax --track_memorization on the CPU: base epoch,
    evaluation, two self-training iterations, memorization.png beside the
    log (where matplotlib imports); infer --adapter entmax serves the best
    checkpoint."""
    root = tmp_path / "corpus"
    write_newsplit_corpus(str(root))
    common = ["--preset", "ec_mmd_final_mul_newsplit_emnlp", "--data_root",
              str(root), "--encoder", "tiny", "--device", "cpu",
              "--adapter", "entmax", "--head_number", "4", "--max_len", "32",
              "--cache_dir", str(tmp_path / "cache"),
              "--checkpoint_dir", str(tmp_path / "ckpt"),
              "--log_dir", str(tmp_path / "logs")]
    summary, err = _cli(["train", *common, "--epochs", "1", "--batch_size",
                         "16", "--self_iteration", "2", "--self_epochs", "1",
                         "--track_memorization"], tmp_path)
    assert 0.0 <= summary["best_f1"] <= 1.0
    events = [json.loads(line) for line in err.splitlines()
              if line.startswith("{")]
    plot = [e for e in events if e["event"] == "memorization_plot"]
    assert len(plot) == 1 and [e["event"] for e in events].count(
        "memorization") == 2
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        assert plot[0]["path"] is None
    else:
        assert plot[0]["path"] and os.path.getsize(plot[0]["path"]) > 0
        assert (tmp_path / "logs" / "memorization.png").exists()
    assert (tmp_path / "ckpt" / f"{summary['model_id']}_best.pt").exists()
    res, _ = _cli(["infer", *common, "--model_id", summary["model_id"]],
                  tmp_path)
    assert 0.0 <= res["f1"] <= 1.0 and res["pairs_per_sec"] > 0
