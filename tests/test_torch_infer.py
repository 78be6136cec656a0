"""The port's serving path (``carel_tpu_torch.infer`` and the ``infer`` verb)
against ``carel_tpu.infer``, on the CPU.

One synthetic zh corpus goes through the port's pipeline; its test pairs,
arrays and tokenizer are handed to both packages, the JAX model's random
params are converted for the port, and both score with ``sample=False`` (the
two frameworks draw different noise from the same seed). Probabilities agree
to atol 1e-5 (fp32 on both sides, sums in another order); P/R/F1, the
predictions and the pickles' columns and labels are equal. The cases run the
default attention and ``attention_impl="flash"`` (JAX takes its XLA attention
on the CPU either way; only ``pooled`` reaches the heads, and it agrees). A
batch size that does not divide the pair count exercises the padded tail,
whose rows are all pads.
"""

import dataclasses
import json

import jax
import numpy as np
import pandas as pd
import pytest
import torch

from carel_tpu.config import CarelConfig as JCarelConfig
from carel_tpu.config import DataConfig as JDataConfig
from carel_tpu.config import ModelConfig as JModelConfig
from carel_tpu.data.batching import PairArrays as JPairArrays
from carel_tpu.data.pairs import PairExample as JPairExample
from carel_tpu.data.pairs import PairSet as JPairSet
from carel_tpu.infer import PairScorer as JPairScorer
from carel_tpu.infer import run_pair_inference as j_run_pair_inference
from carel_tpu.infer import score_pairs as j_score_pairs
from carel_tpu.models.drl import DrlModel as JDrlModel
from carel_tpu.models.encoder import tiny_encoder_config as j_tiny
from carel_tpu.train.steps import make_eval_step as j_make_eval_step

from carel_tpu_torch.cli.main import main
from carel_tpu_torch.config import PRESETS
from carel_tpu_torch.convert import jax_params_to_state_dict
from carel_tpu_torch.infer import (InferenceResult, PairScorer,
                                   pair_inference, run_pair_inference,
                                   score_pairs)
from carel_tpu_torch.models.drl import DrlModel
from carel_tpu_torch.models.encoder import tiny_encoder_config
from carel_tpu_torch.pipeline import build_pipeline, init_state
from carel_tpu_torch.train import checkpoint as ckpt
from carel_tpu_torch.train.loop import evaluate
from carel_tpu_torch.train.steps import make_eval_step
from tests.test_torch_data import write_newsplit_corpus

FLAGSHIP = "ec_mmd_final_mul_newsplit_emnlp"
BATCH = 8


@pytest.fixture(scope="module")
def pipe(tmp_path_factory):
    root = tmp_path_factory.mktemp("infer_corpus")
    write_newsplit_corpus(str(root))
    cfg = PRESETS[FLAGSHIP]
    cfg = dataclasses.replace(
        cfg, data=dataclasses.replace(cfg.data, data_root=str(root)))
    return build_pipeline(cfg, cache_dir=str(root / "cache"),
                          encoder_cfg=tiny_encoder_config(dropout=0.0))


@pytest.fixture(scope="module", params=["xla", "flash"])
def both(request, pipe):
    """The same random params in a JAX and a port model, with the JAX
    package's own PairSet and PairArrays of the same pairs."""
    impl = request.param
    mc = pipe.cfg.model
    enc = dict(vocab_size=mc.encoder.vocab_size, dropout=0.0,
               attention_impl=impl)
    jcfg = JCarelConfig(
        model=JModelConfig(encoder=j_tiny(**enc), ec_dim=mc.ec_dim,
                           bow_dim=mc.bow_dim, dropout=0.0),
        data=JDataConfig(max_len=pipe.cfg.data.max_len, language="zh"))
    tcfg = dataclasses.replace(pipe.cfg, model=dataclasses.replace(
        mc, encoder=tiny_encoder_config(**enc), dropout=0.0))
    arrays = pipe.test_arrays
    jm = JDrlModel(jcfg.model)
    params = jm.init({"params": jax.random.key(0), "sample": jax.random.key(1)},
                     arrays.input_ids[:2], arrays.attention_mask[:2],
                     arrays.token_type_ids[:2])["params"]
    model = DrlModel(tcfg.model)
    model.load_state_dict(jax_params_to_state_dict(
        jax.tree_util.tree_map(np.asarray, params)))
    j_arrays = JPairArrays(**{f: getattr(arrays, f)
                              for f in arrays.__dataclass_fields__})
    j_pairs = JPairSet(
        [JPairExample(**dataclasses.asdict(e))
         for e in pipe.test_pairs.examples],
        list(pipe.test_pairs.docs_pair_size),
        num_unpred_emotions=pipe.test_pairs.num_unpred_emotions)
    return dict(jcfg=jcfg, tcfg=tcfg, jm=jm, params=params, model=model,
                j_arrays=j_arrays, j_pairs=j_pairs)


def test_score_pairs_matches_jax(both, pipe):
    arrays = pipe.test_arrays
    assert len(arrays) % BATCH != 0  # the last batch is padded
    want, j_times = j_score_pairs(
        j_make_eval_step(both["jcfg"], both["jm"], sample=False),
        both["params"], both["j_arrays"], jax.random.key(0), BATCH)
    got, times = score_pairs(make_eval_step(sample=False), both["model"],
                             arrays, torch.Generator().manual_seed(0), BATCH)
    assert got.shape == (len(arrays),) and got.dtype == np.float32
    assert times.shape == j_times.shape == (-(-len(arrays) // BATCH),)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    assert 0.05 < got.min() and got.max() < 0.95  # not saturated


def test_run_pair_inference_matches_jax(both, pipe, tmp_path):
    assert pipe.test_pairs.num_unpred_emotions > 0  # forced misses count
    want = j_run_pair_inference(
        j_make_eval_step(both["jcfg"], both["jm"], sample=False),
        both["params"], both["j_pairs"], both["j_arrays"],
        batch_size=BATCH, output_dir=str(tmp_path / "jax"), model_id="m")
    got = run_pair_inference(
        make_eval_step(sample=False), both["model"], pipe.test_pairs,
        pipe.test_arrays, batch_size=BATCH,
        output_dir=str(tmp_path / "torch"), model_id="m")
    assert isinstance(got, InferenceResult)
    np.testing.assert_allclose(got.probs, want.probs, atol=1e-5, rtol=0)
    np.testing.assert_array_equal(got.preds, want.preds)
    assert got.preds.dtype == want.preds.dtype
    assert (got.precision, got.recall, got.f1) == \
        (want.precision, want.recall, want.f1)
    assert 0.0 < got.p50_batch_ms <= got.p95_batch_ms
    assert got.pairs_per_sec > 0.0
    for kind in ("true", "pred"):
        t_df = pd.read_pickle(tmp_path / "torch" / f"m_{kind}.pkl")
        j_df = pd.read_pickle(tmp_path / "jax" / f"m_{kind}.pkl")
        assert list(t_df.columns) == list(j_df.columns) == \
            ["pair", "emotion", "label"]
        pd.testing.assert_frame_equal(t_df, j_df)
    assert t_df["label"].tolist() == got.preds.tolist()


def test_first_batch_is_left_out_of_the_latency(both, pipe, monkeypatch):
    """With more than one batch the statistics leave the first out; pairs/s
    counts the pairs after it."""
    clock = iter(np.arange(0.0, 1000.0, 0.5))
    calls = []

    def timed_eval(model, batch, generator):
        calls.append(next(clock))
        return torch.full((BATCH,), 0.25)

    monkeypatch.setattr(pair_inference.time, "perf_counter",
                        lambda: next(clock))
    res = run_pair_inference(timed_eval, both["model"], pipe.test_pairs,
                             pipe.test_arrays, batch_size=BATCH)
    monkeypatch.undo()
    n = len(pipe.test_arrays)
    assert len(calls) == -(-n // BATCH) > 2
    # every batch takes 1.0 s on this clock (one tick inside eval)
    assert res.p50_batch_ms == res.p95_batch_ms == 1000.0
    np.testing.assert_allclose(res.pairs_per_sec,
                               (n - BATCH) / (len(calls) - 1.0))
    assert res.preds.sum() == 0 and res.f1 == 0.0


def test_pair_scorer_matches_jax(both, pipe):
    j_scorer = JPairScorer(both["jcfg"], both["jm"], both["params"],
                           pipe.tokenizer, batch_size=4)
    scorer = PairScorer.from_pipeline(
        dataclasses.replace(pipe, cfg=both["tcfg"]), both["model"],
        batch_size=4, device="cpu")
    assert scorer.sep == "[SEP]" and scorer.max_len == pipe.cfg.data.max_len
    strings = pipe.test_pairs.pairs[:6]  # 6 strings: one padded batch of 4
    np.testing.assert_allclose(scorer.score_pair_strings(strings),
                               j_scorer.score_pair_strings(strings),
                               atol=1e-5, rtol=0)
    clauses = [s.split("[SEP]")[0] for s in strings]
    raw = [(" " + clauses[0] + " ", c[:2] + " " + c[2:]) for c in clauses]
    got = scorer.score_texts(raw)
    assert got.shape == (6,)
    np.testing.assert_allclose(got, j_scorer.score_texts(raw), atol=1e-5,
                               rtol=0)
    # the candidate sweep: every pair above a threshold below all of them
    low = float(got.min()) / 2
    hits = scorer.extract_document(clauses, [1, 3], threshold=low)
    want = j_scorer.extract_document(clauses, [1, 3], threshold=low)
    assert len(hits) == len(want) == 2 * len(clauses)
    assert [p for *_, p in hits] == sorted((p for *_, p in hits),
                                           reverse=True)
    assert sorted(h[:2] for h in hits) == sorted(w[:2] for w in want)
    np.testing.assert_allclose(sorted(p for *_, p in hits),
                               sorted(p for *_, p in want), atol=1e-5, rtol=0)
    assert scorer.extract_document(clauses, []) == []
    assert scorer.extract_document(clauses, [1], threshold=1.0) == []


def _cli_args(verb, root, tmp):
    return [verb, "--preset", FLAGSHIP, "--data_root", str(root),
            "--encoder", "tiny", "--cache_dir", str(tmp / "cache"),
            "--checkpoint_dir", str(tmp / "ckpt"),
            "--log_dir", str(tmp / "logs")]


def test_cli_train_then_infer_on_cpu(tmp_path, capsys):
    """``train`` saves the best; ``infer --model_id`` reloads it, prints the
    JAX verb's keys and the P/R/F1 that ``evaluate`` gives on the reloaded
    model with the verb's seed, and writes the pickles."""
    root = tmp_path / "corpus"
    write_newsplit_corpus(str(root))
    assert main(_cli_args("train", root, tmp_path) + [
        "--epochs", "1", "--batch_size", "16", "--self_iteration", "0",
        "--device", "cpu"]) == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["best_f1"] > 0.0, "no best checkpoint to serve"
    model_id = summary["model_id"]

    assert main(_cli_args("infer", root, tmp_path) + [
        "--model_id", model_id, "--output_dir", str(tmp_path / "out"),
        "--device", "cpu"]) == 0
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert list(printed) == ["precision", "recall", "f1", "p50_batch_ms",
                             "p95_batch_ms", "pairs_per_sec"]

    cfg = PRESETS[FLAGSHIP]
    cfg = dataclasses.replace(
        cfg, data=dataclasses.replace(cfg.data, data_root=str(root)),
        train=dataclasses.replace(cfg.train,
                                  checkpoint_dir=str(tmp_path / "ckpt")))
    pipe = build_pipeline(cfg, cache_dir=str(tmp_path / "cache"),
                          encoder_cfg=tiny_encoder_config())
    model = init_state(pipe.cfg, "cpu").model
    model.load_state_dict(ckpt.load_best(str(tmp_path / "ckpt"), model_id,
                                         torch.device("cpu")))
    want = evaluate(make_eval_step(), model, pipe.test_arrays,
                    pipe.num_unpred_pairs, torch.Generator().manual_seed(0),
                    pipe.cfg.train.eval_batch_size)
    assert (printed["precision"], printed["recall"], printed["f1"]) == \
        (want.precision, want.recall, want.f1)
    pred = pd.read_pickle(tmp_path / "out" / f"{model_id}_pred.pkl")
    true = pd.read_pickle(tmp_path / "out" / f"{model_id}_true.pkl")
    assert pred["label"].tolist() == np.round(want.probs).astype(int).tolist()
    assert true["label"].tolist() == pipe.test_pairs.labels
    assert pred["pair"].tolist() == pipe.test_pairs.pairs


def test_infer_without_device_flag_needs_a_gpu(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(_cli_args("infer", tmp_path / "corpus", tmp_path))
    assert not (tmp_path / "cache").exists()  # raised before any work
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PairScorer(PRESETS[FLAGSHIP], torch.nn.Linear(1, 1), None)
