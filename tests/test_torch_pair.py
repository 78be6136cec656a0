"""The plain pair classifier (the ``pair`` verb) of the port against the JAX
package's, on the CPU at tiny widths (tiny_encoder_config, dropout 0):

- ``encode_sentence_pair_batch`` and ``encode_pairs(sentence_pair=True)``
  bit-equal to JAX's for every tokenizer class: zh characters, a trained
  WordPiece (through one saved file) and a local HF tokenizer dir;
- one train step of models/pair_classifier.py + train/pair_trainer.py from
  JAX's init (convert.py): the loss within rtol 1e-5, the params normwise
  within 1e-5 (each weight tensor and the whole set, the key biases left
  out of the set: tests/test_torch_adapters.py says why) and every entry
  within 2 lr;
- a whole train_pair_classifier run on a synthetic zh corpus (two base
  epochs and one threshold self-training iteration, lr 1e-4, from JAX's
  init): the same best P/R/F1 and the best params' probabilities within
  1e-4;
- the pair verb through the CLI on the CPU, plain, and with
  --sentence_pair and --self_chain; its last line is {"p", "r", "f1"}.
"""

import json
import os
import pathlib
import random
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from carel_tpu.data.batching import encode_pairs as j_encode_pairs
from carel_tpu.data.bow import BowVocab as JBowVocab
from carel_tpu.data.ecpe_format import parse_ecpe_file as j_parse
from carel_tpu.data.pairs import build_pairs as j_build_pairs
from carel_tpu.data.tokenizer import HFTokenizerAdapter as JHF
from carel_tpu.data.tokenizer import ZhCharTokenizer as JZh
from carel_tpu.models.encoder import tiny_encoder_config as j_tiny
from carel_tpu.train.pair_trainer import PairTrainerConfig as JPairConfig
from carel_tpu.train.pair_trainer import _predict as j_predict
from carel_tpu.train.pair_trainer import build_pair_trainer as j_build
from carel_tpu.train.pair_trainer import train_pair_classifier as j_train

from carel_tpu_torch.convert import jax_params_to_state_dict
from carel_tpu_torch.data.batching import encode_pairs
from carel_tpu_torch.data.bow import BowVocab
from carel_tpu_torch.data.ecpe_format import parse_ecpe_file
from carel_tpu_torch.data.pairs import build_pairs
from carel_tpu_torch.data.tokenizer import HFTokenizerAdapter as THF
from carel_tpu_torch.data.tokenizer import ZhCharTokenizer
from carel_tpu_torch.models.encoder import tiny_encoder_config
from carel_tpu_torch.train.pair_trainer import (PairTrainerConfig, _predict,
                                                build_pair_trainer,
                                                train_pair_classifier)
from carel_tpu_torch.train.steps import batch_to_device

from tests import test_torch_adapters as ta
from tests.test_torch_data import write_newsplit_corpus, write_oldsplit_corpus
from tests.test_torch_tokenizer_en import _pair_texts, both, hf_tokenizer_dir  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parents[1]
TRAIN = "data/ECPE_new_dataset/home.txt"
TEST = "pair_data/predicted_emotion/source_home/education.txt"


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _assert_same(got, want):
    for f in ("input_ids", "attention_mask", "token_type_ids"):
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("pair_corpus")
    write_newsplit_corpus(str(root))
    return root


def _split(texts):
    return ([t.split("[SEP]")[0] for t in texts],
            [t.split("[SEP]")[-1] for t in texts])


def test_sentence_pair_encoding_zh_equals_jax(corpus):
    docs = parse_ecpe_file(str(corpus / TRAIN))
    text = [c.text for d in docs for c in d.clauses]
    got_tok, want_tok = ZhCharTokenizer.from_corpus(text), \
        JZh.from_corpus(text)
    pairs = build_pairs(docs, rng=random.Random(0))
    a, b = _split(pairs.pairs)
    for max_len in (8, 40):
        _assert_same(got_tok.encode_sentence_pair_batch(a, b, max_len),
                     want_tok.encode_sentence_pair_batch(a, b, max_len))
    j_pairs = j_build_pairs(j_parse(str(corpus / TRAIN)),
                            rng=random.Random(0))
    assert j_pairs.pairs == pairs.pairs
    got = encode_pairs(pairs, got_tok, BowVocab.from_words([], "zh"), 40,
                       sentence_pair=True)
    want = j_encode_pairs(j_pairs, want_tok, JBowVocab.from_words([], "zh"),
                          40, sentence_pair=True)
    for f in got.__dataclass_fields__:
        assert np.array_equal(getattr(got, f), getattr(want, f)), f
    assert got.token_type_ids.max() == 1


def test_sentence_pair_encoding_wordpiece_equals_jax(both):  # noqa: F811
    got_tok, want_tok = both
    a, b = _split(_pair_texts())
    for max_len in (8, 48):
        _assert_same(got_tok.encode_sentence_pair_batch(a, b, max_len),
                     want_tok.encode_sentence_pair_batch(a, b, max_len))


def test_sentence_pair_encoding_hf_dir_equals_jax(both, tmp_path):  # noqa: F811
    path = hf_tokenizer_dir(both[0], str(tmp_path / "hf_tok"))
    got_tok, want_tok = THF.load(path), JHF.load(path)
    a, b = _split(_pair_texts())
    for max_len in (8, 48):
        _assert_same(got_tok.encode_sentence_pair_batch(a, b, max_len),
                     want_tok.encode_sentence_pair_batch(a, b, max_len))


def _arrays(corpus, L=32):
    """Both packages' train/test PairArrays and PairSets, and each one's
    encoder of a pseudo set, from the same files."""
    out = {}
    for name, parse, build, tok_cls, bow_cls, enc in (
            ("t", parse_ecpe_file, build_pairs, ZhCharTokenizer, BowVocab,
             encode_pairs),
            ("j", j_parse, j_build_pairs, JZh, JBowVocab, j_encode_pairs)):
        train_docs = parse(str(corpus / TRAIN))
        test_docs = parse(str(corpus / TEST))
        tok = tok_cls.from_corpus([c.text for d in train_docs + test_docs
                                   for c in d.clauses])
        bow = bow_cls.from_words([], "zh")
        train = build(train_docs, test=False, rng=random.Random(42))
        test = build(test_docs, test=True)

        def encode(ps, tok=tok, bow=bow, enc=enc):
            return enc(ps, tok, bow, L)

        out[name] = (encode(train), encode(test), test, encode, tok)
    return out


def _enc_cfgs(vocab):
    return (tiny_encoder_config(vocab_size=vocab, dropout=0.0),
            j_tiny(vocab_size=vocab, dropout=0.0))


def test_one_pair_step_matches_jax(corpus):
    arrays = _arrays(corpus)
    train = arrays["t"][0]
    enc, j_enc = _enc_cfgs(arrays["t"][4].vocab_size)
    cfg = PairTrainerConfig(max_len=32, batch_size=8, dropout=0.0)
    jcfg = JPairConfig(max_len=32, batch_size=8, dropout=0.0)
    _, init_fn, j_step, _ = j_build(jcfg, j_enc)
    j_state = init_fn(jax.random.key(0), 32)
    from carel_tpu_torch.data.batching import cut_batch

    batch = cut_batch(train, np.arange(6), 8).as_dict()  # 2 padded rows
    params, _, j_loss = j_step(j_state.params, j_state.opt_state,
                               {k: jnp.asarray(v) for k, v in batch.items()},
                               jax.random.key(1))
    model, _, step, _ = build_pair_trainer(
        cfg, enc, "cpu", jax_params_to_state_dict(_np(j_state.params)))
    loss = step(batch_to_device(batch, torch.device("cpu")))
    np.testing.assert_allclose(float(loss), float(j_loss), rtol=1e-5)
    want = jax_params_to_state_dict(_np(params))
    err2 = ref2 = 0.0
    for name, p in model.named_parameters():
        got = p.detach()
        torch.testing.assert_close(got, want[name], rtol=0,
                                   atol=2 * cfg.learning_rate, msg=name)
        if got.dim() >= 2:
            assert float(torch.linalg.vector_norm(got - want[name])) <= \
                1e-5 * float(torch.linalg.vector_norm(want[name])), name
        keep = ~ta._key_bias_entries(name, got)
        err2 += float(((got - want[name])[keep] ** 2).sum())
        ref2 += float((want[name][keep] ** 2).sum())
    assert (err2 / ref2) ** 0.5 <= 1e-5


def test_train_pair_classifier_matches_jax(corpus):
    """Two base epochs and one threshold self-training iteration from
    JAX's init: equal best P/R/F1, probabilities within 1e-4."""
    arrays = _arrays(corpus)
    t_train, t_test, t_pairs, t_encode, tok = arrays["t"]
    j_train_arr, j_test, j_pairs, j_encode, _ = arrays["j"]
    assert np.array_equal(t_train.input_ids, j_train_arr.input_ids)
    enc, j_enc = _enc_cfgs(tok.vocab_size)
    kw = dict(max_len=32, batch_size=8, epochs=2, self_epochs=1,
              self_iteration=1, learning_rate=1e-4, dropout=0.0,
              eval_batch_size=16)
    jcfg, cfg = JPairConfig(**kw), PairTrainerConfig(**kw)
    _, init_fn, _, j_eval = j_build(jcfg, j_enc)
    init = jax_params_to_state_dict(_np(init_fn(jax.random.key(jcfg.seed),
                                                32).params))
    j_best_params, j_best = j_train(jcfg, j_enc, j_train_arr, j_test, 0,
                                    j_pairs, j_encode)
    logs = []

    class Log:
        def log(self, record):
            logs.append(record)

    best_params, best = train_pair_classifier(
        cfg, enc, t_train, t_test, 0, t_pairs, t_encode, Log(),
        device="cpu", params=init)
    # two base evaluations and one after the self-training epoch: the
    # iteration found a pseudo set and trained on it
    assert len(logs) == 3
    assert best == pytest.approx(j_best, abs=0) and best[2] > 0
    _, _, _, eval_step = build_pair_trainer(cfg, enc, "cpu", best_params)
    probs = _predict(eval_step, t_test, 16, torch.device("cpu"))
    want = j_predict(j_eval, j_best_params, j_test, 16)
    np.testing.assert_allclose(probs, want, rtol=0, atol=1e-4)


def _cli(args, cwd):
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, "-m", "carel_tpu_torch.cli",
                          "pair", *args], cwd=str(cwd), env=env,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stdout + res.stderr
    return json.loads(res.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("variant", ["plain", "sentence_pair_self_chain"])
def test_pair_verb_runs_on_cpu(tmp_path, variant):
    root = tmp_path / "corpus"
    args = ["--data_root", str(root), "--encoder", "tiny", "--device",
            "cpu", "--epochs", "1", "--batch_size", "16", "--max_len", "32",
            "--self_iteration", "1", "--self_epochs", "1",
            "--cache_dir", str(tmp_path / "cache"),
            "--log_dir", str(tmp_path / "logs")]
    if variant == "plain":
        write_newsplit_corpus(str(root))
    else:
        write_oldsplit_corpus(str(root))
        args += ["--preset", "ec_mmd_self_chain", "--sentence_pair",
                 "--self_chain"]
    res = _cli(args, tmp_path)
    assert set(res) == {"p", "r", "f1"}
    assert all(0.0 <= v <= 1.0 for v in res.values())
    events = [json.loads(line)["event"] for line in
              next((tmp_path / "logs").glob("pair_*.jsonl")).read_text()
              .splitlines()]
    assert events.count("pair_eval") >= 1
