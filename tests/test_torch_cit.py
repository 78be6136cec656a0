"""The port's CIT triple data (carel_tpu_torch/data/triples.py) and trainer
(train/cit_trainer.py, the cit verb) against the JAX package's, on the CPU
at tiny widths (tiny_encoder_config, dropout 0, fp32):

- _knn_index, build_cit_triples, triples_from_predicted_pairs,
  predicted_pair_triples and selftrain_triples equal to JAX's, string for
  string, given one numpy embedder whose embeddings tie (so the stable sort
  decides), on documents with duplicate clause texts (the first occurrence
  gives the index), self-chain pairs, pairs out of range and a document
  without pairs;
- run_cit from JAX's init (two base epochs, one self-training iteration,
  lr 1e-4): the same base and best P/R/F1, and the same refined
  predictions wherever the best params' probability lies more than 1e-4
  from 0.5 (elsewhere rounding may go either way);
- infer --output_dir chained into cit through the CLI on the synthetic
  newsplit corpus (tests/test_cit_chain.py runs the same chain for JAX over
  the reference corpus); with and without --hf_encoder (an encoder dir
  that the embed verb wrote).
"""

import json
import random

import jax
import numpy as np
import pandas as pd
import pytest

from carel_tpu.data.ecpe_format import parse_ecpe_file as j_parse
from carel_tpu.data.tokenizer import ZhCharTokenizer as JZh
from carel_tpu.data.triples import _knn_index as j_knn
from carel_tpu.data.triples import build_cit_triples as j_build_cit
from carel_tpu.data.triples import triples_from_predicted_pairs as j_from_df
from carel_tpu.models.encoder import tiny_encoder_config as j_tiny
from carel_tpu.train.cit_trainer import CitConfig as JCitConfig
from carel_tpu.train.cit_trainer import predicted_pair_triples as j_pred_tr
from carel_tpu.train.cit_trainer import run_cit as j_run_cit
from carel_tpu.train.cit_trainer import selftrain_triples as j_self_tr
from carel_tpu.train.pair_trainer import PairTrainerConfig as JPairCfg
from carel_tpu.train.pair_trainer import _predict as j_predict
from carel_tpu.train.pair_trainer import build_pair_trainer as j_build

from carel_tpu_torch.cli.main import main
from carel_tpu_torch.convert import jax_params_to_state_dict
from carel_tpu_torch.data.ecpe_format import (Clause, Document,
                                              parse_ecpe_file,
                                              write_ecpe_file)
from carel_tpu_torch.data.pairs import build_pairs
from carel_tpu_torch.data.tokenizer import ZhCharTokenizer
from carel_tpu_torch.data.triples import (_knn_index, build_cit_triples,
                                          triples_from_predicted_pairs)
from carel_tpu_torch.models.encoder import tiny_encoder_config
from carel_tpu_torch.train.cit_trainer import (CitConfig,
                                               predicted_pair_triples,
                                               run_cit, selftrain_triples)

from tests.test_torch_data import synth_docs, write_newsplit_corpus


def embedder(texts):
    """Embeddings with many ties: equal for equal texts, and for texts of
    equal length and first character class."""
    return np.asarray([[len(t) % 3, ord(t[0]) % 4 if t else 0]
                       for t in texts], np.float32)


def _examples(pair_set):
    return [(e.pair, e.label, e.emotion, e.temporal_order, e.doc_index,
             e.emo_sen_id, e.cau_sen_id) for e in pair_set.examples]


def _same(got, want):
    assert _examples(got) == _examples(want)
    assert got.docs_pair_size == want.docs_pair_size


def _doc(doc_id, texts, pairs, emotion=2):
    clauses = [Clause(sen_id=i + 1, emotion=emotion if (i + 1) in
                      {e for e, _ in pairs} else 6, cause=6, text=t,
                      emotion_raw="", cause_raw="", text_field3=t)
               for i, t in enumerate(texts)]
    return Document(doc_id=str(doc_id), pairs=pairs, clauses=clauses)


@pytest.fixture(scope="module")
def docs_file(tmp_path_factory):
    """Synthetic documents and hand-made ones: duplicate clause texts
    (clauses 1 and 3 of one, 2 and 4 of another), self-chain pairs, a pair
    out of range and a document without pairs."""
    docs = synth_docs(5, 10)
    docs += [
        _doc(11, ["甲 乙", "丙丁", "甲 乙", "戊己庚", "辛"],
             [(3, 3), (3, 1), (5, 4)]),
        _doc(12, ["子丑", "寅", "卯辰巳", "寅", "午"], [(2, 2), (4, 9)]),
        _doc(13, ["未申", "酉戌"], []),
    ]
    path = tmp_path_factory.mktemp("cit") / "docs.txt"
    write_ecpe_file(str(path), docs)
    return str(path)


def test_knn_index_equals_jax():
    rng = np.random.default_rng(0)
    for emb in (rng.normal(size=(9, 4)),
                rng.integers(0, 2, (9, 3)).astype(np.float32),  # ties
                np.zeros((3, 2))):
        for q in range(len(emb)):
            for k in range(len(emb) + 2):  # past the end: the last one
                assert _knn_index(emb, q, k) == j_knn(emb, q, k)


def test_build_cit_triples_equals_jax(docs_file):
    got = build_cit_triples(parse_ecpe_file(docs_file), embedder)
    want = j_build_cit(j_parse(docs_file), embedder)
    _same(got, want)
    pairs = [e.pair for e in got.examples]
    assert "甲乙[SEP]甲乙[SEP]甲乙" in pairs  # a self-chain positive
    assert got.docs_pair_size[-1] == 0 and got.docs_pair_size[-2] == 2


def test_triples_from_predicted_pairs_equals_jax():
    df = pd.DataFrame({"pair": ["甲[SEP]乙", "丙[SEP]丁", "戊", "己[SEP]己"],
                       "label": [1, 0, 1, 1], "emotion": [1, 2, 3, 4]})
    _same(triples_from_predicted_pairs(df), j_from_df(df))
    no_emotion = df.drop(columns=["emotion"])
    _same(triples_from_predicted_pairs(no_emotion), j_from_df(no_emotion))


def _test_set(docs_file):
    docs = parse_ecpe_file(docs_file)
    pairs = build_pairs(docs, test=True, rng=random.Random(0))
    preds = np.random.default_rng(1).integers(0, 2, len(pairs)).astype(
        np.float32)
    return docs, pairs, preds


def test_predicted_and_selftrain_triples_equal_jax(docs_file):
    docs, pairs, preds = _test_set(docs_file)
    j_docs = j_parse(docs_file)
    texts = pairs.pairs + ["no separator"]
    preds = np.concatenate([preds, [1.0]])
    got, got_idx = predicted_pair_triples(texts, preds)
    want, want_idx = j_pred_tr(texts, preds)
    _same(got, want)
    assert got_idx == want_idx and len(got_idx) > 0
    for p in (preds, np.ones_like(preds), np.zeros_like(preds)):
        got = selftrain_triples(docs, pairs.docs_pair_size, texts, p,
                                embedder)
        want = j_self_tr(j_docs, pairs.docs_pair_size, texts, p, embedder)
        _same(got, want)
    full = selftrain_triples(docs, pairs.docs_pair_size, texts,
                             np.ones_like(preds), embedder)
    assert any(e.pair.split("[SEP]")[0] == e.pair.split("[SEP]")[2]
               == e.pair.split("[SEP]")[1] for e in full.examples)


def _cit_inputs(docs_file):
    train_docs = synth_docs(7, 16)
    docs, pairs, preds = _test_set(docs_file)
    corpus = [c.text for d in train_docs + docs for c in d.clauses]
    return (train_docs, docs, pairs, preds,
            ZhCharTokenizer.from_corpus(corpus), JZh.from_corpus(corpus))


def test_run_cit_matches_jax(docs_file):
    train_docs, docs, pairs, preds, tok, jtok = _cit_inputs(docs_file)
    j_docs = j_parse(docs_file)
    kw = dict(max_len=48, batch_size=8, epochs=2, self_epochs=1,
              self_iteration=1, learning_rate=1e-4, dropout=0.0,
              eval_batch_size=16)
    cfg, jcfg = CitConfig(**kw), JCitConfig(**kw)
    enc = tiny_encoder_config(vocab_size=tok.vocab_size, dropout=0.0)
    jenc = j_tiny(vocab_size=jtok.vocab_size, dropout=0.0)
    triples = build_cit_triples(train_docs, embedder)
    labels = np.asarray(pairs.labels, np.float32)
    want = j_run_cit(jcfg, jenc, jtok, triples, j_docs,
                     pairs.docs_pair_size, pairs.pairs, preds, labels,
                     embedder)
    ptc = JPairCfg(max_len=48, batch_size=8, dropout=0.0,
                   eval_batch_size=16, seed=jcfg.seed)
    _, init_fn, _, j_eval = j_build(ptc, jenc)
    init = jax_params_to_state_dict(jax.tree_util.tree_map(
        np.asarray, init_fn(jax.random.key(jcfg.seed), 48).params))
    logs = []

    class Log:
        def log(self, record):
            logs.append(record)

    got = run_cit(cfg, enc, tok, triples, docs, pairs.docs_pair_size,
                  pairs.pairs, preds, labels, embedder, Log(), device="cpu",
                  params=init)
    events = [r["event"] for r in logs]
    assert events == ["cit_base_eval", "cit_base_eval", "cit_selftrain",
                      "cit_self_eval"]
    assert all(r["steps"] > 0 for r in logs if "steps" in r)
    assert got["base"] == want["base"] and got["best"] == want["best"]
    # where the best params' probability is clear of 0.5, both refine alike
    from carel_tpu.data.batching import encode_pairs as j_encode
    from carel_tpu.data.bow import BowVocab as JBow

    eval_triples, idx = j_pred_tr(pairs.pairs, preds)
    probs = j_predict(j_eval, want["params"], j_encode(
        eval_triples, jtok, JBow.from_words([], "zh"), 48), 16)
    clear = np.abs(probs - 0.5) > 1e-4
    assert clear.sum() > 0.9 * len(clear)
    idx = np.asarray(idx)
    np.testing.assert_array_equal(got["predictions"][idx][clear],
                                  want["predictions"][idx][clear])
    assert set(np.unique(got["predictions"])) <= {0.0, 1.0}
    assert got["params"].keys() == init.keys()


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("cit_corpus")
    write_newsplit_corpus(str(root))
    return root


@pytest.mark.parametrize("with_encoder_dir", [False, True])
def test_infer_to_cit_chain(corpus, tmp_path, capsys, with_encoder_dir):
    common = ["--data_root", str(corpus), "--encoder", "tiny", "--device",
              "cpu", "--max_test_docs", "8", "--cache_dir",
              str(tmp_path / "cache"), "--log_dir", str(tmp_path / "logs")]
    enc_args = []
    if with_encoder_dir:
        assert main(["embed", "--files",
                     str(corpus / "data/ECPE_new_dataset/home.txt"),
                     str(corpus / "pair_data/predicted_emotion/source_home/"
                                  "education.txt"),
                     "--epochs", "1", "--batch_size", "8", "--max_len", "32",
                     "--out", str(tmp_path / "enc"), *common[2:]]) == 0
        capsys.readouterr()
        enc_args = ["--hf_encoder", str(tmp_path / "enc")]
    assert main(["infer", *common, *enc_args, "--output_dir",
                 str(tmp_path / "ec_pair")]) == 0
    capsys.readouterr()
    (pred,) = (tmp_path / "ec_pair").glob("*_pred.pkl")
    (true,) = (tmp_path / "ec_pair").glob("*_true.pkl")
    assert main(["cit", *common, *enc_args, "--pred_pkl", str(pred),
                 "--true_pkl", str(true), "--epochs", "1",
                 "--self_iteration", "1", "--self_epochs", "1",
                 "--batch_size", "8", "--max_len", "48"]) == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(res) == {"base", "best"}
    assert 0.0 <= res["best"]["f1"] <= 1.0
    assert res["best"]["f1"] >= res["base"]["f1"] - 1e-9
    # a table from another candidate set is refused
    other = [a if a != "8" else "5" for a in common]
    with pytest.raises(SystemExit, match="prediction table has"):
        main(["cit", *other, *enc_args, "--pred_pkl", str(pred),
              "--true_pkl", str(true)])


def test_empty_bow_vocab_needs_no_jieba(docs_file, monkeypatch):
    """The CIT and pair classifiers encode with an empty BoW vocabulary:
    the same arrays as JAX's, and no jieba (the GPU machine has none)."""
    from carel_tpu.data.bow import BowVocab as JBow

    from carel_tpu_torch.data import bow as tbow

    def no_jieba():
        raise ImportError("jieba is not installed")

    monkeypatch.setattr(tbow, "_get_jieba", no_jieba)
    texts = _test_set(docs_file)[1].pairs
    got = tbow.BowVocab.from_words([], "zh").batch_sparse(texts, 16)
    want = JBow.from_words([], "zh").batch_sparse(texts, 16)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    with pytest.raises(ImportError):
        tbow.BowVocab.from_words(["难过"], "zh").batch_sparse(texts, 16)
