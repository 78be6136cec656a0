"""The port's analysis tools and their verbs against carel_tpu's, on the CPU
at tiny widths:

- MlmScorer over one MLM (JAX's random init, saved by orbax for JAX and
  converted into the port's MLM dir): scores within 1e-5 (relative past 1),
  the premise-fills-the-window case -inf on both;
- ordering_probe: equal stats with a scorer and without, and the ordering
  verb's JSON equal to JAX's, with --mlm_model (a pinned tokenizer) and
  without; its refusal without a pinned or cached tokenizer;
- compare_checkpoints with the deterministic mean-latent evaluation: the
  same CSV rows, forced-miss F1s within 1e-6, equal split counts and F1s;
  the case_analysis verb over two best checkpoints prints JAX's keys;
- search: the same trials, values and pruning with a synthetic objective;
  the hpo verb (2 trials of 1 epoch) prints JAX's keys;
- the dataset converters: byte-equal outputs, and the convert verb;
- vis: TF-IDF embeddings and PCA / LDA / t-SNE coordinates within 1e-6,
  the PNG written, and the vis verb;
- event_analysis: equal counts; utils.text: within 1e-6, load_w2v equal;
- mmd_permutation_test: the observed statistic within 1e-6 of JAX's, and
  the p-value within 3 sigma of binomial noise at 2,000 permutations (the
  two packages draw other permutations), on samples of one distribution
  and of two.
"""

import csv
import dataclasses
import json
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from carel_tpu.cli.main import main as jmain
from carel_tpu.config import PRESETS as JPRESETS
from carel_tpu.data.ecpe_format import parse_ecpe_file as j_parse
from carel_tpu.data.tokenizer import ZhCharTokenizer as JZh
from carel_tpu.models.encoder import tiny_encoder_config as j_tiny
from carel_tpu.ops.pairwise import mmd_permutation_test as j_perm_test
from carel_tpu.pretrain import mlm as jmlm
from carel_tpu.tools import convert as jconvert
from carel_tpu.tools import vis as jvis
from carel_tpu.tools.case_analysis import compare_checkpoints as j_compare
from carel_tpu.tools.event_analysis import analyze_cause_clauses as j_events
from carel_tpu.tools.hpo import search as j_search
from carel_tpu.tools.mlm_scorer import MlmScorer as JScorer
from carel_tpu.tools.ordering import ordering_probe as j_probe
from carel_tpu.train.steps import make_eval_step as j_make_eval_step
from carel_tpu.utils import text as jtext

from carel_tpu_torch.cli.main import main
from carel_tpu_torch.config import PRESETS
from carel_tpu_torch.convert import jax_params_to_state_dict
from carel_tpu_torch.data.ecpe_format import parse_ecpe_file, write_ecpe_file
from carel_tpu_torch.data.tokenizer import ZhCharTokenizer
from carel_tpu_torch.models.encoder import tiny_encoder_config
from carel_tpu_torch.ops.pairwise import mmd_permutation_test
from carel_tpu_torch.pretrain import mlm as tmlm
from carel_tpu_torch.tools import convert as tconvert
from carel_tpu_torch.tools import vis as tvis
from carel_tpu_torch.tools.case_analysis import compare_checkpoints
from carel_tpu_torch.tools.event_analysis import analyze_cause_clauses
from carel_tpu_torch.tools.hpo import search
from carel_tpu_torch.tools.mlm_scorer import MlmScorer
from carel_tpu_torch.tools.ordering import ordering_probe
from carel_tpu_torch.train.steps import make_eval_step
from carel_tpu_torch.utils import text as ttext

from tests.test_torch_data import synth_docs, write_newsplit_corpus
from tests.test_torch_infer import both, pipe  # noqa: F401  (fixtures)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _last_json(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


# --- the MLM scorer and the ordering probe ---------------------------------

@pytest.fixture(scope="module")
def mlm(tmp_path_factory):
    """An ECPE file, its tokenizer pinned beside two MLM dirs holding one
    random MLM (tiny, as the verbs' `--encoder tiny` builds it): JAX's
    orbax dir and the port's mlm.pt."""
    root = tmp_path_factory.mktemp("mlm")
    path = str(root / "docs.txt")
    write_ecpe_file(path, synth_docs(3, 12))
    texts = [c.text.strip().replace(" ", "") for d in parse_ecpe_file(path)
             for c in d.clauses]
    jt = JZh.from_corpus(texts)
    enc = j_tiny(vocab_size=jt.vocab_size)
    probe = jnp.zeros((1, 64), jnp.int32)
    params = jmlm.MlmModel(enc).init(jax.random.key(7), probe,
                                     jnp.ones_like(probe))["params"]
    jdir, tdir = str(root / "jax_mlm"), str(root / "torch_mlm")
    jmlm.save_encoder(jdir, params)
    tmlm.save_mlm(tdir, jax_params_to_state_dict(_np(params)))
    for d in (jdir, tdir):
        jt.save(d + ".tokenizer.json")
    return dict(path=path, texts=texts, jt=jt, enc=enc, jdir=jdir,
                tdir=tdir)


def _pairs(texts):
    return [(texts[i], texts[i + 1]) for i in range(0, 12, 2)] + [
        ("".join(texts[:12]), texts[12])]  # the premise fills the window


def test_mlm_scorer_matches_jax(mlm):
    jt = mlm["jt"]
    tt = ZhCharTokenizer.load(mlm["tdir"] + ".tokenizer.json")
    want = JScorer(mlm["jdir"], jt, mlm["enc"])
    got = MlmScorer(mlm["tdir"], tt, tiny_encoder_config(
        vocab_size=tt.vocab_size), device="cpu")
    pairs = _pairs(mlm["texts"])
    scores = [(got(p, h), want(p, h)) for p, h in pairs]
    assert scores[-1] == (float("-inf"), float("-inf"))
    for g, w in scores[:-1]:
        assert math.isfinite(w) and w < 0
        assert abs(g - w) <= 1e-5 * max(1.0, abs(w)), (g, w)


def test_ordering_probe_matches_jax(mlm):
    def scorer(p, h):
        return float(len(p) - len(h))

    for s in (None, scorer):
        got = ordering_probe(parse_ecpe_file(mlm["path"]), s)
        want = j_probe(j_parse(mlm["path"]), s)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert got.temporal_order_rate == want.temporal_order_rate
    assert got.scored_pairs > 0


def test_ordering_verb_matches_jax(mlm, capsys):
    common = ["--file", mlm["path"], "--encoder", "tiny", "--language", "zh"]
    assert jmain(["ordering", *common]) == 0
    want = _last_json(capsys)
    assert main(["ordering", *common]) == 0
    assert _last_json(capsys) == want
    assert jmain(["ordering", *common, "--cpu", "--mlm_model",
                  mlm["jdir"]]) == 0
    want = _last_json(capsys)
    assert main(["ordering", *common, "--device", "cpu", "--mlm_model",
                 mlm["tdir"]]) == 0
    assert _last_json(capsys) == want
    assert want["scored_pairs"] > 0


def test_ordering_mlm_requires_pinned_tokenizer(mlm, tmp_path):
    with pytest.raises(SystemExit, match="no tokenizer found"):
        main(["ordering", "--cpu", "--file", mlm["path"], "--mlm_model",
              str(tmp_path / "no_such_mlm"), "--language", "zh",
              "--cache_dir", str(tmp_path / "empty_cache")])


# --- case analysis ----------------------------------------------------------

def test_compare_checkpoints_matches_jax(both, pipe, tmp_path):  # noqa: F811
    params_a = both["params"]
    params_b = jax.tree_util.tree_map(lambda a: a * 1.05, params_a)
    docs = parse_ecpe_file(os.path.join(
        pipe.cfg.data.data_root,
        "pair_data/predicted_emotion/source_home/education.txt"))
    want = j_compare(
        j_make_eval_step(both["jcfg"], both["jm"], sample=False), params_a,
        params_b, both["j_pairs"], both["j_arrays"], docs,
        str(tmp_path / "jax.csv"), batch_size=8)
    sa, sb = (jax_params_to_state_dict(_np(p)) for p in (params_a, params_b))
    got = compare_checkpoints(
        make_eval_step(sample=False), both["model"], sa, sb,
        pipe.test_pairs, pipe.test_arrays, docs, str(tmp_path / "t.csv"),
        batch_size=8)
    rows = [list(csv.reader(open(tmp_path / n, encoding="utf8")))
            for n in ("t.csv", "jax.csv")]
    assert rows[0] == rows[1] and len(rows[0]) == len(pipe.test_arrays) + 1
    assert abs(got.model_a_f1 - want.model_a_f1) <= 1e-6
    assert abs(got.model_b_f1 - want.model_b_f1) <= 1e-6
    assert got.self_chain_counts == want.self_chain_counts
    assert got.normal_counts == want.normal_counts
    assert got.split_f1 == want.split_f1


def test_case_analysis_and_hpo_verbs(tmp_path, capsys):
    """Two best checkpoints (random inits of two seeds) compared by the
    case_analysis verb, and two hpo trials of one epoch; both print the JAX
    verbs' keys."""
    from carel_tpu_torch.pipeline import build_pipeline, init_state
    from carel_tpu_torch.train import checkpoint as ckpt

    root = str(tmp_path / "corpus")
    write_newsplit_corpus(root)
    common = ["--data_root", root, "--encoder", "tiny", "--device", "cpu",
              "--cache_dir", str(tmp_path / "cache"), "--checkpoint_dir",
              str(tmp_path / "ckpt"), "--log_dir", str(tmp_path / "logs"),
              "--epochs", "1", "--batch_size", "8"]
    cfg = PRESETS["ec_mmd_final_mul_newsplit_emnlp"]
    cfg = dataclasses.replace(cfg, data=dataclasses.replace(
        cfg.data, data_root=root))
    built = build_pipeline(cfg, cache_dir=str(tmp_path / "cache"),
                           encoder_cfg=tiny_encoder_config())
    for seed in (1, 2):
        seeded = dataclasses.replace(built.cfg, train=dataclasses.replace(
            built.cfg.train, seed=seed))
        ckpt.save_best(str(tmp_path / "ckpt"), f"m{seed}",
                       init_state(seeded, "cpu").model.state_dict())
    out_csv = str(tmp_path / "cmp.csv")
    assert main(["case_analysis", *common, "--model_id_a", "m1",
                 "--model_id_b", "m2", "--out_csv", out_csv]) == 0
    out = _last_json(capsys)
    assert set(out) == {"model_a_f1", "model_b_f1", "csv", "self_chain",
                        "normal", "split_f1"}
    assert out["csv"] == out_csv
    rows = list(csv.reader(open(out_csv, encoding="utf8")))
    assert len(rows) == len(built.test_arrays) + 1
    assert out["self_chain"]["total"] + out["normal"]["total"] == \
        len(built.test_arrays)
    assert main(["hpo", *common, "--n_trials", "2"]) == 0
    out = _last_json(capsys)
    assert set(out) == {"best_value", "best_params", "trials"}
    assert out["trials"] == 2
    events = [json.loads(line) for log in (tmp_path / "logs").glob(
        "hpo_*.jsonl") for line in log.read_text().splitlines()]
    assert [e["number"] for e in events if e["event"] == "hpo_trial"] == \
        [0, 1]


# --- hyperparameter search --------------------------------------------------

def test_search_matches_jax():
    """A synthetic objective that reports three steps; the median pruner
    fires after its five warm-up trials."""

    def objective(cfg, report):
        v = min(cfg.loss.mmd_loss_weight / 100.0, 1.0) \
            * cfg.train.vae_lr * 1e4
        for step in range(3):
            report(step, v * (step + 1))
        return v

    got_best, got = search(objective, PRESETS["ec_mmd_final_mul"],
                           n_trials=20, seed=3)
    want_best, want = j_search(objective, JPRESETS["ec_mmd_final_mul"],
                               n_trials=20, seed=3)
    assert [dataclasses.asdict(t) for t in got] == \
        [dataclasses.asdict(t) for t in want]
    assert got_best.number == want_best.number
    assert any(t.pruned for t in got) and not all(t.pruned for t in got)


# --- dataset conversion -----------------------------------------------------

RECCON = ("1 2\n(2, 1),\n1\thappy\thappiness\tI got the job, finally\n"
          "2\tneutral\t-1\tthat is great news\n"
          "2 3\n(3, 2),\n1\tsad\tsadness\tno, not again\n"
          "2\tangry\tanger\the left, slamming the door\n"
          "3\tsurprised\tsurprise\twhat a day\n")


def _conversions(cv, d):
    """Every conversion of ``cv`` into dir ``d``; the files it wrote."""
    os.makedirs(d, exist_ok=True)
    src = os.path.join(d, "reccon.txt")
    with open(src, "w", encoding="utf8") as f:
        f.write(RECCON)
    for minusone in (False, True):
        for bow in (False, True):
            cv.reccon_to_ecpe(src, os.path.join(d, f"r{minusone}{bow}.txt"),
                              minusone=minusone, bow_optimize=bow)
    ecpe = os.path.join(d, "rFalseFalse.txt")
    cv.convert_train_to_test(ecpe, os.path.join(d, "test.txt"))
    cv.convert_train_to_test(ecpe, os.path.join(d, "test2.txt"),
                             bow_optimize=True)
    cv.concat_bow_corpus([ecpe, os.path.join(d, "test.txt")],
                         os.path.join(d, "bow.txt"))
    data = {"1": {"class": "finance", "len": 2, "content": [
        " (2,1)\n", "1,null,null,a b\n", "2,sadness,难过,c d\n"]},
        "2": {"class": "home", "content": [
            "(1,1)\n", "1,happiness,开心,e f\n"]}}
    js = os.path.join(d, "new.json")
    with open(js, "w", encoding="utf8") as f:
        json.dump(data, f, ensure_ascii=False)
    cv.json_to_ecpe_split(js, os.path.join(d, "split"))
    cv.merge_json_datasets([js, js], os.path.join(d, "merged.json"))
    return sorted(os.path.relpath(os.path.join(r, n), d)
                  for r, _, names in os.walk(d) for n in names)


def test_converters_byte_equal(tmp_path, capsys):
    files = _conversions(tconvert, str(tmp_path / "t"))
    assert files == _conversions(jconvert, str(tmp_path / "j"))
    assert len(files) >= 12
    for rel in files:
        assert (tmp_path / "t" / rel).read_bytes() == \
            (tmp_path / "j" / rel).read_bytes(), rel
    src = str(tmp_path / "t" / "rFalseFalse.txt")
    assert main(["convert", "train_to_test", "--source", src, "--target",
                 str(tmp_path / "verb.txt")]) == 0
    assert _last_json(capsys) == {"written": str(tmp_path / "verb.txt")}
    assert (tmp_path / "verb.txt").read_bytes() == \
        (tmp_path / "t" / "test.txt").read_bytes()


# --- visualization, event analysis, text helpers ----------------------------

VIS_TEXTS = ["apple banana fruit", "banana pear fruit salad",
             "car engine wheel road", "engine road truck",
             "stock market rally", "bond market yields fall",
             "goal scored late", "striker shot wide goal"] * 2
VIS_LABELS = ["food", "food", "auto", "auto", "fin", "fin", "sport",
              "sport"] * 2


@pytest.mark.parametrize("method", ["pca", "lda", "tsne"])
def test_vis_matches_jax(method, tmp_path):
    emb = tvis.embed_tfidf(VIS_TEXTS)
    np.testing.assert_allclose(emb, jvis.embed_tfidf(VIS_TEXTS), atol=1e-6)
    got = tvis.reduce_2d(emb, method, labels=VIS_LABELS)
    want = jvis.reduce_2d(emb, method, labels=VIS_LABELS)
    assert got.shape == want.shape == (len(VIS_TEXTS), 2)
    np.testing.assert_allclose(got, want, atol=1e-6)
    out = tvis.visualize_domain_shift(VIS_TEXTS, VIS_LABELS,
                                      str(tmp_path / "d.png"), method=method)
    assert os.path.getsize(out) > 1000


def test_vis_verb(tmp_path, capsys):
    files = []
    for i in range(2):
        path = str(tmp_path / f"domain{i}.txt")
        write_ecpe_file(path, synth_docs(i, 6))
        files.append(path)
    out = str(tmp_path / "domains.png")
    assert main(["vis", "--files", *files, "--out", out]) == 0
    assert _last_json(capsys) == {"written": out, "docs": 12}
    assert os.path.getsize(out) > 1000


def test_event_analysis_matches_jax(tmp_path):
    path = str(tmp_path / "docs.txt")
    write_ecpe_file(path, synth_docs(5, 10))
    got = analyze_cause_clauses(parse_ecpe_file(path))
    want = j_events(j_parse(path))
    assert got.clause_count == want.clause_count > 0
    assert got.pos_counts == want.pos_counts
    assert got.leading_pos == want.leading_pos
    assert got.has_verb_rate == want.has_verb_rate


def test_text_helpers_match_jax(tmp_path):
    rng = np.random.default_rng(0)
    lengths = np.asarray([2, 5, 7, 1], np.int64)
    np.testing.assert_array_equal(
        ttext.getmask(torch.from_numpy(lengths), 7).numpy(),
        np.asarray(jtext.getmask(jnp.asarray(lengths), 7)))
    x = rng.normal(size=(4, 1, 7)).astype(np.float32)
    np.testing.assert_allclose(
        ttext.softmax_by_length(torch.from_numpy(x),
                                torch.from_numpy(lengths)).numpy(),
        np.asarray(jtext.softmax_by_length(jnp.asarray(x),
                                           jnp.asarray(lengths))),
        atol=1e-6)
    data = tmp_path / "data.txt"
    data.write_text("1,null,null,天 气 很 好\n2,sadness,null,他 很 难 过\n",
                    encoding="utf8")
    vec = tmp_path / "w2v.txt"
    vec.write_text("3 4\n天 0.1 0.2 0.3 0.4\n很 1 2 3 4\nbad 1\n",
                   encoding="utf8")
    got = ttext.load_w2v(4, str(data), str(vec), seed=3)
    want = jtext.load_w2v(4, str(data), str(vec), seed=3)
    assert got[0] == want[0]
    np.testing.assert_array_equal(got[1], want[1])


# --- MMD permutation test ---------------------------------------------------

@pytest.mark.parametrize("shift", [0.0, 1.0])
def test_mmd_permutation_test_matches_jax(shift):
    rng = np.random.default_rng(4)
    x = rng.normal(size=(24, 8)).astype(np.float32)
    y = (rng.normal(size=(24, 8)) + shift).astype(np.float32)
    n = 2000
    got_mmd, got_p = mmd_permutation_test(torch.from_numpy(x),
                                          torch.from_numpy(y), (0.1, 1.0), n)
    want_mmd, want_p = j_perm_test(jnp.asarray(x), jnp.asarray(y),
                                   (0.1, 1.0), n, jax.random.key(0))
    assert abs(float(got_mmd) - float(want_mmd)) <= \
        1e-6 * max(1.0, abs(float(want_mmd)))
    p = float(want_p)
    sigma = math.sqrt(2 * max(p * (1 - p), 1.0 / n) / n)
    assert abs(float(got_p) - p) <= 3 * sigma, (float(got_p), p)
    if shift:
        assert float(got_p) == p == 0.0
    else:
        assert 0.05 < float(got_p) < 0.95


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_prf_2nd_step_matches_jax(seed):
    """The second-step pair-filter metric on seeded pair ids and keeps, and
    JAX's own hand-checked case."""
    from carel_tpu.train.metrics import prf_2nd_step as j_prf

    from carel_tpu_torch.train.metrics import prf_2nd_step

    rng = np.random.default_rng(seed)
    cands = sorted({int(d * 10000 + e * 100 + c) for d, e, c in
                    rng.integers(1, 9, (40, 3))})
    gold = [p for p in cands if rng.random() < 0.3]
    keep = rng.integers(0, 2, len(cands)).tolist()
    assert prf_2nd_step(gold, cands, keep) == j_prf(gold, cands, keep)
    assert prf_2nd_step([10102], [10102, 10103], [1, 0]) == \
        j_prf([10102], [10102, 10103], [1, 0])
