"""The port's English presets (drl_en, en_newsplit) and local HF checkpoints
against carel_tpu on the CPU, on the synthetic en corpus of
tests/test_torch_data.write_en_corpus, at tiny widths:

- the en BoW vocabulary (sklearn's CountVectorizer in JAX, the port's
  sklearn-free builder) in both bow_optimize modes: equal;
- build_pipeline of each preset, with the corpus-built WordPiece and with
  an HF checkpoint dir (its config.json sizing the encoder, the dir also
  the tokenizer): pairs, arrays, BoW, max_len, bow_dim and the encoder's
  config equal, and the HF weights in init_state equal to JAX's port of
  them. Both pipelines read one tokenizer file, since the WordPiece
  trainer does not repeat its vocabulary (tests/test_torch_tokenizer_en.py);
- one en_newsplit training step (roberta arch, one token type, pad id 1,
  eps 1e-5) from converted JAX params, at the tolerances of
  tests/test_torch_train_step.py;
- stage 1 and the DANN in en with an HF encoder: the port's trainers from
  JAX's init of the other params and the checkpoint's encoder log JAX's
  events and losses (stage 1 rtol 1e-5 a step, the DANN's atol 1e-4 as in
  tests/test_torch_dann.py);
- the CLI verbs (train, infer, stage1, dann) in en and with --hf_encoder,
  on the CPU; an orbax dir raises, naming ROADMAP Queue 3."""

import dataclasses
import functools
import json
import os
import shutil

import jax
import numpy as np
import pytest
import torch

from carel_tpu import pipeline as jpipeline
from carel_tpu.config import PRESETS as JPRESETS
from carel_tpu.config import DataConfig as JDataConfig
from carel_tpu.config import TrainConfig as JTrainConfig
from carel_tpu.data import bow as jbow
from carel_tpu.data.ecpe_format import parse_ecpe_file as j_parse
from carel_tpu.data.tokenizer import WordPieceTokenizer as JWP
from carel_tpu.models import dann as jdann
from carel_tpu.models.encoder import tiny_encoder_config as j_tiny
from carel_tpu.models.stage1 import DocEmotionModel as JDocEmotionModel
from carel_tpu.stage1 import build_doc_arrays as j_build_doc_arrays
from carel_tpu.stage1 import dann_driver as jdriver
from carel_tpu.stage1 import trainer as jtrainer

from carel_tpu_torch import pipeline as tpipeline
from carel_tpu_torch.cli.main import main
from carel_tpu_torch.config import PRESETS, DataConfig, TrainConfig
from carel_tpu_torch.convert import (jax_batch_stats_to_state_dict,
                                     jax_params_to_state_dict)
from carel_tpu_torch.data import bow as tbow
from carel_tpu_torch.data.ecpe_format import parse_ecpe_file
from carel_tpu_torch.data.tokenizer import WordPieceTokenizer as TWP
from carel_tpu_torch.models.encoder import tiny_encoder_config as t_tiny
from carel_tpu_torch.models.hf_port import port_hf_encoder
from carel_tpu_torch.stage1 import build_doc_arrays as t_build_doc_arrays
from carel_tpu_torch.stage1 import dann_driver as tdriver
from carel_tpu_torch.stage1 import trainer as ttrainer

from tests import test_torch_train_step as ts
from tests.test_torch_data import write_en_corpus
from tests.test_torch_hf_port import tiny_hf
from tests.test_torch_tokenizer_en import hf_tokenizer_dir

EN_PRESETS = ("en_newsplit", "drl_en")
# the tiny encoder's widths (tiny_encoder_config), which an HF checkpoint
# used with --encoder tiny under stage1 and dann must have
TINY = dict(hidden=64, layers=2, heads=4, mlp=128, max_pos=160)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("en_corpus"))
    write_en_corpus(root)
    return root


@pytest.fixture(scope="module")
def tok_file(corpus, tmp_path_factory):
    """One WordPiece over the en BoW corpus, trained by JAX's package and
    saved: the cache both packages read."""
    texts = [c.text for d in j_parse(os.path.join(
        corpus, "data/ecpe_and_reccon_all_data_pair_en.txt"))
        for c in d.clauses]
    path = str(tmp_path_factory.mktemp("tok") / "tokenizer_en.json")
    JWP.train_from_corpus(texts).save(path)
    return path


@pytest.fixture(scope="module")
def hf_dir(tok_file, tmp_path_factory):
    """A local HF checkpoint dir at the tiny encoder's widths: a random
    RobertaModel (one token type, eps 1e-5, the tokenizer's [PAD] as its
    pad id) over the WordPiece's vocabulary, with that tokenizer beside
    it."""
    path = str(tmp_path_factory.mktemp("hf") / "roberta_tiny")
    wp = TWP.load(tok_file)
    tiny_hf("roberta", path, vocab=wp.vocab_size, pad_id=wp.pad_id, **TINY)
    hf_tokenizer_dir(wp, path)
    return path


@pytest.fixture(scope="module")
def bert_dir(tok_file, tmp_path_factory):
    """A local HF BertModel dir with the tiny encoder's shape exactly (the
    WordPiece's vocab, 160 positions, two token types): the only kind of
    checkpoint JAX's stage-1 and DANN trainers accept with --encoder tiny,
    since Flax checks every table's shape against the configured
    encoder's."""
    path = str(tmp_path_factory.mktemp("hf") / "bert_tiny")
    tiny_hf("bert", path, vocab=TWP.load(tok_file).vocab_size, **TINY)
    return path


def _caches(tmp_path, tok_file):
    out = []
    for side in ("j", "t"):
        d = tmp_path / f"cache_{side}"
        d.mkdir()
        shutil.copy(tok_file, d / "tokenizer_en.json")
        out.append(str(d))
    return out


@pytest.mark.parametrize("optimize", [False, True])
@pytest.mark.parametrize("bow_file", ["data/all_data_pair_en.txt",
                                      "data/ecpe_and_reccon_all_data_pair_en"
                                      ".txt"])
def test_bow_vocab_en_equals_sklearn_build(corpus, bow_file, optimize):
    path = os.path.join(corpus, bow_file)
    got = tbow.build_bow_vocab_en(path, bow_optimize=optimize)
    want = jbow.build_bow_vocab_en(path, bow_optimize=optimize)
    assert got.words == want.words and got.tokenizer == want.tokenizer == "en"
    assert len(got) > 10 and ("sep" in got.words) == optimize
    text = "She was HAPPY, didn't [SEP] café; the exam!"
    for a, b in zip(got.counts(text), want.counts(text)):
        np.testing.assert_array_equal(a, b)
    assert got.tokenize(text) == want.tokenize(text)


def _pipelines(preset, corpus, caches, hf=""):
    jcfg, tcfg = JPRESETS[preset], PRESETS[preset]
    out = []
    for cfg, build, tiny, cache in (
            (jcfg, jpipeline.build_pipeline, j_tiny, caches[0]),
            (tcfg, tpipeline.build_pipeline, t_tiny, caches[1])):
        data = dataclasses.replace(cfg.data, data_root=corpus,
                                   tokenizer=hf or "auto")
        model = dataclasses.replace(cfg.model, pretrained_encoder=hf)
        cfg = dataclasses.replace(cfg, data=data, model=model)
        out.append(build(cfg, cache_dir=cache, encoder_cfg=tiny()))
    return out


def _assert_same_pipelines(jp, tp):
    assert [dataclasses.asdict(e) for e in tp.train_pairs.examples] == [
        dataclasses.asdict(e) for e in jp.train_pairs.examples]
    assert [dataclasses.asdict(e) for e in tp.test_pairs.examples] == [
        dataclasses.asdict(e) for e in jp.test_pairs.examples]
    assert tp.bow.words == jp.bow.words
    for side in ("train_arrays", "test_arrays"):
        t_arr, j_arr = getattr(tp, side), getattr(jp, side)
        for f in dataclasses.fields(j_arr):
            a, b = getattr(t_arr, f.name), getattr(j_arr, f.name)
            assert a.dtype == b.dtype, (side, f.name)
            np.testing.assert_array_equal(a, b, err_msg=f"{side} {f.name}")
    assert tp.cfg.data.max_len == jp.cfg.data.max_len
    assert tp.cfg.model.bow_dim == jp.cfg.model.bow_dim == len(jp.bow)
    assert dataclasses.asdict(tp.cfg.model.encoder) == dataclasses.asdict(
        jp.cfg.model.encoder)
    assert tp.num_unpred_pairs == jp.num_unpred_pairs


@pytest.mark.parametrize("preset", EN_PRESETS)
def test_pipeline_equals_jax(preset, corpus, tok_file, tmp_path):
    jp, tp = _pipelines(preset, corpus, _caches(tmp_path, tok_file))
    _assert_same_pipelines(jp, tp)
    assert tp.cfg.model.encoder.vocab_size == tp.tokenizer.vocab_size
    # drl_en's BoW (bow_optimize off) holds whole space-stripped clauses,
    # the reference's legacy vocabulary, which a pair's words never hit on
    # this corpus (clauses of 3+ words); en_newsplit's holds the words
    hits = (tp.train_arrays.bow_indices >= 0).any()
    assert hits == (preset == "en_newsplit")
    # en_newsplit pairs are spaced ("a [SEP] b"), drl_en's are not
    spaced = " [SEP] " in tp.train_pairs.pairs[0]
    assert spaced == (preset == "en_newsplit")


def test_pipeline_with_hf_checkpoint_equals_jax(corpus, tok_file, hf_dir,
                                                tmp_path):
    """An HF dir as pretrained_encoder and tokenizer: its config sizes the
    encoder (keeping the configured dtype only), its tokenizer encodes, and
    init_state loads its weights, as JAX's pipeline does."""
    jp, tp = _pipelines("en_newsplit", corpus, _caches(tmp_path, tok_file),
                        hf=hf_dir)
    _assert_same_pipelines(jp, tp)
    enc = tp.cfg.model.encoder
    assert (enc.arch, enc.type_vocab_size, enc.layer_norm_eps,
            enc.attention_impl) == ("roberta", 1, 1e-5, "xla")
    assert type(tp.tokenizer).__name__ == "HFTokenizerAdapter"
    model = tpipeline.init_state(tp.cfg, "cpu").model
    want = port_hf_encoder(hf_dir, enc)
    got = model.encoder.state_dict()
    assert got.keys() == want.keys()
    assert all(torch.equal(got[k], want[k]) for k in want)
    jstate = jpipeline.init_state(jp)
    j_enc = jax_params_to_state_dict(jax.tree_util.tree_map(
        np.asarray, jstate.params["encoder"]))
    assert all(torch.equal(got[k], j_enc[k]) for k in want)


def _en_step_cfgs():
    enc = dict(vocab_size=ts.VOCAB, dropout=0.0, arch="roberta",
               type_vocab_size=1, pad_token_id=1, layer_norm_eps=1e-5)
    out = []
    for presets, tiny, DC, TC, extra in (
            (JPRESETS, j_tiny, JDataConfig, JTrainConfig, dict(donate=False)),
            (PRESETS, t_tiny, DataConfig, TrainConfig, {})):
        base = presets["en_newsplit"]
        out.append(dataclasses.replace(
            base,
            model=dataclasses.replace(base.model, encoder=tiny(**enc),
                                      ec_dim=ts.EC, bow_dim=ts.BOW,
                                      dropout=0.0),
            data=DC(language="en", max_len=ts.L),
            train=TC(batch_size=ts.B, vae_lr=ts.LR, adv_lr=ts.ADV_LR,
                     aprx_lr=ts.APRX_LR, **extra)))
    return out


@pytest.fixture(scope="module")
def en_step():
    return ts.run_both_steps(*_en_step_cfgs(), "mmd")


@pytest.mark.parametrize("check", [
    "test_loss_and_metrics_match", "test_grads_match",
    "test_params_after_step_match",
    "test_frozen_heads_and_disc_club_unchanged"])
def test_en_newsplit_step_matches_jax(en_step, check):
    assert en_step["state"].model.encoder.cfg.arch == "roberta"
    getattr(ts, check)(en_step)


def _en_docs(corpus):
    d = os.path.join(corpus, "domains/Englishnovel_multiple")
    return (parse_ecpe_file(os.path.join(d, "home.txt"))[:8],
            parse_ecpe_file(os.path.join(d, "education.txt"))[:6])


class _Events:
    def __init__(self):
        self.records = []

    def log(self, record):
        self.records.append({k: v for k, v in record.items()
                             if k not in ("time", "path")})


def _non_encoder(state, model):
    """``model``'s state_dict with ``state``'s entries outside the
    encoder."""
    full = model.state_dict()
    full.update({k: v for k, v in state.items()
                 if not k.startswith("encoder.")})
    return full


def test_stage1_with_hf_encoder_matches_jax(corpus, tok_file, bert_dir,
                                            tmp_path, monkeypatch):
    """Stage 1 in en (clauses keep their spaces) from an HF checkpoint: the
    port's trainer, from JAX's init of the other params and the
    checkpoint's encoder, takes the same base and self-training losses
    (rtol 1e-5 a step) and logs the same events and F1s."""
    train_docs, test_docs = _en_docs(corpus)
    wp_j, wp_t = JWP.load(tok_file), TWP.load(tok_file)
    D, S = 6, 12
    arrs = {"j": [j_build_doc_arrays(d, wp_j, D, S, False)
                  for d in (train_docs, test_docs)],
            "t": [t_build_doc_arrays(d, wp_t, D, S, False)
                  for d in (train_docs, test_docs)]}
    kw = dict(n_hidden=8, training_epoch=2, self_epoch=1, threshold=0.0,
              batch_size=3, learning_rate=1e-5, keep_softmax=1.0,
              language="en")
    enc_kw = dict(vocab_size=wp_t.vocab_size, dropout=0.0)
    jcfg = jtrainer.Stage1Config(save_dir=str(tmp_path / "j"), **kw)
    tcfg = ttrainer.Stage1Config(save_dir=str(tmp_path / "t"), **kw)

    jlosses = []
    make = jtrainer.make_stage1_step

    def recording(*a, **k):
        step = make(*a, **k)

        def run(*args):
            out = step(*args)
            jlosses.append(float(out[2]))
            return out
        return run

    monkeypatch.setattr(jtrainer, "make_stage1_step", recording)
    jmodel = JDocEmotionModel(j_tiny(**enc_kw), 8, 7, 1.0, "bilstm")
    p_rng, d_rng, _ = jax.random.split(jax.random.key(jcfg.seed), 3)
    b = jtrainer._batch_dict(arrs["j"][0], np.arange(2))
    init = jax_params_to_state_dict(jax.tree_util.tree_map(
        np.asarray, jmodel.init({"params": p_rng, "dropout": d_rng},
                                b["x_ids"], b["x_masks"], b["x_types"],
                                deterministic=False)["params"]))
    jlog, tlog = _Events(), _Events()
    _, jbest, _ = jtrainer.train_stage1(jcfg, j_tiny(**enc_kw), *arrs["j"],
                                        wp_j, jlog, encoder_ckpt=bert_dir)
    model = ttrainer.build_stage1_model(tcfg, t_tiny(**enc_kw), "cpu",
                                        encoder_ckpt=bert_dir)
    assert model.encoder.cfg == t_tiny(**enc_kw)
    model.load_state_dict(_non_encoder(init, model))
    tlosses = []
    _, tbest, _ = ttrainer.fit_stage1(tcfg, model, *arrs["t"], wp_t, tlog,
                                      losses=tlosses)
    assert len(tlosses) == len(jlosses) > 4
    np.testing.assert_allclose([float(x) for x in tlosses], jlosses,
                               rtol=1e-5)
    assert tlog.records == jlog.records and tbest == jbest
    assert any(r["event"] == "stage1_self_eval" for r in tlog.records)


def test_dann_with_hf_encoder_matches_jax(corpus, tok_file, bert_dir,
                                          monkeypatch):
    """The clause-level DANN over en domain files from an HF checkpoint:
    the port's driver, from JAX's init of the other params and batch
    statistics and the checkpoint's encoder, logs JAX's events, losses
    within 1e-4."""
    wp_j, wp_t = JWP.load(tok_file), TWP.load(tok_file)
    cfg_kw = dict(source_domain="home", target_domain="education",
                  doc_dir="domains/Englishnovel_multiple", epochs=1,
                  self_iteration=1, self_epochs=1, batch_size=8,
                  learning_rate=1e-5, max_len=24)
    kw = dict(vocab_size=wp_t.vocab_size, dropout=0.0)
    monkeypatch.setattr(jdriver, "ClauseEmotionDANN", functools.partial(
        jdann.ClauseEmotionDANN, dropout=0.0))
    jcfg, tcfg = jdriver.DannConfig(**cfg_kw), tdriver.DannConfig(**cfg_kw)
    jlog, tlog = _Events(), _Events()
    jres = jdriver.run_dann(jcfg, j_tiny(**kw), wp_j, corpus, jlog,
                            encoder_ckpt=bert_dir, max_clauses=40)

    src_path = os.path.join(corpus, jcfg.doc_dir, "home.txt")
    src = jdriver._encode(wp_j, *[a[:40] for a in jdriver.read_clause_data(
        src_path)], jcfg.max_len)
    params, stats = jdann.init_dann(jdriver.ClauseEmotionDANN(
        j_tiny(**kw), domain_weight=jcfg.domain_weight), src, jcfg.seed)
    initial = {**jax_params_to_state_dict(
        jax.tree_util.tree_map(np.asarray, params)),
        **jax_batch_stats_to_state_dict(stats)}
    model = tdriver.build_dann_model(tcfg, t_tiny(**kw), "cpu", dropout=0.0,
                                     encoder_ckpt=bert_dir)
    model.load_state_dict(_non_encoder(initial, model))
    source, target = (tdriver.encode_clauses(wp_t, sent, y, tcfg.max_len)
                      for sent, y in tdriver.read_domains(tcfg, corpus, 40))
    tres = tdriver.fit_dann(tcfg, model, source, target, tlog)
    names = [r["event"] for r in jlog.records]
    assert [r["event"] for r in tlog.records] == names
    assert "dann_selftrain" in names
    for j, t in zip(jlog.records, tlog.records):
        for k, v in j.items():
            if k in ("emo_loss", "dom_loss"):
                assert t[k] == pytest.approx(v, abs=1e-4), (k, j, t)
            else:
                assert t[k] == v, (k, j, t)
    assert tres["base"] == jres["base"] and tres["best"] == jres["best"]


def test_jax_stage1_rejects_a_roberta_checkpoint(corpus, tok_file, hf_dir,
                                                tmp_path):
    """JAX's stage-1 trainer puts the checkpoint's tables into a model
    built from the configured encoder, and Flax's shape check refuses a
    RoBERTa checkpoint's one-row token-type table (as it would roberta-base's
    514 positions or 50,265 words against the corpus tokenizer's vocab).
    The port builds the encoder with the checkpoint's table sizes and
    trains. Recorded in ROADMAP Queue 3 (JAX side)."""
    train_docs, test_docs = _en_docs(corpus)
    wp_j = JWP.load(tok_file)
    arrs = [j_build_doc_arrays(d, wp_j, 6, 12, False)
            for d in (train_docs, test_docs)]
    kw = dict(n_hidden=8, training_epoch=1, self_epoch=1, batch_size=3,
              language="en")
    enc_kw = dict(vocab_size=wp_j.vocab_size, dropout=0.0)
    with pytest.raises(Exception, match="token_type_embeddings"):
        jtrainer.train_stage1(jtrainer.Stage1Config(
            save_dir=str(tmp_path / "j"), **kw), j_tiny(**enc_kw), *arrs,
            wp_j, _Events(), encoder_ckpt=hf_dir)
    model = ttrainer.build_stage1_model(ttrainer.Stage1Config(**kw),
                                        t_tiny(**enc_kw), "cpu",
                                        encoder_ckpt=hf_dir)
    assert model.encoder.cfg.type_vocab_size == 1
    assert model.encoder.cfg.arch == "bert"  # the configured arch is kept


def _last_json(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def _config_event(logs, preset):
    events = [json.loads(line) for log in sorted(logs.glob(f"{preset}_*"))
              for line in log.read_text().splitlines()]
    return [e for e in events if e["event"] == "config"]


@pytest.mark.parametrize("preset", EN_PRESETS)
def test_cli_en_preset_trains_self_trains_and_serves(preset, corpus, capsys,
                                                     tmp_path):
    common = ["--preset", preset, "--data_root", corpus, "--encoder", "tiny",
              "--device", "cpu", "--cache_dir", str(tmp_path / "cache"),
              "--checkpoint_dir", str(tmp_path / "ckpt"), "--log_dir",
              str(tmp_path / "logs")]
    assert main(["train", *common, "--epochs", "1", "--self_iteration", "1",
                 "--self_epochs", "1", "--batch_size", "8"]) == 0
    out = _last_json(capsys)
    assert 0.0 <= out["base_f1"] <= 1.0 and 0.0 <= out["best_f1"] <= 1.0
    assert os.path.exists(tmp_path / "cache" / "tokenizer_en.json")
    events = [json.loads(line) for log in (tmp_path / "logs").glob("*")
              for line in log.read_text().splitlines()]
    assert any(e["event"] == "selftrain_iter" for e in events)
    assert main(["infer", *common, "--model_id", out["model_id"]]) == 0
    res = _last_json(capsys)
    assert 0.0 <= res["f1"] <= 1.0 and res["pairs_per_sec"] > 0


def test_cli_hf_encoder_train_and_infer(corpus, hf_dir, capsys, tmp_path):
    """--hf_encoder on train and infer: the checkpoint sizes the encoder
    and supplies the tokenizer (the config event's vocab is the
    checkpoint's, and no WordPiece is trained); infer serves the
    checkpoint's encoder (the random tiny checkpoint scores F1 0, so train
    saves no best to load); an orbax dir raises, naming Queue 3."""
    common = ["--preset", "en_newsplit", "--data_root", corpus,
              "--encoder", "tiny", "--device", "cpu", "--hf_encoder",
              hf_dir, "--cache_dir", str(tmp_path / "cache"),
              "--checkpoint_dir", str(tmp_path / "ckpt"), "--log_dir",
              str(tmp_path / "logs")]
    assert main(["train", *common, "--epochs", "1", "--self_iteration", "1",
                 "--self_epochs", "1", "--batch_size", "8"]) == 0
    out = _last_json(capsys)
    with open(os.path.join(hf_dir, "config.json")) as f:
        vocab = json.load(f)["vocab_size"]
    (config,) = _config_event(tmp_path / "logs", "en_newsplit")
    assert config["vocab"] == vocab
    # the HF tokenizer was used: no WordPiece was trained into the cache
    assert not os.path.exists(tmp_path / "cache" / "tokenizer_en.json")
    assert 0.0 <= out["best_f1"] <= 1.0
    assert main(["infer", *common]) == 0
    assert _last_json(capsys)["pairs_per_sec"] > 0
    orbax = tmp_path / "orbax"
    orbax.mkdir()
    with pytest.raises(NotImplementedError, match="Queue 3"):
        main(["train", "--preset", "en_newsplit", "--data_root", corpus,
              "--encoder", "tiny", "--device", "cpu", "--hf_encoder",
              str(orbax), "--cache_dir", str(tmp_path / "cache"),
              "--epochs", "1", "--self_iteration", "0"])


@pytest.mark.parametrize("hf", [False, True], ids=["corpus_wordpiece",
                                                   "hf_encoder"])
def test_cli_stage1_and_dann_in_en(hf, corpus, hf_dir, capsys, tmp_path):
    """stage1 --language en reads domains/Englishnovel_multiple and dann
    --language en the --doc_dir given, each with the corpus WordPiece, with
    and without an HF checkpoint's encoder."""
    common = ["--data_root", corpus, "--encoder", "tiny", "--device", "cpu",
              "--language", "en", "--cache_dir", str(tmp_path / "cache"),
              "--log_dir", str(tmp_path / "logs"), "--max_test_docs", "6"]
    if hf:
        common += ["--hf_encoder", hf_dir]
    assert main(["stage1", *common, "--epochs", "1", "--batch_size", "4",
                 "--max_train_docs", "8",
                 "--save_dir", str(tmp_path / "pairs")]) == 0
    out = _last_json(capsys)
    assert 0.0 <= out["best_f1"] <= 1.0
    assert main(["dann", *common, "--doc_dir",
                 "domains/Englishnovel_multiple", "--source_domain", "home",
                 "--target_domain", "education", "--epochs", "1",
                 "--self_iteration", "1", "--self_epochs", "1",
                 "--batch_size", "8", "--max_len", "24"]) == 0
    out = _last_json(capsys)
    assert set(out) == {"base", "best"} and 0.0 <= out["best"]["f1"] <= 1.0
    assert os.path.exists(tmp_path / "cache" / "tokenizer_en.json")
