"""The port's stage 1 (carel_tpu_torch.stage1, models/stage1.py) against
carel_tpu's on the CPU in float32, at tiny widths (tiny_encoder_config with
dropout 0, keep_softmax 1, n_hidden 8), from the same weights
(carel_tpu_torch.convert) and the same numpy-seeded inputs.

Tolerances: probabilities and the L2 term rtol 1e-5 (both sides compute in
fp32, the sums in another order); gradients atol 1e-6 + rtol 1e-4; after an
update, params within 2 x lr of JAX's everywhere and within 1e-2 x lr where
|g| is well above Adam's eps (where |g| is near eps the update's size
itself is within noise). Arrays, pair files, logged events and F1s must be
equal. The last test chains the port's stage1 verb into its train verb
through the pair file, as tests/test_two_stage_chain.py does for JAX."""

import dataclasses
import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from carel_tpu.data.ecpe_format import parse_ecpe_file as j_parse
from carel_tpu.data.pairs import build_pairs as j_build_pairs
from carel_tpu.data.tokenizer import ZhCharTokenizer as JTok
from carel_tpu.models.encoder import tiny_encoder_config as j_tiny
from carel_tpu.models.stage1 import DocEmotionModel as JDocEmotionModel
from carel_tpu.stage1 import build_doc_arrays as j_build_doc_arrays
from carel_tpu.stage1 import write_pair_data as j_write_pair_data
from carel_tpu.stage1 import trainer as jtrainer
from carel_tpu.train.metrics import micro_prf as j_micro_prf

import carel_tpu_torch.data as tdata
from carel_tpu_torch.cli.main import main
from carel_tpu_torch.convert import jax_params_to_state_dict
from carel_tpu_torch.data.pairs import build_pairs as t_build_pairs
from carel_tpu_torch.data.tokenizer import ZhCharTokenizer as TTok
from carel_tpu_torch.models.encoder import tiny_encoder_config as t_tiny
from carel_tpu_torch.models.stage1 import DocEmotionModel, init_stage1_
from carel_tpu_torch.stage1 import build_doc_arrays as t_build_doc_arrays
from carel_tpu_torch.stage1 import trainer as ttrainer
from carel_tpu_torch.stage1 import write_pair_data as t_write_pair_data
from carel_tpu_torch.train.metrics import micro_prf as t_micro_prf

from tests.test_torch_data import synth_docs

HIDDEN = 8
D, S = 6, 10  # clauses a document, tokens a clause


def _docs(seed=0, n=6):
    """Synthetic zh documents, with cause codes -1 and 7 on two clauses
    (no target, and the null class)."""
    docs = synth_docs(seed, n)
    docs[0].clauses[0].cause = -1
    docs[1].clauses[1].cause = 7
    return docs


def _tokenizers(docs):
    texts = [c.text for d in docs for c in d.clauses]
    return JTok.from_corpus(texts), TTok.from_corpus(texts)


def _both_arrays(docs, max_doc_len=D, max_sen_len=S):
    jtok, ttok = _tokenizers(docs)
    return (j_build_doc_arrays(docs, jtok, max_doc_len, max_sen_len),
            t_build_doc_arrays(docs, ttok, max_doc_len, max_sen_len),
            jtok, ttok)


def test_decode_matches_jax():
    jtok, ttok = _tokenizers(_docs())
    ids = list(range(ttok.vocab_size)) + [0, 2, 3, 1, ttok.vocab_size + 5]
    assert ttok.vocab_size % 128 == 0 and ttok.vocab[-1].startswith("[unused")
    for skip in (True, False):
        assert ttok.decode(ids, skip) == jtok.decode(ids, skip)
    assert ttok.decode([2, 5, 6, 3, 0]) == " ".join(ttok.vocab[5:7])


def test_doc_arrays_match_jax():
    # 7 documents cut to 6 clauses: longer documents are truncated
    ja, ta, _, _ = _both_arrays(_docs(n=7))
    for f in dataclasses.fields(ja):
        want, got = getattr(ja, f.name), getattr(ta, f.name)
        if isinstance(want, np.ndarray):
            assert got.dtype == want.dtype and np.array_equal(got, want), \
                f.name
        else:
            assert got == want, f.name
    assert ta.y_cause[0, 0].sum() == 0 and ta.y_cause[1, 1, 6] == 1.0
    sub, both = ta.take([2, 0]), ta.concat(ta.take([1]))
    assert sub.doc_ids == [ta.doc_ids[2], ta.doc_ids[0]]
    assert len(both) == len(ta) + 1 and both.doc_ids[-1] == ta.doc_ids[1]


def test_pair_file_is_byte_identical(tmp_path):
    ja, ta, jtok, ttok = _both_arrays(_docs(n=7))
    pred = np.random.default_rng(3).integers(0, 7, (len(ta), D))
    j_write_pair_data(str(tmp_path / "j" / "education.txt"), ja, pred, jtok)
    t_write_pair_data(str(tmp_path / "t" / "education.txt"), ta, pred, ttok)
    want = (tmp_path / "j" / "education.txt").read_bytes()
    assert (tmp_path / "t" / "education.txt").read_bytes() == want
    assert len(want) > 0


@pytest.mark.parametrize("case", ["no_null", "with_null", "empty"])
def test_micro_prf_matches_jax(case):
    rng = np.random.default_rng(2)
    hi = 6 if case == "no_null" else 7
    pred = rng.integers(0, hi, (5, 9))
    true = rng.integers(0, hi, (5, 9))
    doc_len = rng.integers(1, 10, 5)
    if case == "empty":
        pred[:] = 6
        true[:] = 6
    got = t_micro_prf(pred, true, doc_len)
    assert got == j_micro_prf(pred, true, doc_len)
    if case == "with_null":
        assert got[0] != got[1]  # class 6 left out: P and R differ
    if case == "no_null":
        assert got[0] == got[1] == got[2]


def _models(mixer, vocab):
    jmodel = JDocEmotionModel(j_tiny(vocab_size=vocab, dropout=0.0), HIDDEN,
                              7, 1.0, mixer)
    tmodel = DocEmotionModel(t_tiny(vocab_size=vocab, dropout=0.0), HIDDEN,
                             7, 1.0, mixer)
    return jmodel, tmodel


def _init_pair(mixer, arr, seed=0):
    """The JAX model's params from model.init and the port's model loaded
    with them."""
    jmodel, tmodel = _models(mixer, 256)
    b = jtrainer._batch_dict(arr, np.arange(2))
    params = jmodel.init({"params": jax.random.key(seed),
                          "dropout": jax.random.key(seed + 1)},
                         b["x_ids"], b["x_masks"], b["x_types"],
                         deterministic=False)["params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    tmodel.load_state_dict(jax_params_to_state_dict(params))
    return jmodel, params, tmodel


def _batch(arr, idx):
    return jtrainer._batch_dict(arr, np.asarray(idx)), ttrainer.to_device(
        arr, np.asarray(idx), torch.device("cpu"))


def _flat_state(params):
    return {k: v.numpy() for k, v in jax_params_to_state_dict(
        jax.tree_util.tree_map(np.asarray, params)).items()}


@pytest.mark.parametrize("mixer", ["bilstm", "transformer"])
def test_doc_emotion_model_matches_jax(mixer):
    ja, ta, _, _ = _both_arrays(_docs(n=4))
    jmodel, params, tmodel = _init_pair(mixer, ja)
    jb, tb = _batch(ja, [0, 1, 2, 3])
    jpred, jreg = jmodel.apply({"params": params}, jb["x_ids"],
                               jb["x_masks"], jb["x_types"])
    with torch.no_grad():
        tpred, treg = tmodel(tb["x_ids"], tb["x_masks"], tb["x_types"])
    assert tpred.shape == (4, D, 7)
    np.testing.assert_allclose(tpred.numpy(), np.asarray(jpred), rtol=1e-5,
                               atol=0)
    np.testing.assert_allclose(float(treg), float(jreg), rtol=1e-5)

    # one step's gradients of the trainer's loss
    cfg = ttrainer.Stage1Config(n_hidden=HIDDEN, clause_mixer=mixer)

    def j_loss(p):
        pred, reg = jmodel.apply({"params": p}, jb["x_ids"], jb["x_masks"],
                                 jb["x_types"])
        valid = jnp.maximum(jnp.sum(jb["doc_len"]), 1.0)
        ce = -jnp.sum(jb["y_emotion"] * jnp.log(pred + 1e-12)) / valid
        return ce * cfg.emotion_weight + reg * cfg.l2_reg

    jloss, jgrads = jax.value_and_grad(j_loss)(params)
    tmodel.train()
    tloss = ttrainer.stage1_loss(cfg, tmodel, tb)
    tloss.backward()
    np.testing.assert_allclose(float(tloss.detach()), float(jloss), rtol=1e-5)
    want = _flat_state(jgrads)
    for name, p in tmodel.named_parameters():
        if p.requires_grad:
            np.testing.assert_allclose(p.grad.numpy(), want[name],
                                       atol=1e-6, rtol=1e-4, err_msg=name)
        else:
            assert p.grad is None and not p.any()  # the LSTM's bias_ih


def test_bilstm_cells_map_to_directions():
    """OptimizedLSTMCell_0 runs forwards, _1 backwards: a change to the
    last clause moves the forward half of clause 0's output not at all."""
    ja, _, _, _ = _both_arrays(_docs(n=2))
    _, _, tmodel = _init_pair("bilstm", ja)
    x = torch.randn(1, D, 2 * HIDDEN,
                    generator=torch.Generator().manual_seed(0))
    y = x.clone()
    y[0, -1] += 1.0
    with torch.no_grad():
        ox, oy = tmodel.mixer(x), tmodel.mixer(y)
    assert torch.equal(ox[0, 0, :HIDDEN], oy[0, 0, :HIDDEN])
    assert not torch.equal(ox[0, 0, HIDDEN:], oy[0, 0, HIDDEN:])


def _assert_update_close(t_params, j_params, j_grads, lr):
    want, grads = _flat_state(j_params), _flat_state(j_grads)
    for name, p in t_params.items():
        err = np.abs(p.detach().numpy() - want[name])
        assert err.max() <= 2 * lr + 1e-6, name
        clear = np.abs(grads[name]) > 1e-5  # well above eps = 1e-8
        assert np.all(err[clear] <= 1e-2 * lr + 1e-7), name


@pytest.mark.parametrize("fresh", [True, False])
def test_stage1_step_matches_jax(fresh):
    """One fresh-Adam step, and two carried-Adam steps (the second reads the
    carried moments), from the same params and batches."""
    ja, ta, _, _ = _both_arrays(_docs(n=4))
    lr = 1e-3
    cfg_kw = dict(n_hidden=HIDDEN, fresh_adam=fresh, learning_rate=lr)
    jcfg, tcfg = jtrainer.Stage1Config(**cfg_kw), ttrainer.Stage1Config(
        **cfg_kw)
    jmodel, params, tmodel = _init_pair("bilstm", ja)
    tx = None if fresh else optax.adam(lr, eps=1e-8)
    jstep = jtrainer.make_stage1_step(jcfg, jmodel, tx)
    opt = None if fresh else torch.optim.Adam(
        [p for p in tmodel.parameters() if p.requires_grad], lr=lr, eps=1e-8)
    tstep = ttrainer.make_stage1_step(tcfg, tmodel, opt)
    opt_state = None if fresh else tx.init(params)
    for idx in ([0, 1], [2, 3])[: 1 if fresh else 2]:
        jb, tb = _batch(ja, idx)
        last = params
        params, opt_state, jloss = jstep(params, opt_state, jb,
                                         jax.random.key(0))
        tloss = tstep(tb)
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)

    # the gradients of the last step, to tell where |g| is clear of eps

    def j_loss(p):
        pred, reg = jmodel.apply({"params": p}, jb["x_ids"], jb["x_masks"],
                                 jb["x_types"])
        valid = jnp.maximum(jnp.sum(jb["doc_len"]), 1.0)
        return (-jnp.sum(jb["y_emotion"] * jnp.log(pred + 1e-12)) / valid
                + reg * jcfg.l2_reg)

    _assert_update_close(dict(tmodel.named_parameters()), params,
                         jax.grad(j_loss)(last), lr)


def test_fresh_adam_update_is_lr_times_sign():
    p = torch.zeros(4, requires_grad=True)
    p.grad = torch.tensor([2.0, -3.0, 0.0, 1e-9])
    ttrainer.fresh_adam_update_([p], 0.5)
    want = (-0.5 * p.grad) / (p.grad.abs() + 1e-8)
    assert torch.equal(p.detach(), want)


class _Events:
    def __init__(self):
        self.records = []

    def log(self, record):
        self.records.append({k: v for k, v in record.items() if k != "time"})


def test_train_stage1_matches_jax(tmp_path):
    """Two epochs plus self-training (threshold 0, so the pseudo set grows
    once and the loop then stops): the same logged events, F1s and pair
    file, and the best snapshot is not the live params."""
    docs = synth_docs(5, 10)
    test_docs = synth_docs(6, 6)
    jtok, ttok = _tokenizers(docs + test_docs)
    arrs = {}
    for side, tok, build in (("j", jtok, j_build_doc_arrays),
                             ("t", ttok, t_build_doc_arrays)):
        arrs[side] = (build(docs, tok, D, S), build(test_docs, tok, D, S))
    kw = dict(n_hidden=HIDDEN, training_epoch=2, self_epoch=1, threshold=0.0,
              batch_size=3, learning_rate=1e-5, keep_softmax=1.0)
    enc_kw = dict(vocab_size=ttok.vocab_size, dropout=0.0)
    jcfg = jtrainer.Stage1Config(save_dir=str(tmp_path / "j"), **kw)
    tcfg = ttrainer.Stage1Config(save_dir=str(tmp_path / "t"), **kw)

    # the JAX trainer's own init, copied into the port
    jmodel = JDocEmotionModel(j_tiny(**enc_kw), HIDDEN, 7, 1.0, "bilstm")
    p_rng, d_rng, _ = jax.random.split(jax.random.key(jcfg.seed), 3)
    b = jtrainer._batch_dict(arrs["j"][0], np.arange(2))
    init = jmodel.init({"params": p_rng, "dropout": d_rng}, b["x_ids"],
                       b["x_masks"], b["x_types"],
                       deterministic=False)["params"]
    initial = jax_params_to_state_dict(jax.tree_util.tree_map(np.asarray,
                                                              init))

    jlog, tlog = _Events(), _Events()
    _, jbest, jfile = jtrainer.train_stage1(jcfg, j_tiny(**enc_kw),
                                            *arrs["j"], jtok, jlog)
    model = ttrainer.build_stage1_model(tcfg, t_tiny(**enc_kw), "cpu")
    model.load_state_dict(initial)
    tbest_state, tbest, tfile = ttrainer.fit_stage1(
        tcfg, model, *arrs["t"], ttok, tlog)
    strip = [{k: v for k, v in r.items() if k != "path"}
             for r in jlog.records]
    assert [{k: v for k, v in r.items() if k != "path"}
            for r in tlog.records] == strip
    assert any(r["event"] == "stage1_self_eval" for r in strip)
    assert tbest == jbest
    assert jfile is not None and os.path.basename(tfile) == \
        os.path.basename(jfile)
    with open(tfile, "rb") as f, open(jfile, "rb") as g:
        assert f.read() == g.read()
    # the returned best is a copy: a later step does not reach it
    kept = {k: v.clone() for k, v in tbest_state.items()}
    step = ttrainer.make_stage1_step(tcfg, model)
    step(ttrainer.to_device(arrs["t"][0], np.arange(3), torch.device("cpu")))
    assert all(torch.equal(kept[k], v) for k, v in tbest_state.items())
    assert not all(torch.equal(kept[k], v)
                   for k, v in model.state_dict().items())


def test_stage1_init_follows_flax_distributions():
    model = DocEmotionModel(t_tiny(vocab_size=128), 100)
    init_stage1_(model, torch.Generator().manual_seed(0))
    lstm = model.mixer
    w_hh = lstm.weight_hh_l0[:100]
    torch.testing.assert_close(w_hh @ w_hh.T, torch.eye(100), atol=1e-5,
                               rtol=0)
    assert float(lstm.weight_ih_l0.detach().std()) == pytest.approx(
        (1 / 200) ** 0.5, rel=0.05)
    assert not lstm.bias_ih_l0.any() and not lstm.bias_hh_l0_reverse.any()
    assert not lstm.bias_ih_l0.requires_grad


def _stage1_corpus(root):
    """zh newsplit documents: home (train) and education (test, gold
    emotions) for stage 1, and the BoW file the flagship reads."""
    home, education = synth_docs(11, 12), synth_docs(12, 8)
    for rel, docs in (("data/ECPE_new_dataset/home.txt", home),
                      ("data/ECPE_new_dataset/education.txt", education),
                      ("data/all_data_pair_zh.txt", home + education)):
        os.makedirs(os.path.dirname(os.path.join(root, rel)), exist_ok=True)
        tdata.write_ecpe_file(os.path.join(root, rel), docs)


def test_stage1_verb_feeds_the_flagship(tmp_path, capsys, monkeypatch):
    """The stage1 verb (tiny encoder, CPU) writes the pair file, byte for
    byte what carel_tpu's writer makes from the same predictions; the
    flagship's train verb then tests on it through predicted_emotion, with
    the forced misses JAX's reader counts. The random tiny model is never
    confident, so the confidence threshold is set to 0 for the run (the
    verb has no flag for it, as in JAX)."""
    root = tmp_path / "corpus"
    _stage1_corpus(str(root))
    pair_dir = root / "pair_data" / "predicted_emotion" / "source_home"
    monkeypatch.setattr(ttrainer, "Stage1Config", functools.partial(
        ttrainer.Stage1Config, threshold=0.0, self_epoch=1))
    common = ["--data_root", str(root), "--encoder", "tiny", "--device",
              "cpu", "--cache_dir", str(tmp_path / "cache"), "--log_dir",
              str(tmp_path / "logs")]
    assert main(["stage1", *common, "--epochs", "1", "--batch_size", "4",
                 "--save_dir", str(pair_dir)]) == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    pair_file = str(pair_dir / "education.txt")
    assert summary["pair_file"] == pair_file and 0 <= summary["best_f1"] <= 1

    # JAX's writer from the predictions in the file
    test_docs = j_parse(str(root / "data/ECPE_new_dataset/education.txt"))
    train_docs = j_parse(str(root / "data/ECPE_new_dataset/home.txt"))
    jtok = JTok.from_corpus([c.text for d in train_docs + test_docs
                             for c in d.clauses])
    arr = j_build_doc_arrays(test_docs, jtok)
    written = j_parse(pair_file)
    pred = np.full((len(arr), 75), 6)
    for i, doc in enumerate(written):
        for c in doc.clauses:
            pred[i, c.sen_id - 1] = c.emotion
    j_write_pair_data(str(tmp_path / "j.txt"), arr, pred, jtok)
    assert (tmp_path / "j.txt").read_bytes() == open(pair_file, "rb").read()

    # the flagship's test reader: the port's and JAX's agree
    want = j_build_pairs(j_parse(pair_file), test=True)
    got = t_build_pairs(tdata.parse_ecpe_file(pair_file), test=True)
    assert got.num_unpred_emotions == want.num_unpred_emotions
    assert len(got.examples) == len(want.examples)
    assert main(["train", "--preset", "ec_mmd_final_mul_newsplit_emnlp",
                 *common, "--epochs", "1", "--self_iteration", "0",
                 "--batch_size", "8",
                 "--checkpoint_dir", str(tmp_path / "ckpt")]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert 0.0 <= out["best_f1"] <= 1.0
    config = [json.loads(line) for log in (tmp_path / "logs").glob(
        "ec_mmd*.jsonl") for line in log.read_text().splitlines()][0]
    assert config["num_unpred"] == want.num_unpred_emotions
    assert config["test_pairs"] == len(want.examples)


def test_stage1_verb_raises_for_what_is_not_ported(tmp_path):
    """--language en and an HF --hf_encoder run since the en slice
    (tests/test_torch_en.py); an encoder dir with neither config.json nor
    encoder.pt, an orbax checkpoint of carel_tpu.pretrain, raises: the port
    reads neither orbax nor jax (ROADMAP Queue 3)."""
    _stage1_corpus(str(tmp_path))
    orbax = tmp_path / "orbax"
    orbax.mkdir()
    args = ["stage1", "--data_root", str(tmp_path), "--device", "cpu",
            "--encoder", "tiny", "--cache_dir", str(tmp_path / "cache"),
            "--log_dir", str(tmp_path / "logs")]
    with pytest.raises(NotImplementedError, match="Queue 3"):
        main(args + ["--hf_encoder", str(orbax)])
