"""The port's embedder (carel_tpu_torch/embeddings.py), its encoder dir
(pretrain/mlm.py) and the embed verb against carel_tpu/embeddings.py, on the
CPU at tiny widths (tiny_encoder_config, dropout 0, fp32):

- batch_all_triplet_loss: value within rtol 1e-6 and gradient within
  1e-6 normwise of jax.grad's, for random labels, a batch with a single
  label (loss 0, gradient 0) and integer points whose distances tie,
  among them a triplet on the hinge (d(a, n) - d(a, p) = margin exactly),
  where both split the gradient of max in half;
- EncoderEmbedder with normalize off and on: within 1e-5 of JAX's;
- train_domain_embedder for one and for two epochs from JAX's init: every
  entry within Adam's 2 lr a step, and the parameters' moves (from the
  init) within 1e-3 normwise of JAX's, the attention key biases left out of
  the norm (their gradient is 0 in exact arithmetic:
  tests/test_torch_adapters.py says why);
- load_domain_docs, load_clause_keywords and the .npz round trip equal to
  JAX's;
- fewer texts than one batch: the port raises a ValueError naming both
  counts; JAX fails on its unbound loss (ROADMAP Queue 3);
- the embed verb on the CPU over synthetic domain files writes an encoder
  dir that train --hf_encoder loads bit-exact, and trains from.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from carel_tpu.data.tokenizer import ZhCharTokenizer as JZh
from carel_tpu.embeddings import EmbedderTrainConfig as JEmbCfg
from carel_tpu.embeddings import EncoderEmbedder as JEmbedder
from carel_tpu.embeddings import batch_all_triplet_loss as j_triplet
from carel_tpu.embeddings import load_clause_keywords as j_keywords
from carel_tpu.embeddings import load_domain_docs as j_domain_docs
from carel_tpu.embeddings import load_embeddings as j_load_emb
from carel_tpu.embeddings import save_embeddings as j_save_emb
from carel_tpu.embeddings import train_domain_embedder as j_train
from carel_tpu.models.encoder import TransformerEncoder as JEncoder
from carel_tpu.models.encoder import tiny_encoder_config as j_tiny

from carel_tpu_torch.cli.main import main
from carel_tpu_torch.convert import jax_params_to_state_dict
from carel_tpu_torch.data.tokenizer import ZhCharTokenizer
from carel_tpu_torch.embeddings import (EmbedderTrainConfig, EncoderEmbedder,
                                        batch_all_triplet_loss,
                                        load_clause_keywords,
                                        load_domain_docs, load_embeddings,
                                        save_embeddings,
                                        train_domain_embedder)
from carel_tpu_torch.models.encoder import tiny_encoder_config
from carel_tpu_torch.pretrain import load_encoder, save_encoder

from tests.test_torch_adapters import _key_bias_entries
from tests.test_torch_data import synth_docs, write_newsplit_corpus


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _triplet_both(emb: np.ndarray, labels: np.ndarray, margin: float):
    """(port value, port grad, JAX value, JAX grad) of the loss."""
    x = torch.tensor(emb, requires_grad=True)
    got = batch_all_triplet_loss(x, torch.tensor(labels), margin)
    (g,) = torch.autograd.grad(got, x)
    want, jg = jax.value_and_grad(
        lambda e: j_triplet(e, jnp.asarray(labels), margin))(
        jnp.asarray(emb))
    return float(got.detach()), g.numpy(), float(want), np.asarray(jg)


def _close(got_v, got_g, want_v, want_g):
    np.testing.assert_allclose(got_v, want_v, rtol=1e-6, atol=0)
    scale = max(float(np.linalg.norm(want_g)), 1e-30)
    assert float(np.linalg.norm(got_g - want_g)) <= 1e-6 * scale or \
        float(np.abs(got_g - want_g).max()) == 0.0


@pytest.mark.parametrize("seed", [0, 1])
def test_triplet_loss_random_labels_matches_jax(seed):
    rng = np.random.default_rng(seed)
    emb = rng.normal(size=(12, 8)).astype(np.float32)
    labels = rng.integers(0, 3, 12).astype(np.int32)
    got_v, got_g, want_v, want_g = _triplet_both(emb, labels, 5.0)
    assert want_v > 0
    _close(got_v, got_g, want_v, want_g)


def test_triplet_loss_single_label_is_zero():
    emb = np.random.default_rng(2).normal(size=(6, 4)).astype(np.float32)
    got_v, got_g, want_v, want_g = _triplet_both(
        emb, np.zeros(6, np.int32), 5.0)
    assert got_v == want_v == 0.0
    assert not got_g.any() and not want_g.any()


def test_triplet_loss_tied_distances_matches_jax():
    """Integer points give exact distances: d(a, p) = 3 for both
    positives, d(a, n) = 8 for two negatives and 4 for a third, so with
    margin 5 one triplet loss is 3 - 8 + 5 = 0, on the hinge."""
    emb = np.asarray([[0, 0], [3, 0], [0, 3], [8, 0], [0, 8], [0, -4]],
                     np.float32)
    labels = np.asarray([0, 0, 0, 1, 1, 1], np.int32)
    got_v, got_g, want_v, want_g = _triplet_both(emb, labels, 5.0)
    assert want_v > 0
    _close(got_v, got_g, want_v, want_g)


def _texts(n_docs=24, seed=0):
    docs = synth_docs(seed, n_docs)
    return ["".join(c.text.replace(" ", "") for c in d.clauses)
            for d in docs]


def _encoders(texts, seed=3):
    """Both tokenizers and encoder configs, JAX's init params and their
    conversion."""
    jt, tt = JZh.from_corpus(texts), ZhCharTokenizer.from_corpus(texts)
    jenc = j_tiny(vocab_size=jt.vocab_size, dropout=0.0)
    tenc = tiny_encoder_config(vocab_size=tt.vocab_size, dropout=0.0)
    probe = jt.encode_batch(texts[:2], 16)
    params = JEncoder(jenc).init(
        jax.random.key(seed), probe.input_ids, probe.attention_mask,
        probe.token_type_ids)["params"]
    return jt, tt, jenc, tenc, params, jax_params_to_state_dict(_np(params))


@pytest.mark.parametrize("normalize", [False, True])
def test_encoder_embedder_matches_jax(normalize):
    texts = _texts(10)
    jt, tt, jenc, tenc, params, init = _encoders(texts)
    want = JEmbedder(jenc, params, jt, max_len=32, batch_size=4,
                     normalize=normalize)(texts)
    got = EncoderEmbedder(tenc, init, tt, max_len=32, batch_size=4,
                          normalize=normalize, device="cpu")(texts)
    assert got.shape == want.shape == (10, tenc.hidden_dim)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    if normalize:
        np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0,
                                   atol=1e-6)


@pytest.mark.parametrize("epochs", [1, 2])
def test_train_domain_embedder_matches_jax(epochs):
    texts = _texts(24)
    labels = [i % 3 for i in range(len(texts))]
    jt, tt, jenc, tenc, params, init = _encoders(texts)
    kw = dict(batch_size=8, epochs=epochs, max_len=32, learning_rate=1e-3)
    want = jax_params_to_state_dict(_np(j_train(
        JEmbCfg(**kw), jenc, jt, texts, labels, init_params=params)))
    logs = []

    class Log:
        def log(self, record):
            logs.append(record)

    got = train_domain_embedder(EmbedderTrainConfig(**kw), tenc, tt, texts,
                                labels, init_params=init, logger=Log(),
                                device="cpu")
    assert [r["epoch"] for r in logs] == list(range(1, epochs + 1))
    steps = epochs * (len(texts) // 8)
    err2 = ref2 = 0.0
    for name, w in want.items():
        g = got[name]
        assert float((g - w).abs().max()) <= 2 * 1e-3 * steps, name
        keep = ~_key_bias_entries(name, g)
        err2 += float(((g - w)[keep] ** 2).sum())
        ref2 += float(((w - init[name])[keep] ** 2).sum())
    assert ref2 > 0 and (err2 / ref2) ** 0.5 <= 1e-3


def test_fewer_texts_than_a_batch():
    texts = _texts(5)
    labels = [0, 1, 0, 1, 0]
    jt, tt, jenc, tenc, params, init = _encoders(texts)
    with pytest.raises(ValueError, match="5 texts, fewer than one batch of "
                                         "8"):
        train_domain_embedder(EmbedderTrainConfig(batch_size=8, epochs=1),
                              tenc, tt, texts, labels, device="cpu")

    class Log:
        def log(self, record):
            pass

    # the JAX side's fault: no step runs, then the log reads `loss`
    with pytest.raises(UnboundLocalError):
        j_train(JEmbCfg(batch_size=8, epochs=1, max_len=16), jenc, jt,
                texts, labels, init_params=params, logger=Log())


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("embed_corpus")
    write_newsplit_corpus(str(root))
    return root


DOMAIN_FILES = ("data/ECPE_new_dataset/home.txt",
                "pair_data/predicted_emotion/source_home/education.txt")


def test_loaders_and_npz_equal_jax(corpus, tmp_path):
    paths = {os.path.splitext(os.path.basename(p))[0]: str(corpus / p)
             for p in DOMAIN_FILES}
    got, want = load_domain_docs(paths), j_domain_docs(paths)
    assert got == want and len(set(got[1])) == 2
    # a keywords file: doc id, emotion, clause id, keyword, position, cause
    # flag, clause; short lines are skipped
    lines = ["1,happiness,2,笑,1,yes,他 很 高兴",
             "1,sadness,3,哭,0,no,她 哭 了",
             "2,anger,1,气,2,yes,我们 生气",
             "3,unknown,1,x,0,yes,不 知道",
             "4,fear,1,怕,0,yes,害怕",
             "too,short"]
    kw = tmp_path / "clause_keywords_emotion.txt"
    kw.write_text("\n".join(lines) + "\n", encoding="utf8")
    for ids in ((["1", "3"], ["2"]), ([1], [2, 4])):
        assert load_clause_keywords(str(kw), *ids) == j_keywords(str(kw),
                                                                 *ids)
    emb = np.random.default_rng(0).normal(size=(5, 3)).astype(np.float32)
    for labels in (None, np.arange(5)):
        for name, save in (("t", save_embeddings), ("j", j_save_emb)):
            assert save(str(tmp_path / f"{name}_emb"), emb, labels) == \
                str(tmp_path / f"{name}_emb.npz")
        for load in (load_embeddings, j_load_emb):
            for name in ("t", "j"):
                e, lab = load(str(tmp_path / f"{name}_emb"))
                assert np.array_equal(e, emb)
                assert (lab is None) == (labels is None)
                if labels is not None:
                    assert np.array_equal(lab, labels)


def test_embed_verb_writes_an_encoder_dir_train_loads(corpus, tmp_path,
                                                      capsys):
    from carel_tpu_torch.config import PRESETS
    from carel_tpu_torch.pipeline import build_pipeline, init_state
    import dataclasses

    cache, enc_dir = str(tmp_path / "cache"), tmp_path / "enc"
    assert main(["embed", "--files", *(str(corpus / p) for p in DOMAIN_FILES),
                 "--encoder", "tiny", "--device", "cpu", "--epochs", "1",
                 "--batch_size", "8", "--max_len", "48", "--out",
                 str(enc_dir), "--dump_embeddings", str(tmp_path / "emb"),
                 "--cache_dir", cache, "--log_dir", str(tmp_path / "logs")
                 ]) == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert res["encoder_ckpt"] == str(enc_dir) and res["texts"] == 40
    assert sorted(os.listdir(enc_dir)) == ["encoder.pt"]
    emb, labels = load_embeddings(res["embeddings"])
    assert emb.shape == (40, 64) and sorted(set(labels.tolist())) == [0, 1]
    saved = load_encoder(str(enc_dir))
    assert all(v.dtype == torch.float32 for v in saved.values())

    # the flagship's pipeline with the same cache: its tokenizer, and the
    # encoder dir's weights bit for bit
    cfg = PRESETS["ec_mmd_final_mul_newsplit_emnlp"]
    cfg = dataclasses.replace(
        cfg, data=dataclasses.replace(cfg.data, data_root=str(corpus)),
        model=dataclasses.replace(cfg.model,
                                  pretrained_encoder=str(enc_dir)))
    pipe = build_pipeline(cfg, cache_dir=cache,
                          encoder_cfg=tiny_encoder_config())
    model = init_state(pipe.cfg, "cpu").model
    got = model.encoder.state_dict()
    assert got.keys() == saved.keys()
    assert all(torch.equal(got[k], saved[k]) for k in saved)

    # save_encoder of a state_dict gives the same bits back
    again = save_encoder(str(tmp_path / "again"), got)
    assert all(torch.equal(load_encoder(again)[k], saved[k]) for k in saved)

    assert main(["train", "--data_root", str(corpus), "--encoder", "tiny",
                 "--device", "cpu", "--epochs", "1", "--self_iteration",
                 "0", "--batch_size", "16", "--hf_encoder", str(enc_dir),
                 "--cache_dir", cache, "--log_dir", str(tmp_path / "logs"),
                 "--checkpoint_dir", str(tmp_path / "ckpt")]) == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert 0.0 <= res["best_f1"] <= 1.0
