"""The port's English tokenizers (carel_tpu_torch.data.tokenizer) against
carel_tpu's on the CPU: a WordPiece trained by each package on one
synthetic en corpus, the encoding of pair strings, a save/load round trip,
an HF tokenizer directory built locally from that vocabulary (no download)
and build_tokenizer's resolution order. Everything must be exactly equal.

The tokenizers library's WordPiece trainer does not repeat its vocabulary:
it breaks ties between equally frequent merges in hash-map order, so two
trainings of one corpus, in one package or two, keep the same size, the
same alphabet and the same configuration but other intermediate subwords
(test_wordpiece_trainer_matches_jax). A run is repeatable through the
cached tokenizer file, and so the encodings are held with one vocabulary:
the file JAX's trained tokenizer saved, loaded by each package."""

import json
import sys

import numpy as np
import pytest

from carel_tpu.data.tokenizer import HFTokenizerAdapter as JHF
from carel_tpu.data.tokenizer import WordPieceTokenizer as JWP
from carel_tpu.data.tokenizer import build_tokenizer as j_build_tokenizer

from carel_tpu_torch.data import tokenizer as ttok
from carel_tpu_torch.data.tokenizer import HFTokenizerAdapter as THF
from carel_tpu_torch.data.tokenizer import WordPieceTokenizer as TWP

from tests.test_torch_data import synth_docs

VOCAB = 400
# pair strings as the pipeline builds them, and the corners of encoding:
# accents, punctuation, capitals, an empty string, an empty segment, a
# [SEP] without spaces, three segments and rows longer than the window
EDGE_TEXTS = [
    "She was happy [SEP] because the exam went well",
    "Café naïve RÉSUMÉ [SEP] Über façade",
    "didn't won't, it's!! (again) \"no\" rain; why?",
    "",
    "[SEP]",
    "left [SEP] ",
    "a[SEP]b [SEP] c",
    " ".join(["homework!"] * 80) + " [SEP] " + " ".join(["friends"] * 40),
    "unknownword zzzqqq 12345 ☃",
]


def en_texts(seed: int = 0, n_docs: int = 20):
    docs = synth_docs(seed, n_docs, language="en")
    return [c.text for d in docs for c in d.clauses]


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    """One trained vocabulary in each package: JAX's WordPiece, trained
    and saved, and the port's load of that file."""
    path = str(tmp_path_factory.mktemp("wordpiece") / "tokenizer_en.json")
    j = JWP.train_from_corpus(en_texts(), VOCAB)
    j.save(path)
    return TWP.load(path), j


def _pair_texts():
    docs = synth_docs(1, 6, language="en")
    pairs = [f"{d.clauses[0].text} [SEP] {d.clauses[-1].text}" for d in docs]
    return pairs + EDGE_TEXTS


def _assert_same(got, want):
    for f in ("input_ids", "attention_mask", "token_type_ids"):
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype == np.int32 and np.array_equal(a, b), f


def _config_and_vocab(tok):
    cfg = json.loads(tok._tok.to_str())
    return cfg, cfg["model"].pop("vocab")


def test_wordpiece_trainer_matches_jax():
    """The port's trainer is JAX's: the same normalizer (NFD, lowercase,
    strip accents), pre-tokenizers (whitespace, punctuation), model, "##"
    decoder and specials at ids 0-4; its vocabulary has JAX's size and
    alphabet (the characters and their "##" forms) and covers the corpus
    with no [UNK]."""
    corpus = en_texts()
    t, j = TWP.train_from_corpus(corpus, VOCAB), JWP.train_from_corpus(
        corpus, VOCAB)
    (t_cfg, t_vocab), (j_cfg, j_vocab) = map(_config_and_vocab, (t, j))
    assert t_cfg == j_cfg
    assert len(t_vocab) == len(j_vocab) == t.vocab_size
    assert [k for k, _ in sorted(t_vocab.items(), key=lambda kv: kv[1])][
        :5] == TWP.SPECIALS
    alphabet = {k for k in j_vocab if len(k.removeprefix("##")) == 1}
    assert {k for k in t_vocab if len(k.removeprefix("##")) == 1} == alphabet
    assert any(k.startswith("##") for k in t_vocab)
    for text in corpus:
        assert t.unk_id not in t.tokenize_to_ids(text), text


def test_wordpiece_loaded_vocab_equals_jax(both):
    t, j = both
    assert t._tok.get_vocab() == j._tok.get_vocab()
    assert (t.vocab_size, t.pad_id, t.unk_id, t.cls_id, t.sep_id) == (
        j.vocab_size, j.pad_id, j.unk_id, j.cls_id, j.sep_id)
    assert (t.pad_id, t.unk_id, t.cls_id, t.sep_id) == (0, 1, 2, 3)


@pytest.mark.parametrize("max_len", [8, 32, 128])
def test_wordpiece_encode_batch_equals_jax(both, max_len):
    t, j = both
    texts = _pair_texts()
    got, want = t.encode_batch(texts, max_len), j.encode_batch(texts,
                                                               max_len)
    _assert_same(got, want)
    # the long row is cut to max_len - 1 ids and a [SEP]; the empty string
    # is [CLS] [SEP]; accents are stripped and lowercased before lookup
    long_row = texts.index(EDGE_TEXTS[7])
    assert got.attention_mask[long_row].all()
    assert got.input_ids[long_row, -1] == t.sep_id
    empty = texts.index("")
    assert list(got.input_ids[empty, :3]) == [t.cls_id, t.sep_id, t.pad_id]
    assert t.tokenize_to_ids("CAFÉ") == t.tokenize_to_ids("cafe")
    for text in texts:
        assert t.tokenize_to_ids(text) == j.tokenize_to_ids(text)
    ids = got.input_ids[0]
    for skip in (True, False):
        assert t.decode(ids, skip) == j.decode(ids, skip)


def test_wordpiece_save_load_round_trip(both, tmp_path):
    t, j = both
    path = str(tmp_path / "sub" / "tokenizer_en.json")
    t.save(path)
    back = TWP.load(path)
    texts = _pair_texts()
    _assert_same(back.encode_batch(texts, 32), t.encode_batch(texts, 32))
    # the file is the tokenizers library's: JAX's loader reads it too
    _assert_same(JWP.load(path).encode_batch(texts, 32),
                 j.encode_batch(texts, 32))


def hf_tokenizer_dir(wordpiece, path: str) -> str:
    """A local HF tokenizer directory (BertTokenizerFast, lowercasing and
    stripping accents) over ``wordpiece``'s vocabulary; returns ``path``."""
    transformers = pytest.importorskip("transformers")
    vocab = wordpiece._tok.get_vocab()
    vocab_file = f"{path}.vocab.txt"
    with open(vocab_file, "w", encoding="utf8") as f:
        f.write("\n".join(sorted(vocab, key=vocab.get)) + "\n")
    transformers.BertTokenizerFast(
        vocab_file=vocab_file, do_lower_case=True,
        strip_accents=True).save_pretrained(path)
    return path


def test_hf_tokenizer_adapter_equals_jax(both, tmp_path):
    t, _ = both
    path = hf_tokenizer_dir(t, str(tmp_path / "hf_tok"))
    got, want = THF.load(path), JHF.load(path)
    assert (got.vocab_size, got.pad_id, got.unk_id, got.cls_id,
            got.sep_id) == (want.vocab_size, want.pad_id, want.unk_id,
                            want.cls_id, want.sep_id)
    texts = _pair_texts()
    for max_len in (8, 48):
        _assert_same(got.encode_batch(texts, max_len),
                     want.encode_batch(texts, max_len))
    assert got.tokenize_to_ids(texts[0]) == want.tokenize_to_ids(texts[0])
    ids = got.encode_batch(texts[:1], 48).input_ids[0]
    assert got.decode(ids) == want.decode(ids)


def test_build_tokenizer_resolution_order(both, tmp_path):
    """An HF dir first, then the cache, then a WordPiece built from the
    corpus and cached; zh caches load as characters; no cache and no corpus
    raises."""
    t, _ = both
    corpus = en_texts()
    cache = str(tmp_path / "tokenizer_en.json")
    built = ttok.build_tokenizer("en", corpus, cache, vocab_size=VOCAB)
    assert isinstance(built, TWP) and built.vocab_size == t.vocab_size
    # JAX's build_tokenizer reads the cache the port wrote
    want = j_build_tokenizer("en", None, cache)
    texts = _pair_texts()
    _assert_same(built.encode_batch(texts, 32), want.encode_batch(texts, 32))
    # the cache now wins over the corpus (a different corpus is ignored)
    cached = ttok.build_tokenizer("en", ["other words"], cache)
    assert isinstance(cached, TWP)
    _assert_same(cached.encode_batch(texts, 32), built.encode_batch(texts,
                                                                    32))
    # an HF dir wins over the cache
    hf = hf_tokenizer_dir(t, str(tmp_path / "hf_tok"))
    assert isinstance(ttok.build_tokenizer("en", None, cache, hf), THF)
    zh = ttok.build_tokenizer("zh", ["他很难过"], str(tmp_path / "zh.json"))
    assert isinstance(ttok.build_tokenizer("zh", None, str(
        tmp_path / "zh.json")), ttok.ZhCharTokenizer)
    assert zh.vocab_size % 128 == 0
    with pytest.raises(ValueError, match="no cached tokenizer"):
        ttok.build_tokenizer("en", None, str(tmp_path / "missing.json"))


@pytest.mark.parametrize("module, call", [
    ("tokenizers", lambda tmp: TWP.train_from_corpus(["a b c"], 50)),
    ("transformers", lambda tmp: THF.load(str(tmp)))])
def test_missing_library_is_named(module, call, tmp_path, monkeypatch):
    """tokenizers and transformers are imported where they are needed; a
    machine without one gets an ImportError that names it."""
    monkeypatch.setitem(sys.modules, module, None)
    with pytest.raises(ImportError, match=repr(module)):
        call(tmp_path)
