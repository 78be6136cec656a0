"""The port's C ingest extension (carel_tpu_torch/native, csrc/fastingest.c)
against the Python loop it replaces: JAX's cases of tests/test_native.py,
and the corners where the JAX package's C path and its Python loop part
(a trailing or repeated "[SEP]", a cut right after a segment's [SEP]),
plus a seeded fuzz over short strings and small windows. Every array must
be bit-equal. The tests skip only where no C compiler (or no Python
headers) is found, as JAX's do."""

import os
import random

import numpy as np
import pytest

from carel_tpu.data.tokenizer import ZhCharTokenizer as JTok
from carel_tpu.native.fast_tokenizer import \
    native_encode_batch as j_native_encode_batch

from carel_tpu_torch.data.tokenizer import BaseTokenizer, ZhCharTokenizer
from carel_tpu_torch.native import build
from carel_tpu_torch.native.fast_tokenizer import native_encode_batch

CORPUS = ["他很难过因为天气变冷", "她笑了收到礼物 abc 123"]
# tests/test_native.py's cases
JAX_CASES = [
    "他很难过[SEP]天气变冷",
    "她笑了[SEP]收到礼物",
    "",
    "未知字符测试xyz",
    "a[SEP]b[SEP]c",
    "  空白  处理 [SEP] 正常 ",
]
# where JAX's C path leaves its Python loop
CORNERS = ["a[SEP]", "[SEP][SEP]", "[SEP]", " [SEP] ", "他很[SEP]难过[SEP]",
           "他很难[SEP]过", "[SEP", "SEP]", "[sep]"]


@pytest.fixture(scope="module")
def mod():
    m = build.load_fastingest()
    if m is None:
        pytest.skip(f"no C compiler available: {build.last_error}")
    return m


@pytest.fixture(scope="module")
def tok():
    return ZhCharTokenizer.from_corpus(CORPUS)


def _assert_native_is_python(tok, texts, max_len):
    got = native_encode_batch(tok, texts, max_len)
    want = BaseTokenizer.encode_batch(tok, texts, max_len)
    for a, b in zip(got, (want.input_ids, want.attention_mask,
                          want.token_type_ids)):
        assert a.dtype == b.dtype and np.array_equal(a, b), (texts, max_len)


@pytest.mark.parametrize("max_len", [2, 4, 5, 16, 24])
def test_native_matches_python(mod, tok, max_len):
    long_row = "他很难过因为天气变冷" * 10 + "[SEP]" + "她笑了" * 20
    _assert_native_is_python(tok, JAX_CASES + CORNERS + [long_row], max_len)


def test_native_matches_python_on_random_strings(mod, tok):
    rng = random.Random(0)
    alphabet = list("他很难过因为天气变冷她笑了 xyz\t") + ["[SEP]"] * 4
    texts = ["".join(rng.choice(alphabet) for _ in range(rng.randint(0, 30)))
             for _ in range(2000)]
    for max_len in (2, 3, 7, 12, 40):
        _assert_native_is_python(tok, texts, max_len)


def test_tokenizer_dispatches_to_native(mod, tok, monkeypatch):
    """encode_batch takes the C path when it builds, and the Python loop
    (with the same arrays) when it does not."""
    texts = ["他很难过[SEP]天气变冷"] * 3 + ["a[SEP]"]
    calls = []
    real = build.load_fastingest
    monkeypatch.setattr(
        "carel_tpu_torch.native.fast_tokenizer.load_fastingest",
        lambda: calls.append(1) or real())
    enc = tok.encode_batch(texts, 16)
    assert calls
    monkeypatch.setattr(
        "carel_tpu_torch.native.fast_tokenizer.load_fastingest", lambda: None)
    loop = tok.encode_batch(texts, 16)
    for f in ("input_ids", "attention_mask", "token_type_ids"):
        assert np.array_equal(getattr(enc, f), getattr(loop, f)), f


def test_built_under_build_dir(mod):
    """The extension is built under build/carel_tpu_torch/ at the root of
    the checkout, never next to the module, under a name that carries the
    source's hash."""
    so = build.so_path()
    assert so.exists() and so.parent == build.BUILD_DIR
    assert build.BUILD_DIR.parts[-2:] == ("build", "carel_tpu_torch")
    assert not any(f.endswith((".so", ".pyd")) for f in os.listdir(
        os.path.dirname(build.__file__)))


def test_jax_native_drops_a_trailing_sep(mod, tok):
    """The JAX package's C path leaves its own Python loop on a text that
    ends in "[SEP]": it writes one [SEP] where the loop writes two (the
    last, empty segment's). The port's C path writes what the loop
    writes. Recorded in ROADMAP Queue 3 (JAX side)."""
    jtok = JTok.from_corpus(CORPUS)
    got_j = j_native_encode_batch(jtok, ["a[SEP]"], 8)
    if got_j is None:
        pytest.skip("the JAX package's C path does not build here")
    loop = BaseTokenizer.encode_batch(tok, ["a[SEP]"], 8)
    port = native_encode_batch(tok, ["a[SEP]"], 8)
    assert loop.attention_mask.sum() == 4 and port[1].sum() == 4
    assert got_j[1].sum() == 3
    assert np.array_equal(port[0], loop.input_ids)
