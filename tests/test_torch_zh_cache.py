"""The zh segmentation cache (carel_tpu_torch/data/bow.py) on the CPU:

- build_pipeline over the default synthetic zh corpus with jieba, then again
  with ``jieba`` blocked in ``sys.modules``: every array and the vocabulary
  equal, the second run's words read from the cache;
- the committed fixture cache (carel_tpu_torch/data/fixtures/) equals the
  one jieba writes for that corpus rebuilt from its seed;
- a string the cache lacks raises and names it; no cache and no jieba
  raises;
- make_word_starts gives the same word starts through the cache.

The port's zh BoW with jieba is held against the JAX package's in
tests/test_torch_data.py.
"""

import dataclasses
import json
import os
import sys

import numpy as np
import pytest

from carel_tpu_torch.config import PRESETS
from carel_tpu_torch.data import bow as tbow
from carel_tpu_torch.data.ecpe_format import parse_ecpe_file
from carel_tpu_torch.data.synthetic import (fixture_cache_path,
                                            write_zh_newsplit_corpus,
                                            zh_fixture_files)
from carel_tpu_torch.models.encoder import tiny_encoder_config
from carel_tpu_torch.pipeline import build_pipeline
from carel_tpu_torch.pretrain.mlm import make_word_starts

FLAGSHIP = "ec_mmd_final_mul_newsplit_emnlp"


def _cfg(root):
    cfg = PRESETS[FLAGSHIP]
    return dataclasses.replace(cfg, data=dataclasses.replace(
        cfg.data, data_root=root))


@pytest.fixture
def no_jieba(monkeypatch):
    """``import jieba`` raises, as on a machine without it."""
    monkeypatch.setitem(sys.modules, "jieba", None)


@pytest.fixture(scope="module")
def with_jieba(tmp_path_factory):
    """The default corpus and its pipeline built with jieba; the cache file
    it wrote."""
    root = str(tmp_path_factory.mktemp("zh"))
    cache = os.path.join(root, "cache")
    write_zh_newsplit_corpus(root)
    pipe = build_pipeline(_cfg(root), cache_dir=cache,
                          encoder_cfg=tiny_encoder_config())
    made = [f for f in os.listdir(cache) if f.startswith("segmentation_zh_")]
    assert len(made) == 1
    return root, cache, pipe, os.path.join(cache, made[0])


def test_pipeline_without_jieba_gives_jiebas_arrays(with_jieba, no_jieba):
    root, cache, want, _ = with_jieba
    got = build_pipeline(_cfg(root), cache_dir=cache,
                         encoder_cfg=tiny_encoder_config())
    assert want.bow.segmenter.source == "jieba"
    assert got.bow.segmenter.source == "cache"
    assert got.bow.words == want.bow.words
    assert got.cfg == want.cfg
    for name in ("train_arrays", "test_arrays"):
        a, b = getattr(got, name), getattr(want, name)
        for f in dataclasses.fields(a):
            x, y = getattr(a, f.name), getattr(b, f.name)
            if isinstance(y, np.ndarray):
                assert x.dtype == y.dtype, (name, f.name)
                np.testing.assert_array_equal(x, y, err_msg=f"{name}.{f.name}")
            else:
                assert x == y, (name, f.name)
    # self-training encodes pseudo sets of the test pairs through the cache
    pseudo = want.test_pairs
    np.testing.assert_array_equal(got.encode(pseudo).bow_indices,
                                  want.encode(pseudo).bow_indices)


def test_committed_fixture_is_jiebas_segmentation(with_jieba):
    root, _, _, made = with_jieba
    committed = fixture_cache_path()
    assert os.path.basename(made) == os.path.basename(committed)
    assert made == tbow.segmentation_cache_path(os.path.dirname(made),
                                                zh_fixture_files(root))
    with open(made, encoding="utf-8") as f:
        fresh = json.load(f)
    with open(committed, encoding="utf-8") as f:
        assert json.load(f) == fresh
    # the file holds every string handed to jieba, keyed exactly
    assert all(tbow._NON_CJK.sub("", k) == k for k in fresh)


def test_missing_text_raises_and_names_it(with_jieba, no_jieba):
    _, _, _, made = with_jieba
    seg = tbow.SegmentationCache(made)
    assert seg.source == "cache"
    with pytest.raises(LookupError) as err:
        seg.cut("这句话不在缓存里")
    assert "这句话不在缓存里" in str(err.value) and made in str(err.value)


def test_no_cache_without_jieba_raises(tmp_path, no_jieba):
    with pytest.raises(FileNotFoundError, match="jieba is not installed"):
        tbow.open_segmentation(str(tmp_path), [fixture_cache_path()])
    with pytest.raises(ImportError, match="jieba is not installed"):
        tbow.tokenize_zh("今天很高兴")  # no cache given: jieba itself


def test_word_starts_through_the_cache(with_jieba, tmp_path, monkeypatch):
    root = with_jieba[0]
    texts = [c.text.replace(" ", "") for d in parse_ecpe_file(
        zh_fixture_files(root)[0])[:40] for c in d.clauses]
    tok = with_jieba[2].tokenizer
    want = make_word_starts(texts, tok, 32, "zh")
    seg = tbow.open_segmentation(str(tmp_path), zh_fixture_files(root))
    np.testing.assert_array_equal(
        make_word_starts(texts, tok, 32, "zh", seg), want)
    seg.save()
    monkeypatch.setitem(sys.modules, "jieba", None)
    seg = tbow.open_segmentation(str(tmp_path), zh_fixture_files(root))
    assert seg.source == "cache"
    np.testing.assert_array_equal(
        make_word_starts(texts, tok, 32, "zh", seg), want)
