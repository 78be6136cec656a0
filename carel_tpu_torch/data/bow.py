"""Bag-of-words vocabularies and vectorized BoW featurization.

Copy of carel_tpu/data/bow.py, with one change: the vocabulary is built by a
pure-Python equivalent of scikit-learn's ``CountVectorizer(...)
.get_feature_names_out()`` (lowercasing, the default ``(?u)\\b\\w\\w+\\b``
token pattern when no tokenizer is given, sorted terms), because the machine
with the GPU has no scikit-learn.

Reproduces bow_util.py (reference :13-81) and ECPEDataset._get_bow_representations
(flagship :100-117, newsplit :133-155) with O(1) dict lookups. Outputs are kept
SPARSE (per-example term indices + counts padded to a fixed width) so the host
never materializes an [N, V] dense matrix; densification happens per batch on
the device.

jieba segments the zh text. A ``SegmentationCache`` in the cache dir keeps
jieba's words for every string handed to it, in a file named by a hash of
the input files' bytes, so that a machine without jieba (the one with the
GPU) reads the same words: where jieba imports, it segments and the cache
file is written; where it does not, the file is read, and a string the file
lacks raises. No other segmenter stands in.
"""

from __future__ import annotations

import hashlib
import json
import os
import re
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from carel_tpu_torch.data.ecpe_format import Document, parse_ecpe_file

_NON_CJK = re.compile(u"[^一-龥]")
_PUNCT = re.compile(r"[^\w\s]")

def _import_jieba():
    """jieba, or None where it does not import (asked anew each time, so a
    blocked import is seen)."""
    try:
        import jieba
    except ImportError:
        return None
    jieba.setLogLevel(60)
    return jieba


def _get_jieba():
    jieba = _import_jieba()
    if jieba is None:
        raise ImportError("jieba is not installed: the zh BoW needs it, or "
                          "a segmentation cache (SegmentationCache)")
    return jieba


def segmentation_cache_path(cache_dir: str, files: Sequence[str]) -> str:
    """The cache file of ``files`` (train, test, BoW corpus; or a pretrain
    corpus) in ``cache_dir``: ``segmentation_zh_<hash>.json``, the hash
    taken over the files' bytes in order."""
    digest = hashlib.sha256()
    for path in files:
        with open(path, "rb") as f:
            data = f.read()
        digest.update(len(data).to_bytes(8, "little"))
        digest.update(data)
    return os.path.join(cache_dir,
                        f"segmentation_zh_{digest.hexdigest()[:16]}.json")


class SegmentationCache:
    """jieba's words for every exact string handed to ``cut``. With jieba,
    ``cut`` segments through it and records the words, and ``save`` writes
    the file; without it, the file at ``path`` is read and a string it
    lacks raises a LookupError naming the string and the file."""

    def __init__(self, path: str):
        self.path = path
        self.jieba = _import_jieba()
        self.table: Dict[str, List[str]] = {}
        if self.jieba is None:
            if not os.path.exists(path):
                raise FileNotFoundError(
                    f"jieba is not installed and there is no zh "
                    f"segmentation cache {path}: make it where jieba "
                    f"imports, from the same input files (README.md)")
            with open(path, encoding="utf-8") as f:
                self.table = json.load(f)

    @property
    def source(self) -> str:
        return "jieba" if self.jieba is not None else "cache"

    def cut(self, text: str) -> List[str]:
        if self.jieba is not None:
            words = self.jieba.lcut(text)
            self.table[text] = words
            return words
        words = self.table.get(text)
        if words is None:
            raise LookupError(f"the zh segmentation cache {self.path} has "
                              f"no entry for {text!r}, and jieba is not "
                              f"installed")
        return list(words)

    def save(self) -> None:
        """Write the file (jieba's side only; the reading side has
        nothing new)."""
        if self.jieba is None:
            return
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        tmp = self.path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(self.table, f, ensure_ascii=False, sort_keys=True,
                      separators=(",", ":"))
        os.replace(tmp, self.path)


def open_segmentation(cache_dir: str, files: Sequence[str]
                      ) -> SegmentationCache:
    """The segmentation cache of ``files`` in ``cache_dir``."""
    return SegmentationCache(segmentation_cache_path(cache_dir, files))


def tokenize_zh(text: str,
                segmenter: Optional[SegmentationCache] = None) -> List[str]:
    """Strip non-CJK chars, then jieba-segment (bow_util.py:13-17), through
    ``segmenter`` when one is given."""
    text = _NON_CJK.sub("", text)
    if segmenter is not None:
        return segmenter.cut(text)
    return _get_jieba().lcut(text)


def bow_tokenize_en(sentence: str) -> List[str]:
    """Lowercase, strip punctuation, split on single spaces, drop GPT-2 space
    markers (bow_util.py:42-48)."""
    sentence = sentence.lower()
    sentence = _PUNCT.sub("", sentence)
    tokens = sentence.split(" ")
    return [t.replace("Ġ", "") for t in tokens if t.replace("Ġ", "") != ""]


def _doc_sentences(docs: Sequence[Document], strip_spaces: bool) -> List[str]:
    out = []
    for doc in docs:
        for cl in doc.clauses:
            text = cl.text_field3
            out.append(text.replace(" ", "") if strip_spaces else text)
    return out


@dataclass
class BowVocab:
    words: List[str]
    index: dict  # word -> position
    tokenizer: str  # "zh" | "en"
    # where zh words come from: a SegmentationCache, or jieba when None
    segmenter: Optional[SegmentationCache] = None

    def __len__(self) -> int:
        return len(self.words)

    @classmethod
    def from_words(cls, words: Iterable[str], tokenizer: str,
                   segmenter: Optional[SegmentationCache] = None
                   ) -> "BowVocab":
        words = list(words)
        return cls(words=words, index={w: i for i, w in enumerate(words)},
                   tokenizer=tokenizer, segmenter=segmenter)

    def tokenize(self, text: str) -> List[str]:
        if self.tokenizer == "zh":
            return tokenize_zh(text, self.segmenter)
        return bow_tokenize_en(text)

    def counts(self, text: str) -> Tuple[np.ndarray, np.ndarray]:
        """Sparse term counts for one pair string.

        zh mode mirrors flagship :100-117 (CJK filter + jieba);
        en mode mirrors newsplit :139 (bow_tokenize). An empty vocabulary
        (the pair and CIT classifiers', which read no BoW) counts nothing,
        so it tokenizes nothing: jieba is not needed there.
        """
        idx_map = self.index
        if not idx_map:
            return (np.zeros(0, np.int32), np.zeros(0, np.float32))
        hits = {}
        for tok in self.tokenize(text):
            j = idx_map.get(tok)
            if j is not None:
                hits[j] = hits.get(j, 0) + 1
        if not hits:
            return (np.zeros(0, np.int32), np.zeros(0, np.float32))
        idx = np.fromiter(hits.keys(), np.int32, len(hits))
        cnt = np.fromiter(hits.values(), np.float32, len(hits))
        return idx, cnt

    def batch_sparse(
        self, texts: Sequence[str], max_terms: int = 128
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Vectorize a batch of pair strings to padded sparse BoW.

        Returns (indices [N, max_terms] int32 padded with -1,
                 weights [N, max_terms] float32) where weights are counts
        normalized by max(total_count, 1) — matching the reference's
        `seq_bow /= max(sum, 1)` (flagship :115-117) including tokens outside
        the vocab contributing nothing to the sum.
        """
        n = len(texts)
        indices = np.full((n, max_terms), -1, np.int32)
        weights = np.zeros((n, max_terms), np.float32)
        for i, text in enumerate(texts):
            idx, cnt = self.counts(text)
            total = max(float(cnt.sum()), 1.0)
            k = min(len(idx), max_terms)
            indices[i, :k] = idx[:k]
            weights[i, :k] = cnt[:k] / total
        return indices, weights


_TOKEN_PATTERN = re.compile(r"(?u)\b\w\w+\b")


def _count_vectorizer_vocab(corpus: List[str], tokenizer=None) -> List[str]:
    """The terms of ``CountVectorizer(tokenizer=...).fit(corpus)``, sorted:
    each document is lowercased, then split by ``tokenizer`` or by the
    default token pattern; every distinct term is kept (min_df=1,
    max_df=1.0)."""
    split = tokenizer if tokenizer is not None else _TOKEN_PATTERN.findall
    terms = set()
    for doc in corpus:
        terms.update(split(doc.lower()))
    if not terms:
        raise ValueError("empty vocabulary; perhaps the documents only "
                         "contain stop words")
    return sorted(terms)


def build_bow_vocab_zh(file_path: str,
                       segmenter: Optional[SegmentationCache] = None
                       ) -> BowVocab:
    """zh vocab: jieba tokens over space-stripped clauses (bow_util.py:20-40);
    the words come through ``segmenter`` when one is given, and the vocab
    keeps it for the pair strings."""
    docs = parse_ecpe_file(file_path)
    corpus = _doc_sentences(docs, strip_spaces=True)
    words = _count_vectorizer_vocab(
        corpus, lambda text: tokenize_zh(text, segmenter))
    return BowVocab.from_words(words, "zh", segmenter)


def build_bow_vocab_en(file_path: str, bow_optimize: bool = False) -> BowVocab:
    """en vocab (bow_util.py:50-81).

    bow_optimize=False: CountVectorizer over space-stripped sentences (the
    reference's legacy path — each mashed sentence becomes a 'word').
    bow_optimize=True: CountVectorizer over the token *set* produced by
    bow_tokenize, seeded with 'sep'.
    """
    docs = parse_ecpe_file(file_path)
    if not bow_optimize:
        corpus = _doc_sentences(docs, strip_spaces=True)
    else:
        toks = {"sep"}
        for doc in docs:
            for cl in doc.clauses:
                toks.update(bow_tokenize_en(cl.text_field3))
        corpus = list(toks)
    return BowVocab.from_words(_count_vectorizer_vocab(corpus), "en")
