"""Tokenizers for the ECPE pipelines (zh), from carel_tpu/data/tokenizer.py.

The reference encodes each pair string with a pretrained HF tokenizer to a
fixed 128-token window (ECPEDataset.__getitem__, flagship :120-146). This
module keeps the JAX package's corpus-built character tokenizer for zh
(Chinese BERT tokenization is effectively per-character for CJK) on its pure
Python encode path. The native C ingest, the trained English WordPiece and HF
tokenizer directories are not ported yet: ``build_tokenizer`` raises for en.

The literal "[SEP]" embedded in pair strings splits segments, and every batch
comes out as (input_ids, attention_mask, token_type_ids) numpy arrays of a
static shape.
"""

from __future__ import annotations

import json
import os
import re
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np

_SEP_SPLIT = re.compile(r"\s*\[SEP\]\s*")


@dataclass
class Encoded:
    input_ids: np.ndarray  # [N, L] int32
    attention_mask: np.ndarray  # [N, L] int32
    token_type_ids: np.ndarray  # [N, L] int32


class BaseTokenizer:
    """Fixed-shape tokenizer interface."""

    pad_id: int
    unk_id: int
    cls_id: int
    sep_id: int
    vocab_size: int

    def tokenize_to_ids(self, text: str) -> List[int]:
        raise NotImplementedError

    def encode(self, text: str, max_len: int) -> Dict[str, np.ndarray]:
        segments = _SEP_SPLIT.split(text)
        ids: List[int] = [self.cls_id]
        for seg in segments:
            ids.extend(self.tokenize_to_ids(seg))
            ids.append(self.sep_id)
        if len(segments) == 0 or (len(segments) == 1 and segments[0] == ""):
            ids = [self.cls_id, self.sep_id]
        # truncate, always keeping a trailing [SEP] like HF truncation does
        if len(ids) > max_len:
            ids = ids[: max_len - 1] + [self.sep_id]
        n = len(ids)
        input_ids = np.full(max_len, self.pad_id, np.int32)
        input_ids[:n] = ids
        mask = np.zeros(max_len, np.int32)
        mask[:n] = 1
        types = np.zeros(max_len, np.int32)
        return {
            "input_ids": input_ids,
            "attention_mask": mask,
            "token_type_ids": types,
        }

    def encode_batch(self, texts: Sequence[str], max_len: int) -> Encoded:
        n = len(texts)
        ids = np.full((n, max_len), self.pad_id, np.int32)
        mask = np.zeros((n, max_len), np.int32)
        types = np.zeros((n, max_len), np.int32)
        for i, t in enumerate(texts):
            e = self.encode(str(t), max_len)
            ids[i] = e["input_ids"]
            mask[i] = e["attention_mask"]
            types[i] = e["token_type_ids"]
        return Encoded(ids, mask, types)


class ZhCharTokenizer(BaseTokenizer):
    """Character-level tokenizer with a deterministic corpus-built vocab.

    Special ids follow the BERT convention ([PAD]=0, [UNK]=1, [CLS]=2,
    [SEP]=3, [MASK]=4) followed by characters in sorted order, padded up to a
    multiple of 128 with reserved slots.
    """

    SPECIALS = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]

    def __init__(self, chars: Sequence[str]):
        vocab = list(self.SPECIALS) + sorted(set(chars) - set(self.SPECIALS))
        pad_to = (-len(vocab)) % 128
        vocab += [f"[unused{i}]" for i in range(pad_to)]
        self.vocab = vocab
        self.token_to_id = {t: i for i, t in enumerate(vocab)}
        self.pad_id, self.unk_id, self.cls_id, self.sep_id = 0, 1, 2, 3
        self.vocab_size = len(vocab)

    @classmethod
    def from_corpus(cls, texts: Sequence[str]) -> "ZhCharTokenizer":
        chars = set()
        for t in texts:
            for ch in t:
                if not ch.isspace():
                    chars.add(ch)
        return cls(sorted(chars))

    @classmethod
    def load(cls, path: str) -> "ZhCharTokenizer":
        with open(path, encoding="utf8") as f:
            data = json.load(f)
        tok = cls.__new__(cls)
        tok.vocab = data["vocab"]
        tok.token_to_id = {t: i for i, t in enumerate(tok.vocab)}
        tok.pad_id, tok.unk_id, tok.cls_id, tok.sep_id = 0, 1, 2, 3
        tok.vocab_size = len(tok.vocab)
        return tok

    def save(self, path: str) -> None:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w", encoding="utf8") as f:
            json.dump({"kind": "zh_char", "vocab": self.vocab}, f,
                      ensure_ascii=False)

    def tokenize_to_ids(self, text: str) -> List[int]:
        get = self.token_to_id.get
        unk = self.unk_id
        return [get(ch, unk) for ch in text if not ch.isspace()]

    def decode(self, ids: Sequence[int],
               skip_special_tokens: bool = True) -> str:
        """The tokens of ``ids`` joined by single spaces, as the reference's
        tokenizer.decode writes a clause into the stage-1 pair files; the
        specials are skipped when asked and the reserved [unused...] slots
        always."""
        toks = []
        for i in ids:
            i = int(i)
            if skip_special_tokens and i < len(self.SPECIALS):
                continue
            if 0 <= i < self.vocab_size:
                t = self.vocab[i]
                if not t.startswith("[unused"):
                    toks.append(t)
        return " ".join(toks)


def build_tokenizer(
    language: str,
    corpus_texts: Optional[Sequence[str]] = None,
    cache_path: Optional[str] = None,
) -> BaseTokenizer:
    """Resolve the zh tokenizer: disk cache > corpus-built (then cached)."""
    if language != "zh":
        raise NotImplementedError(
            f"tokenizer for language {language!r} is not ported yet: only zh "
            "(ZhCharTokenizer) runs in carel_tpu_torch")
    if cache_path and os.path.exists(cache_path):
        return ZhCharTokenizer.load(cache_path)
    if corpus_texts is None:
        raise ValueError("no cached tokenizer and no corpus to build one from")
    tok = ZhCharTokenizer.from_corpus(corpus_texts)
    if cache_path:
        tok.save(cache_path)
    return tok
