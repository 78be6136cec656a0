"""Tokenizers for the ECPE pipelines, from carel_tpu/data/tokenizer.py.

The reference encodes each pair string with a pretrained HF tokenizer to a
fixed 128-token window (ECPEDataset.__getitem__, flagship :120-146). This
module gives the same fixed-shape encoding with three backends:

- ZhCharTokenizer: a deterministic character vocabulary built from the
  corpus (Chinese BERT tokenization is effectively per-character for CJK),
  encoded by the C ingest extension (``native/``) where it builds and by
  the Python loop where it does not;
- WordPieceTokenizer: an English WordPiece trained from the corpus through
  the ``tokenizers`` library (offline, cached to disk);
- HFTokenizerAdapter: a local HF tokenizer directory, through
  ``transformers``.

``tokenizers`` and ``transformers`` are imported inside the functions that
need them, so that this module imports on a machine without them. The
literal "[SEP]" embedded in pair strings splits segments, and every batch
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

    def encode_sentence_pair_batch(
        self, texts_a: Sequence[str], texts_b: Sequence[str], max_len: int
    ) -> Encoded:
        """Two-segment encoding: [CLS] a [SEP] b [SEP] with token_type_ids
        1 on the second segment — the reference's tokenizer(emo, cau) path
        (pair_classifier_self_chain.py's sentence-pair encoding). Every
        tokenizer class takes it through its ``tokenize_to_ids``."""
        n = len(texts_a)
        ids = np.full((n, max_len), self.pad_id, np.int32)
        mask = np.zeros((n, max_len), np.int32)
        types = np.zeros((n, max_len), np.int32)
        for i, (a, b) in enumerate(zip(texts_a, texts_b)):
            a_ids = self.tokenize_to_ids(str(a))
            b_ids = self.tokenize_to_ids(str(b))
            row = [self.cls_id] + a_ids + [self.sep_id]
            seg = [0] * len(row)
            row += b_ids + [self.sep_id]
            seg += [1] * (len(b_ids) + 1)
            if len(row) > max_len:
                row = row[: max_len - 1] + [self.sep_id]
                seg = seg[: max_len]
            k = len(row)
            ids[i, :k] = row
            types[i, :k] = seg[:k]
            mask[i, :k] = 1
        return Encoded(ids, mask, types)

    def decode(self, ids: Sequence[int],
               skip_special_tokens: bool = True) -> str:
        raise NotImplementedError


def _require(module: str, what: str):
    """Import ``module``, or raise an ImportError that names it."""
    import importlib

    try:
        return importlib.import_module(module)
    except ImportError as e:
        raise ImportError(
            f"{what} needs the {module!r} package, which this machine "
            f"lacks: {e}") from e


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

    def encode_batch(self, texts: Sequence[str], max_len: int) -> Encoded:
        # the C ingest extension (native/), or the Python loop where it does
        # not build. This is host ingest, not a device kernel: a C loop over
        # the characters is all it needs, so it deliberately keeps a
        # fallback, as the JAX package's does
        from carel_tpu_torch.native.fast_tokenizer import native_encode_batch

        out = native_encode_batch(self, [str(t) for t in texts], max_len)
        if out is not None:
            return Encoded(*out)
        return super().encode_batch(texts, max_len)

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


class WordPieceTokenizer(BaseTokenizer):
    """English WordPiece trained offline from the corpus via `tokenizers`."""

    SPECIALS = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]

    def __init__(self, tok, vocab_size: int):
        self._tok = tok  # tokenizers.Tokenizer
        self.vocab_size = vocab_size
        v = tok.get_vocab()
        self.pad_id = v.get("[PAD]", 0)
        self.unk_id = v.get("[UNK]", 1)
        self.cls_id = v.get("[CLS]", 2)
        self.sep_id = v.get("[SEP]", 3)

    @classmethod
    def train_from_corpus(
        cls, texts: Sequence[str], vocab_size: int = 8192
    ) -> "WordPieceTokenizer":
        """NFD, lowercase and accent stripping; whitespace then punctuation
        pre-tokenizers; "##" continuation prefix; the five specials first."""
        tk = _require("tokenizers", "the English WordPiece tokenizer")
        tok = tk.Tokenizer(tk.models.WordPiece(unk_token="[UNK]"))
        tok.decoder = tk.decoders.WordPiece(prefix="##")
        tok.normalizer = tk.normalizers.Sequence(
            [tk.normalizers.NFD(), tk.normalizers.Lowercase(),
             tk.normalizers.StripAccents()])
        tok.pre_tokenizer = tk.pre_tokenizers.Sequence(
            [tk.pre_tokenizers.WhitespaceSplit(),
             tk.pre_tokenizers.Punctuation()])
        trainer = tk.trainers.WordPieceTrainer(
            vocab_size=vocab_size, special_tokens=list(cls.SPECIALS),
            continuing_subword_prefix="##")
        tok.train_from_iterator(iter(texts), trainer=trainer)
        return cls(tok, tok.get_vocab_size())

    @classmethod
    def load(cls, path: str) -> "WordPieceTokenizer":
        tk = _require("tokenizers", "the English WordPiece tokenizer")
        tok = tk.Tokenizer.from_file(path)
        return cls(tok, tok.get_vocab_size())

    def save(self, path: str) -> None:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._tok.save(path)

    def tokenize_to_ids(self, text: str) -> List[int]:
        return self._tok.encode(text, add_special_tokens=False).ids

    def encode_batch(self, texts: Sequence[str], max_len: int) -> Encoded:
        """Every segment of every text through the Rust batch encoder, then
        [CLS] seg [SEP] seg [SEP] ..., cut to max_len - 1 tokens plus a
        [SEP]."""
        n = len(texts)
        ids = np.full((n, max_len), self.pad_id, np.int32)
        mask = np.zeros((n, max_len), np.int32)
        types = np.zeros((n, max_len), np.int32)
        split_texts = [_SEP_SPLIT.split(str(t)) for t in texts]
        flat = [seg for segs in split_texts for seg in segs]
        encodings = self._tok.encode_batch(flat, add_special_tokens=False)
        pos = 0
        for i, segs in enumerate(split_texts):
            row: List[int] = [self.cls_id]
            for _ in segs:
                row.extend(encodings[pos].ids)
                row.append(self.sep_id)
                pos += 1
            if len(row) > max_len:
                row = row[: max_len - 1] + [self.sep_id]
            k = len(row)
            ids[i, :k] = row
            mask[i, :k] = 1
        return Encoded(ids, mask, types)

    def decode(self, ids: Sequence[int],
               skip_special_tokens: bool = True) -> str:
        return self._tok.decode([int(i) for i in ids],
                                skip_special_tokens=skip_special_tokens)


class HFTokenizerAdapter(BaseTokenizer):
    """Wraps a locally available HuggingFace tokenizer directory; the HF
    tokenizer itself splits the literal "[SEP]" (a special token) and
    truncates and pads."""

    def __init__(self, hf_tokenizer):
        self._tok = hf_tokenizer
        self.pad_id = hf_tokenizer.pad_token_id or 0
        self.unk_id = hf_tokenizer.unk_token_id or 0
        self.cls_id = hf_tokenizer.cls_token_id \
            if hf_tokenizer.cls_token_id is not None \
            else hf_tokenizer.bos_token_id
        self.sep_id = hf_tokenizer.sep_token_id \
            if hf_tokenizer.sep_token_id is not None \
            else hf_tokenizer.eos_token_id
        self.vocab_size = len(hf_tokenizer)

    @classmethod
    def load(cls, path: str) -> "HFTokenizerAdapter":
        tr = _require("transformers", "an HF tokenizer directory")
        return cls(tr.AutoTokenizer.from_pretrained(path))

    def encode_batch(self, texts: Sequence[str], max_len: int) -> Encoded:
        out = self._tok(
            [str(t) for t in texts],
            add_special_tokens=True,
            max_length=max_len,
            padding="max_length",
            truncation=True,
            return_token_type_ids=True,
            return_attention_mask=True,
            return_tensors="np",
        )
        return Encoded(
            out["input_ids"].astype(np.int32),
            out["attention_mask"].astype(np.int32),
            out.get("token_type_ids",
                    np.zeros_like(out["input_ids"])).astype(np.int32),
        )

    def tokenize_to_ids(self, text: str) -> List[int]:
        return self._tok.encode(text, add_special_tokens=False)

    def decode(self, ids: Sequence[int],
               skip_special_tokens: bool = True) -> str:
        return self._tok.decode(ids, skip_special_tokens=skip_special_tokens)


def build_tokenizer(
    language: str,
    corpus_texts: Optional[Sequence[str]] = None,
    cache_path: Optional[str] = None,
    hf_path: Optional[str] = None,
    vocab_size: int = 8192,
) -> BaseTokenizer:
    """Resolve a tokenizer: HF dir > disk cache > corpus-built (then
    cached): characters for zh, a trained WordPiece otherwise."""
    if hf_path and os.path.isdir(hf_path):
        return HFTokenizerAdapter.load(hf_path)
    if cache_path and os.path.exists(cache_path):
        if language == "zh":
            return ZhCharTokenizer.load(cache_path)
        return WordPieceTokenizer.load(cache_path)
    if corpus_texts is None:
        raise ValueError("no cached tokenizer and no corpus to build one from")
    if language == "zh":
        tok: BaseTokenizer = ZhCharTokenizer.from_corpus(corpus_texts)
    else:
        tok = WordPieceTokenizer.train_from_corpus(corpus_texts, vocab_size)
    if cache_path:
        tok.save(cache_path)
    return tok
