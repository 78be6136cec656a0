"""Fixed-shape batching (copy of carel_tpu/data/batching.py).

The reference feeds ragged pandas rows through a torch DataLoader
(flagship :949-961); here the whole pair set is pre-tokenized into static
numpy arrays once (PairArrays), then cut into padded fixed-shape batches with
an example-validity mask. The final short batch is padded up (never dropped)
and masked out of every loss/metric, so every step sees the same shapes.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Iterator, Optional

import numpy as np

from carel_tpu_torch.data.bow import BowVocab
from carel_tpu_torch.data.pairs import PairSet
from carel_tpu_torch.data.tokenizer import BaseTokenizer

BOW_MAX_TERMS = 128  # pair strings are <=128 tokens, so <=128 distinct terms


@dataclass
class PairArrays:
    """The entire pair set as static-shape numpy arrays."""

    input_ids: np.ndarray  # [N, L] int32
    attention_mask: np.ndarray  # [N, L] int32
    token_type_ids: np.ndarray  # [N, L] int32
    pair_labels: np.ndarray  # [N] float32, 1.0 = true pair
    emotion_labels: np.ndarray  # [N] int32, 0..5
    temporal_order: np.ndarray  # [N] bool
    bow_indices: np.ndarray  # [N, T] int32, -1 padded
    bow_weights: np.ndarray  # [N, T] float32, normalized counts

    def __len__(self) -> int:
        return self.input_ids.shape[0]

    def take(self, idx: np.ndarray) -> "PairArrays":
        return PairArrays(*[getattr(self, f.name)[idx]
                            for f in self.__dataclass_fields__.values()])


def encode_pairs(
    pair_set: PairSet,
    tokenizer: BaseTokenizer,
    bow: BowVocab,
    max_len: int = 128,
    bow_max_terms: int = BOW_MAX_TERMS,
    sentence_pair: bool = False,
) -> PairArrays:
    """Tokenize + featurize a pair set.

    sentence_pair=True encodes the two clauses as separate segments with
    token_type_ids (the reference's pair_classifier_self_chain encoding)
    instead of one [SEP]-joined string.
    """
    texts = pair_set.pairs
    if sentence_pair:
        split = [re.split(r"\s*\[SEP\]\s*", str(t), maxsplit=1)
                 for t in texts]
        a = [s[0] for s in split]
        b = [s[1] if len(s) > 1 else "" for s in split]
        enc = tokenizer.encode_sentence_pair_batch(a, b, max_len)
    else:
        enc = tokenizer.encode_batch(texts, max_len)
    bow_idx, bow_w = bow.batch_sparse(texts, bow_max_terms)
    return PairArrays(
        input_ids=enc.input_ids,
        attention_mask=enc.attention_mask,
        token_type_ids=enc.token_type_ids,
        pair_labels=np.asarray(pair_set.labels, np.float32),
        emotion_labels=np.asarray([e.emotion for e in pair_set.examples], np.int32),
        temporal_order=np.asarray(
            [e.temporal_order for e in pair_set.examples], bool),
        bow_indices=bow_idx,
        bow_weights=bow_w,
    )


@dataclass
class Batch:
    """One fixed-shape batch; example_mask marks real (non-padding) rows."""

    input_ids: np.ndarray
    attention_mask: np.ndarray
    token_type_ids: np.ndarray
    pair_labels: np.ndarray
    emotion_labels: np.ndarray
    bow_indices: np.ndarray
    bow_weights: np.ndarray
    example_mask: np.ndarray  # [B] float32

    def as_dict(self) -> dict:
        return {
            "input_ids": self.input_ids,
            "attention_mask": self.attention_mask,
            "token_type_ids": self.token_type_ids,
            "pair_labels": self.pair_labels,
            "emotion_labels": self.emotion_labels,
            "bow_indices": self.bow_indices,
            "bow_weights": self.bow_weights,
            "example_mask": self.example_mask,
        }


def _pad_to(x: np.ndarray, size: int) -> np.ndarray:
    if x.shape[0] == size:
        return x
    pad = [(0, size - x.shape[0])] + [(0, 0)] * (x.ndim - 1)
    return np.pad(x, pad)


def cut_batch(arrays: PairArrays, idx: np.ndarray, batch_size: int) -> Batch:
    """Materialize a fixed-size batch from row indices (padding the tail)."""
    k = len(idx)
    sel = arrays.take(idx)
    mask = np.zeros(batch_size, np.float32)
    mask[:k] = 1.0
    return Batch(
        input_ids=_pad_to(sel.input_ids, batch_size),
        attention_mask=_pad_to(sel.attention_mask, batch_size),
        token_type_ids=_pad_to(sel.token_type_ids, batch_size),
        pair_labels=_pad_to(sel.pair_labels, batch_size),
        emotion_labels=_pad_to(sel.emotion_labels, batch_size),
        bow_indices=_pad_to(sel.bow_indices, batch_size),
        bow_weights=_pad_to(sel.bow_weights, batch_size),
        example_mask=mask,
    )


def iter_batches(
    arrays: PairArrays,
    batch_size: int,
    shuffle: bool = True,
    rng: Optional[np.random.Generator] = None,
) -> Iterator[Batch]:
    n = len(arrays)
    order = np.arange(n)
    if shuffle:
        (rng or np.random.default_rng()).shuffle(order)
    for start in range(0, n, batch_size):
        yield cut_batch(arrays, order[start : start + batch_size], batch_size)

