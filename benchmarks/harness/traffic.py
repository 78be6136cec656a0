"""The one traffic generator. A traffic file (``traffic/<name>.json``) holds
only parameters; everything here is drawn from ``--seed`` with numpy on the
host, and the same seed gives the same arrays.

Every seed gets the same set of sizes in another order: the lengths, the
BoW term counts and the number of positives are fixed multisets that the
seed permutes, so that the work of a run does not depend on its seed.

Pair rows (``pair_rows``), as the port's ``PairArrays`` holds them: a
[CLS], the two clauses' ids with a [SEP] between them, a closing [SEP],
pads to ``max_len``; the pair label, the emotion class, the temporal
order; the BoW terms of the row as ``bow_slots`` indices padded with -1
and their normalised counts. MLM corpus rows (``mlm_corpus``): [CLS], the
clause's ids, [SEP], pads.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

# streams drawn from one seed, kept apart so that adding a draw to one
# leaves the others as they were
STREAM_ROWS, STREAM_CHECK, STREAM_ORDER, STREAM_SAMPLE = 1, 2, 3, 4


def rng_for(seed: int, stream: int) -> np.random.Generator:
    """A numpy generator of ``seed`` (any whole number up to 64 bits and
    beyond) and ``stream``."""
    return np.random.default_rng([int(seed) % (1 << 64), stream])


def spread(lo: int, hi: int, n: int) -> np.ndarray:
    """``n`` whole numbers spread evenly over [lo, hi]: the fixed multiset
    that every seed permutes."""
    return np.round(np.linspace(lo, hi, n)).astype(np.int64)


def pair_rows(t: dict, tokens: dict, vocab: int, bow_vocab: int,
              rows: int, seed: int, stream: int = STREAM_ROWS
              ) -> Dict[str, np.ndarray]:
    """``rows`` pair rows of traffic ``t`` over the tokenizer ids
    ``tokens`` (cls, sep, pad, first content id)."""
    rng = rng_for(seed, stream)
    L = t["max_len"]
    lengths = rng.permutation(spread(t["len_min"], t["len_max"], rows))
    ids = np.full((rows, L), tokens["pad"], np.int32)
    mask = np.zeros((rows, L), np.int32)
    content = rng.integers(tokens["first_content"], vocab, (rows, L),
                           dtype=np.int64).astype(np.int32)
    for i, n in enumerate(lengths):
        ids[i, :n] = content[i, :n]
        ids[i, 0] = tokens["cls"]
        ids[i, n // 2] = tokens["sep"]
        ids[i, n - 1] = tokens["sep"]
        mask[i, :n] = 1
    n_pos = int(round(t["positive_share"] * rows))
    labels = np.zeros(rows, np.float32)
    labels[:n_pos] = 1.0
    labels = rng.permutation(labels)
    emotions = rng.integers(0, t["emotion_classes"], rows).astype(np.int32)
    order = rng.integers(0, 2, rows).astype(bool)

    T = t["bow_slots"]
    terms = rng.permutation(spread(t["bow_terms_min"], t["bow_terms_max"],
                                   rows))
    bow_idx = np.full((rows, T), -1, np.int32)
    bow_w = np.zeros((rows, T), np.float32)
    for i, k in enumerate(terms):
        bow_idx[i, :k] = rng.choice(bow_vocab, size=k, replace=False)
        counts = rng.integers(1, 4, k).astype(np.float64)
        bow_w[i, :k] = (counts / counts.sum()).astype(np.float32)
    return {
        "input_ids": ids,
        "attention_mask": mask,
        "token_type_ids": np.zeros((rows, L), np.int32),
        "pair_labels": labels,
        "emotion_labels": emotions,
        "temporal_order": order,
        "bow_indices": bow_idx,
        "bow_weights": bow_w,
    }


def mlm_corpus(t: dict, vocab: int, seed: int
               ) -> Tuple[np.ndarray, np.ndarray]:
    """(ids, attention mask) [rows, seq_len] int32 of an MLM corpus of
    clauses, ids drawn over the content ids."""
    rng = rng_for(seed, STREAM_ROWS)
    rows, L = t["corpus_rows"], t["seq_len"]
    lengths = rng.permutation(spread(t["len_min"], t["len_max"], rows))
    ids = np.full((rows, L), t["pad_id"], np.int32)
    mask = np.zeros((rows, L), np.int32)
    content = rng.integers(t["first_content_id"], vocab, (rows, L),
                           dtype=np.int64).astype(np.int32)
    for i, n in enumerate(lengths):
        ids[i, :n] = content[i, :n]
        ids[i, 0] = t["cls_id"]
        ids[i, n - 1] = t["sep_id"]
        mask[i, :n] = 1
    return ids, mask


def mean_candidates(t: dict) -> float:
    """The mean number of maskable positions a corpus row holds: its
    content ids, between [CLS] and [SEP]."""
    lengths = spread(t["len_min"], t["len_max"], t["corpus_rows"])
    return float(np.mean(lengths - 2))
