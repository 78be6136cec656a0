"""Legacy helpers of the reference's data_process.py; port of
carel_tpu/utils/text.py.

- getmask / softmax_by_length: length-masked attention helpers
  (data_process.py:106-133), on tensors;
- load_w2v: a word2vec text-format loader building an embedding matrix
  over a corpus vocabulary, with a seeded random vector for each miss
  (data_process.py:54-96), in numpy.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch


def getmask(lengths: torch.Tensor, max_len: int) -> torch.Tensor:
    """[B, max_len] 1/0 fp32 mask from per-example lengths."""
    idx = torch.arange(max_len, device=lengths.device)[None, :]
    return (idx < lengths[:, None]).float()


def softmax_by_length(inputs: torch.Tensor,
                      lengths: torch.Tensor) -> torch.Tensor:
    """Softmax over the last axis restricted to the first ``length``
    positions (data_process.py:119-133); inputs [B, 1, L]."""
    mask = getmask(lengths, inputs.shape[-1])[:, None, :]
    exps = torch.exp(inputs.float()) * mask
    return exps / (torch.sum(exps, dim=-1, keepdim=True) + 1e-9)


def load_w2v(
    embedding_dim: int,
    data_file_path: str,
    embedding_path: str,
    seed: int = 42,
) -> Tuple[Dict[str, int], np.ndarray]:
    """(word -> 1-based index, [V+1, D] embedding matrix) from a text-format
    vector file; row 0 is the padding vector, misses get U(-0.1, 0.1)."""
    words = []
    with open(data_file_path, encoding="utf-8") as f:
        for line in f:
            parts = line.strip().split(",")
            if len(parts) >= 4:
                words.extend(parts[-1].split())
    vocab = sorted(set(words))
    word_idx = {w: i + 1 for i, w in enumerate(vocab)}

    w2v = {}
    with open(embedding_path, encoding="utf-8") as f:
        f.readline()  # header
        for line in f:
            parts = line.strip().split(" ")
            if len(parts) >= embedding_dim + 1:
                w2v[parts[0]] = np.asarray(parts[1: embedding_dim + 1],
                                           np.float32)

    rng = np.random.default_rng(seed)
    emb = np.zeros((len(vocab) + 1, embedding_dim), np.float32)
    for w, i in word_idx.items():
        if w in w2v:
            emb[i] = w2v[w]
        else:
            emb[i] = rng.uniform(-0.1, 0.1, embedding_dim)
    return word_idx, emb
