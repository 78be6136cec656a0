"""Pair-file writer: stage-1 predictions -> stage-2 input files, a copy of
carel_tpu/stage1/pair_writer.py (byte for byte the same output).

Byte-layout-compatible with generate_pair_data
(baseline_emotion_classifier_final_devin.py:89-104): per document a
"<doc_id> <doc_len>" header, the original gold-pair line, then one
"<sen_id>, <pred_emotion>, <pred_cause>, <decoded clause>" line per clause,
where the clause is the tokenizer's decode of the stored token ids
(space-separated tokens, special tokens skipped).
"""

from __future__ import annotations

import os

import numpy as np

from carel_tpu_torch.data.tokenizer import BaseTokenizer
from carel_tpu_torch.stage1.data import DocArrays


def write_pair_data(
    file_name: str,
    arrays: DocArrays,
    pred_emotion: np.ndarray,  # [N, D] int
    tokenizer: BaseTokenizer,
    pred_cause: np.ndarray = None,  # [N, D] int, defaults to -1
) -> None:
    os.makedirs(os.path.dirname(file_name) or ".", exist_ok=True)
    n = len(arrays)
    if pred_cause is None:
        pred_cause = np.full_like(np.asarray(pred_emotion), -1)
    with open(file_name, "w", encoding="utf8") as g:
        for i in range(n):
            d = int(arrays.doc_len[i])
            g.write(f"{arrays.doc_ids[i]} {d}\n")
            g.write(", ".join(arrays.y_pairs[i]) + "\n")
            for j in range(d):
                clause = tokenizer.decode(arrays.x_ids[i, j],
                                          skip_special_tokens=True)
                g.write(f"{j + 1}, {int(pred_emotion[i][j])}, "
                        f"{int(pred_cause[i][j])}, {clause}\n")
