"""Stage-1 document-level dataset: fixed [N, D, S] token grids, a copy of
carel_tpu/stage1/data.py.

Equivalent of ECPE_Dataset (baseline_emotion_classifier_final_devin.py
:162-282): every document becomes max_doc_len=75 clause rows of
max_sen_len=60 tokens, with per-clause 7-way one-hot emotion and cause
targets parsed from numeric codes or English emotion words; clause text is
space-stripped for zh. All documents are tokenized once into numpy arrays.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence

import numpy as np

from carel_tpu_torch.data.ecpe_format import Document, parse_ecpe_file
from carel_tpu_torch.data.tokenizer import BaseTokenizer


@dataclass
class DocArrays:
    doc_ids: List[str]
    y_pairs: List[List[str]]  # raw gold-pair strings per doc (for the writer)
    x_ids: np.ndarray  # [N, D, S] int32
    x_masks: np.ndarray  # [N, D, S] int32
    x_types: np.ndarray  # [N, D, S] int32
    doc_len: np.ndarray  # [N] int32
    y_emotion: np.ndarray  # [N, D, 7] float32 one-hot
    y_cause: np.ndarray  # [N, D, 7] float32

    def __len__(self) -> int:
        return self.x_ids.shape[0]

    def take(self, idx) -> "DocArrays":
        idx = np.asarray(idx)
        return DocArrays(
            doc_ids=[self.doc_ids[i] for i in idx],
            y_pairs=[self.y_pairs[i] for i in idx],
            x_ids=self.x_ids[idx],
            x_masks=self.x_masks[idx],
            x_types=self.x_types[idx],
            doc_len=self.doc_len[idx],
            y_emotion=self.y_emotion[idx],
            y_cause=self.y_cause[idx],
        )

    def concat(self, other: "DocArrays") -> "DocArrays":
        return DocArrays(
            doc_ids=self.doc_ids + other.doc_ids,
            y_pairs=self.y_pairs + other.y_pairs,
            x_ids=np.concatenate([self.x_ids, other.x_ids]),
            x_masks=np.concatenate([self.x_masks, other.x_masks]),
            x_types=np.concatenate([self.x_types, other.x_types]),
            doc_len=np.concatenate([self.doc_len, other.doc_len]),
            y_emotion=np.concatenate([self.y_emotion, other.y_emotion]),
            y_cause=np.concatenate([self.y_cause, other.y_cause]),
        )


def _one_hot7(code: int) -> np.ndarray:
    v = np.zeros(7, np.float32)
    if code == -1:
        return v  # stage-1 '-1' cause placeholder -> no target
    v[code if 0 <= code <= 6 else 6] = 1.0
    return v


def build_doc_arrays(
    docs: Sequence[Document],
    tokenizer: BaseTokenizer,
    max_doc_len: int = 75,
    max_sen_len: int = 60,
    strip_spaces: bool = True,
) -> DocArrays:
    n = len(docs)
    x_ids = np.zeros((n, max_doc_len, max_sen_len), np.int32)
    x_masks = np.zeros((n, max_doc_len, max_sen_len), np.int32)
    x_types = np.zeros((n, max_doc_len, max_sen_len), np.int32)
    doc_len = np.zeros(n, np.int32)
    y_emotion = np.zeros((n, max_doc_len, 7), np.float32)
    y_cause = np.zeros((n, max_doc_len, 7), np.float32)
    doc_ids, y_pairs = [], []

    # every clause in one batched tokenizer pass
    texts, owners = [], []
    for i, doc in enumerate(docs):
        doc_ids.append(doc.doc_id)
        y_pairs.append([f"({e},{c})" for e, c in doc.pairs])
        d = min(doc.doc_len, max_doc_len)
        doc_len[i] = d
        for j in range(d):
            cl = doc.clauses[j]
            text = cl.text.strip()
            if strip_spaces:
                text = text.replace(" ", "")
            texts.append(text)
            owners.append((i, j))
            y_emotion[i, j] = _one_hot7(cl.emotion)
            y_cause[i, j] = _one_hot7(cl.cause)

    enc = tokenizer.encode_batch(texts, max_sen_len)
    for k, (i, j) in enumerate(owners):
        x_ids[i, j] = enc.input_ids[k]
        x_masks[i, j] = enc.attention_mask[k]
        x_types[i, j] = enc.token_type_ids[k]

    return DocArrays(doc_ids, y_pairs, x_ids, x_masks, x_types, doc_len,
                     y_emotion, y_cause)


def load_doc_arrays(path: str, tokenizer: BaseTokenizer,
                    max_doc_len: int = 75, max_sen_len: int = 60,
                    strip_spaces: bool = True) -> DocArrays:
    return build_doc_arrays(parse_ecpe_file(path), tokenizer,
                            max_doc_len, max_sen_len, strip_spaces)
