"""Evaluation metrics: binary precision/recall/F1 with forced-miss padding,
the second-step pair-filter metric, and stage 1's micro P/R/F1 over
clauses.

Port of carel_tpu/train/metrics.py (the reference's metric, flagship
:868-870, including sklearn's 0-when-undefined convention). The forced-miss
padding appends one (label=1, pred=0) per emotion clause stage 1 failed to
predict (flagship :861-865), so pair-F1 accounts for stage-1 recall loss.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np


def binary_prf(labels: np.ndarray, preds: np.ndarray) -> Tuple[float, float, float]:
    labels = np.asarray(labels).astype(np.int64).ravel()
    preds = np.asarray(preds).astype(np.int64).ravel()
    tp = int(np.sum((preds == 1) & (labels == 1)))
    fp = int(np.sum((preds == 1) & (labels == 0)))
    fn = int(np.sum((preds == 0) & (labels == 1)))
    p = tp / (tp + fp) if (tp + fp) > 0 else 0.0
    r = tp / (tp + fn) if (tp + fn) > 0 else 0.0
    f1 = 2 * p * r / (p + r) if (p + r) > 0 else 0.0
    return p, r, f1


def prf_with_forced_misses(
    labels: np.ndarray,
    probs: np.ndarray,
    num_unpred_pairs: int,
) -> Tuple[float, float, float]:
    """Round probabilities (numpy's half-to-even, as the reference rounds its
    float32 sigmoid outputs, flagship :282), append forced misses, compute
    binary P/R/F1."""
    preds = np.round(np.asarray(probs)).astype(np.int64)
    labels = np.asarray(labels).astype(np.int64)
    if num_unpred_pairs > 0:
        labels = np.concatenate([labels, np.ones(num_unpred_pairs, np.int64)])
        preds = np.concatenate([preds, np.zeros(num_unpred_pairs, np.int64)])
    return binary_prf(labels, preds)


def prf_2nd_step(
    pair_id_all: Sequence[int],
    pair_id: Sequence[int],
    pred_y: Sequence[int],
) -> Tuple[float, float, float, float, float, float, float]:
    """Second-step pair-filtering metric (data_process.py:162-212).

    pair ids encode doc*10000 + emotion*100 + cause. Returns
    (p, r, f1, o_p, o_r, o_f1, keep_rate): the filtered metrics over pairs
    the classifier kept (pred_y truthy) and the unfiltered ("o_") metrics
    over all candidates, with the reference's 1e-8 smoothing.
    """
    pair_id_filtered = [pid for pid, y in zip(pair_id, pred_y) if y]
    keep_rate = len(pair_id_filtered) / (len(pair_id) + 1e-8)
    s1, s2, s3 = set(pair_id_all), set(pair_id), set(pair_id_filtered)
    o_acc = len(s1 & s2)
    acc = len(s1 & s3)
    o_p = o_acc / (len(s2) + 1e-8)
    o_r = o_acc / (len(s1) + 1e-8)
    p = acc / (len(s3) + 1e-8)
    r = acc / (len(s1) + 1e-8)
    f1 = 2 * p * r / (p + r + 1e-8)
    o_f1 = 2 * o_p * o_r / (o_p + o_r + 1e-8)
    return p, r, f1, o_p, o_r, o_f1, keep_rate


def micro_prf(
    pred_y: np.ndarray,
    true_y: np.ndarray,
    doc_len: np.ndarray,
    labels=(0, 1, 2, 3, 4, 5),
) -> Tuple[float, float, float]:
    """Stage-1 micro-averaged P/R/F1 over the clauses of each document (up
    to doc_len), over the classes in ``labels`` (acc_prf,
    data_process.py:149-159): the null class 6 is left out, so P, R and F1
    differ as sklearn's labels=[0..5] micro average makes them."""
    flat_p, flat_t = [], []
    for i in range(len(doc_len)):
        d = int(doc_len[i])
        flat_p.extend(np.asarray(pred_y[i][:d]).tolist())
        flat_t.extend(np.asarray(true_y[i][:d]).tolist())
    flat_p = np.asarray(flat_p)
    flat_t = np.asarray(flat_t)
    label_set = list(set(labels))
    tp = sum(int(((flat_p == c) & (flat_t == c)).sum()) for c in label_set)
    pred_in = int(np.isin(flat_p, label_set).sum())
    true_in = int(np.isin(flat_t, label_set).sum())
    p = tp / pred_in if pred_in else 0.0
    r = tp / true_in if true_in else 0.0
    f1 = 2 * p * r / (p + r) if (p + r) > 0 else 0.0
    return p, r, f1
