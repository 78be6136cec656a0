"""Two-checkpoint case analysis (MMD vs no-MMD); port of
carel_tpu/tools/case_analysis.py.

Scores the target test set with two trained checkpoints, splits the pairs
into self-chain and normal ones, and writes a per-pair comparison CSV
(pair text, gold label, each model's prediction, self-chain flag). As in
JAX, one seeded pass replaces the reference's resampling of its unseeded
stochastic evaluation: both models score through one evaluation step,
drawing their noise from one generator (model a first), or through the
deterministic mean-latent step (``make_eval_step(sample=False)``).
"""

from __future__ import annotations

import csv
from dataclasses import dataclass
from typing import Callable, Dict, Optional

import numpy as np
import torch

from carel_tpu_torch.data.batching import PairArrays
from carel_tpu_torch.data.pairs import PairSet
from carel_tpu_torch.data.self_chain import self_chain_doc_ids
from carel_tpu_torch.infer.pair_inference import score_pairs
from carel_tpu_torch.train.metrics import prf_with_forced_misses


@dataclass
class CaseAnalysisResult:
    model_a_f1: float
    model_b_f1: float
    csv_path: str
    self_chain_counts: dict  # {"<a>_correct", "<b>_correct", "total"}
    normal_counts: dict
    # binary F1 over the pair file without the forced-miss penalty, overall
    # and per split (the protocol behind the reference's acceptance gates)
    split_f1: Optional[dict] = None


def _binary_f1(labels: np.ndarray, preds: np.ndarray) -> float:
    tp = int(((labels == 1) & (preds == 1)).sum())
    fp = int(((labels == 0) & (preds == 1)).sum())
    fn = int(((labels == 1) & (preds == 0)).sum())
    return 2 * tp / (2 * tp + fp + fn) if tp else 0.0


def compare_checkpoints(
    eval_step: Callable,
    model: torch.nn.Module,
    params_a: Dict[str, torch.Tensor],
    params_b: Dict[str, torch.Tensor],
    pair_set: PairSet,
    arrays: PairArrays,
    docs,
    out_csv: str,
    generator: Optional[torch.Generator] = None,
    batch_size: int = 512,
    label_a: str = "mmd",
    label_b: str = "wommd",
) -> CaseAnalysisResult:
    """``params_a`` and ``params_b`` (state_dicts, e.g. two
    ``checkpoint.load_best``) are loaded into ``model`` in turn and score
    every pair; ``generator`` (seeded 0 on the model's device by default)
    feeds both evaluations."""
    if generator is None:
        device = next(model.parameters()).device
        generator = torch.Generator(device=device).manual_seed(0)
    model.load_state_dict(params_a)
    probs_a, _ = score_pairs(eval_step, model, arrays, generator, batch_size)
    model.load_state_dict(params_b)
    probs_b, _ = score_pairs(eval_step, model, arrays, generator, batch_size)
    preds_a = np.round(probs_a).astype(int)
    preds_b = np.round(probs_b).astype(int)
    labels = arrays.pair_labels.astype(int)

    chain_ids = set(self_chain_doc_ids(docs))
    is_chain = np.asarray([
        docs[e.doc_index].doc_id in chain_ids and e.emo_sen_id == e.cau_sen_id
        for e in pair_set.examples])

    f1_a = prf_with_forced_misses(labels, probs_a,
                                  pair_set.num_unpred_emotions)[2]
    f1_b = prf_with_forced_misses(labels, probs_b,
                                  pair_set.num_unpred_emotions)[2]

    with open(out_csv, "w", newline="", encoding="utf8") as f:
        w = csv.writer(f)
        w.writerow(["pair", "label", f"{label_a}_pred", f"{label_b}_pred",
                    "self_chain"])
        for i, ex in enumerate(pair_set.examples):
            w.writerow([ex.pair, labels[i], preds_a[i], preds_b[i],
                        int(is_chain[i])])

    def counts(mask):
        return {
            f"{label_a}_correct": int((preds_a[mask] == labels[mask]).sum()),
            f"{label_b}_correct": int((preds_b[mask] == labels[mask]).sum()),
            "total": int(mask.sum()),
        }

    def split_f1s(mask):
        return {f"{label_a}_f1": round(_binary_f1(labels[mask],
                                                  preds_a[mask]), 4),
                f"{label_b}_f1": round(_binary_f1(labels[mask],
                                                  preds_b[mask]), 4)}

    all_mask = np.ones(len(labels), bool)
    return CaseAnalysisResult(
        model_a_f1=f1_a, model_b_f1=f1_b, csv_path=out_csv,
        self_chain_counts=counts(is_chain),
        normal_counts=counts(~is_chain),
        split_f1={"overall": split_f1s(all_mask),
                  "self_chain": split_f1s(is_chain),
                  "normal": split_f1s(~is_chain)},
    )
