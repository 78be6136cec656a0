"""Batched pair-inference API, port of carel_tpu/infer/pair_inference.py.

Equivalent of pair_inference.py (:135-200): with a trained checkpoint loaded
into the model, score every candidate pair of a domain file, report binary
P/R/F1 (with the forced-miss padding for emotions stage 1 missed), and
persist true/pred tables (pandas pickles, consumable like the reference's
pair_data/ec_pair/{id}_{true,pred}.pkl by the CIT classifier).

Latency: scoring runs in fixed-size batches; per-batch p50/p95 are reported.
Each batch's time runs from the host batch to its probabilities on the host:
the ``.cpu()`` fetch is the synchronisation. Under a mesh (``mesh``, as at
carel_tpu/infer/pair_inference.py:46-59) each rank feeds its rows of every
batch and gets the whole batch's probabilities.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from carel_tpu_torch.data.batching import PairArrays, cut_batch
from carel_tpu_torch.data.pairs import PairSet
from carel_tpu_torch.parallel.sharding import shard_batch
from carel_tpu_torch.train.metrics import prf_with_forced_misses
from carel_tpu_torch.train.steps import batch_to_device
from carel_tpu_torch.utils.profiling import span


@dataclass
class InferenceResult:
    precision: float
    recall: float
    f1: float
    probs: np.ndarray
    preds: np.ndarray
    p50_batch_ms: float
    p95_batch_ms: float
    pairs_per_sec: float


def score_pairs(
    eval_step: Callable,
    model: torch.nn.Module,
    arrays: PairArrays,
    generator: torch.Generator,
    batch_size: int = 512,
    mesh=None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Probabilities over all pairs + per-batch wall times (seconds).
    Spans, per batch: ``score_pairs.cut_batch``, ``.to_device`` (the
    ``copies`` made), ``.forward`` (the eval step's enqueue) and
    ``.fetch``."""
    device = next(model.parameters()).device
    n = len(arrays)
    probs = np.zeros(n, np.float32)
    times = []
    for start in range(0, n, batch_size):
        idx = np.arange(start, min(start + batch_size, n))
        with span("score_pairs.cut_batch"):
            host = cut_batch(arrays, idx, batch_size).as_dict()
            if mesh is not None:
                host = shard_batch(mesh, host)
        t0 = time.perf_counter()
        with span("score_pairs.to_device", copies=len(host)):
            batch = batch_to_device(host, device)
        with span("score_pairs.forward"):
            out = eval_step(model, batch, generator)
        with span("score_pairs.fetch"):
            p = out.cpu().numpy()
        times.append(time.perf_counter() - t0)
        probs[idx] = p[: len(idx)]
    return probs, np.asarray(times)


def run_pair_inference(
    eval_step: Callable,
    model: torch.nn.Module,
    pair_set: PairSet,
    arrays: PairArrays,
    generator: Optional[torch.Generator] = None,
    batch_size: int = 512,
    output_dir: str = "",
    model_id: str = "model",
    mesh=None,
) -> InferenceResult:
    """Score ``arrays`` (the encoding of ``pair_set``) with ``model`` where
    it lies. The sampling noise comes from ``generator`` (default: a new one
    on the model's device, seeded 0)."""
    if generator is None:
        device = next(model.parameters()).device
        generator = torch.Generator(device=device).manual_seed(0)
    probs, times = score_pairs(eval_step, model, arrays, generator,
                               batch_size, mesh)
    preds = np.round(probs).astype(np.int64)
    p, r, f1 = prf_with_forced_misses(
        arrays.pair_labels, probs, pair_set.num_unpred_emotions)

    if output_dir:
        import pandas as pd

        os.makedirs(output_dir, exist_ok=True)
        base = {
            "pair": pair_set.pairs,
            "emotion": [e.emotion for e in pair_set.examples],
        }
        true_df = pd.DataFrame({**base, "label": pair_set.labels})
        pred_df = pd.DataFrame({**base, "label": preds.tolist()})
        true_df.to_pickle(os.path.join(output_dir, f"{model_id}_true.pkl"))
        pred_df.to_pickle(os.path.join(output_dir, f"{model_id}_pred.pkl"))

    # exclude the first batch (warm-up: kernel build and library start-up)
    # from latency/throughput stats
    lat = times[1:] if len(times) > 1 else times
    steady_pairs = len(arrays) - batch_size if len(times) > 1 else len(arrays)
    return InferenceResult(
        precision=p, recall=r, f1=f1, probs=probs, preds=preds,
        p50_batch_ms=float(np.percentile(lat, 50) * 1e3),
        p95_batch_ms=float(np.percentile(lat, 95) * 1e3),
        pairs_per_sec=float(max(steady_pairs, 1) / max(lat.sum(), 1e-9)),
    )
