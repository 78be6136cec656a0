"""Training and evaluation loops, port of carel_tpu/train/loop.py.

Host-side orchestration around the steps: epoch/batch iteration with fixed
shapes, per-epoch eval with forced-miss padding, best-F1 checkpointing,
full-state snapshots every ``save_state_every`` epochs and the unconditional
reload of the best at the end (train(), flagship :802-922). ``train_epochs``
takes either kind of step, as the JAX loop does: the whole-epoch step of
train/scan_epoch.py (the default, a captured CUDA-graph step replayed over
the stacked epoch on the card) or the per-step one of train/steps.py, fed
by data/prefetch.py.

Under a mesh (``mesh``) every rank takes its rows of each batch and of the
stacked epoch (``parallel/sharding.py``); the model gathers its latents, so
the evaluation's probabilities come back for the whole batch, in row order,
on every rank, and every rank takes the same branch at every best-F1 test.
Only ``mesh.rank`` 0 logs (the caller hands the others a silent logger) and
writes the best checkpoint, whose parameters are whole (split ones gathered
over 'model'), so that it loads on any mesh or none; every rank reloads the
best.

Parity note on KL annealing: the reference's annealing counter is the
*within-epoch* batch index (`enumerate(train_loader)`, flagship :822), so
with T=20000 the KL weight stays at its floor; the loop passes the batch
index, not the global step.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from carel_tpu_torch.config import CarelConfig
from carel_tpu_torch.data.batching import PairArrays, cut_batch, iter_batches
from carel_tpu_torch.data.prefetch import prefetch_to_device
from carel_tpu_torch.parallel.sharding import shard_batch, shard_stacked
from carel_tpu_torch.train import checkpoint as ckpt
from carel_tpu_torch.train.logging import JsonlLogger
from carel_tpu_torch.train.metrics import prf_with_forced_misses
from carel_tpu_torch.train.scan_epoch import stack_epoch
from carel_tpu_torch.train.state import TrainState
from carel_tpu_torch.train.steps import batch_to_device
from carel_tpu_torch.utils.profiling import span


@dataclasses.dataclass
class EvalResult:
    precision: float
    recall: float
    f1: float
    probs: np.ndarray  # [N] probabilities over the real test rows


def _device_of(model: torch.nn.Module) -> torch.device:
    return next(model.parameters()).device


def evaluate(
    eval_step: Callable,
    model: torch.nn.Module,
    test_arrays: PairArrays,
    num_unpred_pairs: int,
    generator: torch.Generator,
    batch_size: int = 512,
    mesh=None,
) -> EvalResult:
    """Batched full-test-set evaluation (the reference uses one giant batch,
    flagship :957-961; fixed-size batches with masked tails are
    equivalent). Under a mesh each rank feeds its rows of each batch and
    gets the whole batch's probabilities."""
    n = len(test_arrays)
    with span("evaluate", pairs=n):
        device = _device_of(model)
        parts = []
        for start in range(0, n, batch_size):
            idx = np.arange(start, min(start + batch_size, n))
            host = cut_batch(test_arrays, idx, batch_size).as_dict()
            if mesh is not None:
                host = shard_batch(mesh, host)
            batch = batch_to_device(host, device)
            parts.append(eval_step(model, batch, generator)[: len(idx)])
        probs = torch.cat(parts).cpu().numpy() if parts else \
            np.zeros(0, np.float32)
        p, r, f1 = prf_with_forced_misses(test_arrays.pair_labels, probs,
                                          num_unpred_pairs)
        return EvalResult(p, r, f1, probs)


def train_epochs(
    cfg: CarelConfig,
    state: TrainState,
    train_step: Callable,
    eval_step: Callable,
    train_arrays: PairArrays,
    test_arrays: PairArrays,
    num_unpred_pairs: int,
    model_id: str,
    epochs: Optional[int] = None,
    logger: Optional[JsonlLogger] = None,
    data_rng: Optional[np.random.Generator] = None,
    best_f1_so_far: float = 0.0,
    best_cache: Optional[dict] = None,
    mesh=None,
) -> Tuple[TrainState, Tuple[float, float, float]]:
    """Epoch loop with per-epoch eval and best-F1 checkpointing. Every step
    of epoch ``epoch`` gets vi_beta = min((epoch - 1) * vi_beta_step, 1)
    (vi_final :772-777), which only the vi step reads. ``train_step`` is an
    epoch step (``is_epoch_step``: the losses of one epoch fetched once,
    one train record an epoch) or a per-step one (prefetched batches, a
    train record every 10 steps). With ``save_state_every`` the full state
    is saved every that many epochs.

    Returns the state with the BEST params reloaded (the reference reloads
    the best checkpoint after training, flagship :916-917).

    best_cache: optional dict (shared across calls) that keeps a device copy
    of the best params, so the reload skips the disk round trip; the file on
    disk stays the source of truth for crash recovery.
    """
    model = state.model
    device = _device_of(model)
    logger = logger or JsonlLogger(echo=False)
    data_rng = data_rng or np.random.default_rng(cfg.train.seed)
    epochs = epochs if epochs is not None else cfg.train.epochs
    eval_gen = torch.Generator(device=device).manual_seed(cfg.train.seed + 7)

    best = (0.0, 0.0, best_f1_so_far)
    saved_any = False
    t_start = time.time()
    examples_seen = 0

    for epoch in range(1, epochs + 1):
        t_epoch = time.time()
        vi_beta = min((epoch - 1) * cfg.loss.vi_beta_step, 1.0)
        if getattr(train_step, "is_epoch_step", False):
            stacked = stack_epoch(train_arrays, cfg.train.batch_size,
                                  rng=data_rng)
            if mesh is not None:
                stacked = shard_stacked(mesh, stacked)
            losses = train_step.fetch(train_step(state, stacked, vi_beta))
            event = {"event": "train", "epoch": epoch, "it": len(losses),
                     "loss": float(losses.mean()), "losses": losses.tolist()}
            if train_step.moe_counts:
                event["moe"] = train_step.moe_counts
            logger.log(event)
        else:
            pending = []  # device scalars; fetched every 10 steps

            def transform(b):
                host = b.as_dict()
                return host if mesh is None else shard_batch(mesh, host)

            batches = prefetch_to_device(
                iter_batches(train_arrays, cfg.train.batch_size,
                             shuffle=True, rng=data_rng),
                size=2, transform=transform, device=device)
            for it, batch in enumerate(batches):
                metrics = train_step(state, batch, it, vi_beta)
                pending.append(metrics["loss"])
                if it % 10 == 9:
                    running = float(torch.stack(pending).sum())
                    logger.log({"event": "train", "epoch": epoch,
                                "it": it + 1,
                                "loss": running / len(pending)})
                    pending = []
        examples_seen += len(train_arrays)

        res = evaluate(eval_step, model, test_arrays, num_unpred_pairs,
                       eval_gen, cfg.train.eval_batch_size, mesh)
        logger.log({
            "event": "eval", "epoch": epoch,
            "precision": res.precision, "recall": res.recall, "f1": res.f1,
            "epoch_seconds": time.time() - t_epoch,
            "examples_per_sec": examples_seen / max(time.time() - t_start,
                                                    1e-9),
        })

        if res.f1 > best[2]:
            best = (res.precision, res.recall, res.f1)
            ckpt.save_best_of(cfg.train.checkpoint_dir, model_id, model,
                              mesh)
            saved_any = True
            if best_cache is not None:
                best_cache["state_dict"] = {
                    k: v.detach().clone() for k, v in
                    model.state_dict().items()}
            logger.log({"event": "best", "epoch": epoch, "f1": res.f1})

        if (cfg.train.save_state_every
                and epoch % cfg.train.save_state_every == 0):
            ckpt.save_state(cfg.train.checkpoint_dir, model_id, state, mesh)
            logger.log({"event": "state_snapshot", "epoch": epoch,
                        "step": state.step})

    # The reference reloads the best checkpoint UNCONDITIONALLY at the end of
    # every train() call (flagship :916-917), also when this call saved
    # nothing; self-training generates each iteration's pseudo-labels from
    # the best-so-far model.
    if best_cache is not None and best_cache.get("state_dict") is not None:
        model.load_state_dict(best_cache["state_dict"])
    elif saved_any or os.path.exists(
            ckpt.best_path(cfg.train.checkpoint_dir, model_id)):
        ckpt.load_best_into(cfg.train.checkpoint_dir, model_id, model, mesh)
    return state, best
