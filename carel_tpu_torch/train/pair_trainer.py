"""Plain (non-VAE) pair classifier trainer, port of
carel_tpu/train/pair_trainer.py.

Covers the reference's pair_classifier.py (:235-396, hyperparams :399-408:
Adam 1e-5, dropout 0.1, plain BCEWithLogits, threshold self-training) and
pair_classifier_self_chain.py (sentence-pair encoding + self-chain test
reader). As in JAX:

- the loss is the masked mean BCE of the logits;
- batches are drawn by ``numpy.default_rng(seed)`` and the self-training
  pseudo sets by ``default_rng(seed + 1)``: the same draws in both packages;
- each epoch ends with an evaluation; the best params (by pair-F1) are kept;
- each self-training iteration predicts with the best params and fine-tunes
  from them, carrying the optimizer state on (the reference's train() ends
  with an unconditional best-checkpoint reload, pair_classifier.py:386).

One eager step a batch, as JAX's per-step ``jit``: there is no captured
epoch here, because JAX has none. The Adam is torch's fused capturable
Adam on CUDA (its lr a device tensor), the default on the CPU. Dropout
draws from the device's default generator, seeded from ``seed`` before the
first step.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from carel_tpu_torch.config import EncoderConfig, SelfStrategy
from carel_tpu_torch.data.batching import PairArrays, cut_batch, iter_batches
from carel_tpu_torch.data.pairs import PairSet
from carel_tpu_torch.device import resolve_device
from carel_tpu_torch.models.encoder import init_flax_
from carel_tpu_torch.models.pair_classifier import PairClassifier
from carel_tpu_torch.selftrain.strategies import generate_self_train_pairs
from carel_tpu_torch.train.logging import JsonlLogger
from carel_tpu_torch.train.metrics import prf_with_forced_misses
from carel_tpu_torch.train.state import adam
from carel_tpu_torch.train.steps import batch_to_device


@dataclass(frozen=True)
class PairTrainerConfig:
    max_len: int = 128
    batch_size: int = 64
    epochs: int = 10
    self_epochs: int = 10
    self_iteration: int = 30
    learning_rate: float = 1e-5
    dropout: float = 0.1
    self_strategy: SelfStrategy = SelfStrategy.THRESHOLD
    eval_batch_size: int = 512
    seed: int = 42


def masked_bce(logits: torch.Tensor, labels: torch.Tensor,
               mask: torch.Tensor) -> torch.Tensor:
    """Mean over the real rows of BCE-with-logits (JAX's stable form)."""
    x = logits[:, 0].float()
    per = torch.clamp_min(x, 0) - x * labels + torch.log1p(
        torch.exp(-torch.abs(x)))
    return (per * mask).sum() / torch.clamp_min(mask.sum(), 1.0)


def build_pair_trainer(cfg: PairTrainerConfig, encoder_cfg: EncoderConfig,
                       device, params: Optional[Dict[str, torch.Tensor]] = None):
    """(model, optimizer, train_step, eval_step) for the plain classifier
    on ``device``: Flax-style random init from ``cfg.seed``, or ``params``
    (a state_dict, e.g. JAX's converted by convert.py)."""
    device = torch.device(device)
    torch.manual_seed(cfg.seed)
    model = PairClassifier(encoder_cfg, cfg.dropout)
    if params is None:
        init_flax_(model, torch.Generator().manual_seed(cfg.seed))
    else:
        model.load_state_dict(params)
    model.to(device)
    optimizer = adam(list(model.parameters()), cfg.learning_rate, device)

    def train_step(batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        optimizer.zero_grad(set_to_none=True)
        logits = model(batch["input_ids"], batch["attention_mask"],
                       batch["token_type_ids"], deterministic=False)
        loss = masked_bce(logits, batch["pair_labels"],
                          batch["example_mask"])
        loss.backward()
        optimizer.step()
        return loss.detach()

    @torch.no_grad()
    def eval_step(batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        logits = model(batch["input_ids"], batch["attention_mask"],
                       batch["token_type_ids"], deterministic=True)
        return torch.sigmoid(logits[:, 0].float())

    return model, optimizer, train_step, eval_step


def _predict(eval_step, arrays: PairArrays, batch_size: int,
             device) -> np.ndarray:
    """Probabilities of every row of ``arrays`` in fixed-size batches (the
    tail padded), fetched once."""
    n = len(arrays)
    probs = []
    for s in range(0, n, batch_size):
        idx = np.arange(s, min(s + batch_size, n))
        batch = cut_batch(arrays, idx, batch_size).as_dict()
        probs.append(eval_step(batch_to_device(batch, device))[: len(idx)])
    return torch.cat(probs).cpu().numpy().astype(np.float32)


def _snapshot(model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def train_pair_classifier(
    cfg: PairTrainerConfig,
    encoder_cfg: EncoderConfig,
    train_arrays: PairArrays,
    test_arrays: PairArrays,
    num_unpred_pairs: int = 0,
    test_pairs: Optional[PairSet] = None,
    encode: Optional[Callable[[PairSet], PairArrays]] = None,
    logger: Optional[JsonlLogger] = None,
    device="cuda",
    params: Optional[Dict[str, torch.Tensor]] = None,
) -> Tuple[Dict[str, torch.Tensor], Tuple[float, float, float]]:
    """Base training + threshold self-training; returns (best params as a
    state_dict, best P/R/F1). Runs on ``device`` (the GPU unless "cpu" is
    asked for); ``params`` replaces the random init. Each epoch logs a
    "pair_eval" event: its P/R/F1 and the train steps it took."""
    device = resolve_device(device)
    logger = logger or JsonlLogger(echo=False)
    model, _, train_step, eval_step = build_pair_trainer(
        cfg, encoder_cfg, device, params)
    data_rng = np.random.default_rng(cfg.seed)

    best = (0.0, 0.0, 0.0)
    best_params = _snapshot(model)

    def run_epochs(arrays, epochs, best, best_params):
        for _ in range(epochs):
            steps = 0
            for batch in iter_batches(arrays, cfg.batch_size, rng=data_rng):
                train_step(batch_to_device(batch.as_dict(), device))
                steps += 1
            probs = _predict(eval_step, test_arrays, cfg.eval_batch_size,
                             device)
            prf = prf_with_forced_misses(test_arrays.pair_labels, probs,
                                         num_unpred_pairs)
            logger.log({"event": "pair_eval", "p": prf[0], "r": prf[1],
                        "f1": prf[2], "steps": steps})
            if prf[2] > best[2]:
                best, best_params = prf, _snapshot(model)
        return best, best_params

    best, best_params = run_epochs(train_arrays, cfg.epochs, best,
                                   best_params)

    if test_pairs is not None and encode is not None:
        st_rng = np.random.default_rng(cfg.seed + 1)
        for i in range(cfg.self_iteration):
            # each iteration predicts with, and fine-tunes FROM, the best
            # params; the optimizer state carries on
            model.load_state_dict(best_params)
            probs = _predict(eval_step, test_arrays, cfg.eval_batch_size,
                             device)
            pseudo = generate_self_train_pairs(
                test_pairs, np.round(probs), cfg.self_strategy,
                iteration=i, round_up=True, rng=st_rng)
            if len(pseudo) == 0:
                continue
            best, best_params = run_epochs(encode(pseudo), cfg.self_epochs,
                                           best, best_params)

    return best_params, best
