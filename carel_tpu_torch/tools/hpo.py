"""Hyperparameter search over CarelConfig; port of carel_tpu/tools/hpo.py
(host only).

Random search with median-rule early stopping (optuna's MedianPruner
semantics, without optuna), maximizing best pair-F1. The objective is any
callable (CarelConfig, report_fn) -> float; report_fn(step, value) feeds
the pruner. Trials draw from ``random.Random(seed)``, so a seed repeats the
JAX package's trial sequence.
"""

from __future__ import annotations

import dataclasses
import math
import random
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

from carel_tpu_torch.config import CarelConfig


class TrialPruned(Exception):
    pass


@dataclass
class Trial:
    number: int
    params: Dict
    value: Optional[float] = None
    pruned: bool = False
    intermediate: List[Tuple[int, float]] = field(default_factory=list)


@dataclass
class SearchSpace:
    """Log-uniform / uniform / categorical dims keyed by a dotted config path
    (e.g. 'loss.mmd_loss_weight')."""

    log_uniform: Dict[str, Tuple[float, float]] = field(default_factory=dict)
    uniform: Dict[str, Tuple[float, float]] = field(default_factory=dict)
    categorical: Dict[str, list] = field(default_factory=dict)

    def sample(self, rng: random.Random) -> Dict:
        out = {}
        for k, (lo, hi) in self.log_uniform.items():
            out[k] = math.exp(rng.uniform(math.log(lo), math.log(hi)))
        for k, (lo, hi) in self.uniform.items():
            out[k] = rng.uniform(lo, hi)
        for k, choices in self.categorical.items():
            out[k] = rng.choice(choices)
        return out


def apply_params(cfg: CarelConfig, params: Dict) -> CarelConfig:
    for path, value in params.items():
        parts = path.split(".")
        section = getattr(cfg, parts[0])
        section = dataclasses.replace(section, **{parts[1]: value})
        cfg = dataclasses.replace(cfg, **{parts[0]: section})
    return cfg


DEFAULT_SPACE = SearchSpace(
    log_uniform={
        "loss.mmd_loss_weight": (1.0, 100.0),
        "loss.emo_mul_loss_weight": (1.0, 30.0),
        "loss.cau_mul_loss_weight": (1.0, 30.0),
        "loss.pair_mul_loss_weight": (5.0, 100.0),
        "train.vae_lr": (1e-6, 1e-4),
    },
)


class MedianPruner:
    """Prune a trial whose intermediate value is below the median of other
    trials' values at the same step (optuna MedianPruner semantics)."""

    def __init__(self, n_warmup_trials: int = 5):
        self.n_warmup_trials = n_warmup_trials
        self.history: Dict[int, List[float]] = {}

    def report(self, trial: Trial, step: int, value: float) -> None:
        trial.intermediate.append((step, value))
        past = self.history.get(step, [])
        if len(past) >= self.n_warmup_trials:
            med = sorted(past)[len(past) // 2]
            if value < med:
                self.history.setdefault(step, []).append(value)
                raise TrialPruned()
        self.history.setdefault(step, []).append(value)


def search(
    objective: Callable[[CarelConfig, Callable[[int, float], None]], float],
    base_cfg: CarelConfig,
    space: SearchSpace = DEFAULT_SPACE,
    n_trials: int = 100,
    seed: int = 42,
    logger=None,
) -> Tuple[Trial, List[Trial]]:
    """Maximize objective; returns (best trial, all trials)."""
    rng = random.Random(seed)
    pruner = MedianPruner()
    trials: List[Trial] = []
    best: Optional[Trial] = None
    for i in range(n_trials):
        params = space.sample(rng)
        trial = Trial(number=i, params=params)
        cfg = apply_params(base_cfg, params)
        try:
            value = objective(
                cfg, lambda step, v, t=trial: pruner.report(t, step, v))
            trial.value = value
        except TrialPruned:
            trial.pruned = True
        trials.append(trial)
        if trial.value is not None and (
                best is None or trial.value > best.value):
            best = trial
        if logger:
            logger.log({"event": "hpo_trial", "number": i,
                        "value": trial.value, "pruned": trial.pruned,
                        "params": params})
    return best, trials
