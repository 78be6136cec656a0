"""The port's self-training against the JAX package's, on the CPU.

- ``generate_self_train_pairs``: the same PairSet, probabilities and
  ``np.random.default_rng(seed)`` go to both packages, for every strategy
  and each beyond-reference knob, over documents that include empty ones and
  beyond-window pairs the model believes in (hard negatives). The pseudo
  sets must be identical, example for example and in order, and both
  generators must have drawn the same numbers.
- ``self_train``: both packages' loops run with ``evaluate`` and
  ``train_epochs`` replaced by a fixed script of probabilities and F1s. The
  pseudo sets of every iteration, the log events and the returned best must
  be identical (the port's events add host seconds, which are left out of
  the comparison).
"""

import dataclasses

import numpy as np
import pytest
import torch

import carel_tpu.selftrain.driver as j_driver
from carel_tpu.config import CarelConfig as JCarelConfig
from carel_tpu.config import SelfStrategy as JSelfStrategy
from carel_tpu.config import TrainConfig as JTrainConfig
from carel_tpu.data.pairs import PairExample as JPairExample
from carel_tpu.data.pairs import PairSet as JPairSet
from carel_tpu.selftrain.strategies import (
    generate_self_train_pairs as j_generate,
)

import carel_tpu_torch.selftrain.driver as t_driver
from carel_tpu_torch.config import CarelConfig, SelfStrategy, TrainConfig
from carel_tpu_torch.data.pairs import PairExample, PairSet
from carel_tpu_torch.selftrain import generate_self_train_pairs

STRATEGIES = [s.value for s in SelfStrategy]
KNOBS = {
    "reference": {},
    "no_round_up": dict(round_up=False),
    "conf_margin": dict(conf_margin=0.15),
    "conf_keep": dict(conf_keep=0.5),
    "pairs_per_doc": dict(pairs_per_doc=2),
    "max_dist": dict(max_dist=2),
}


def _docs(seed=0, n_docs=30):
    """(pair_sizes, example fields) of a target-domain test set: documents
    of 0-12 candidate pairs with their sentence ids and temporal order."""
    rng = np.random.default_rng(seed)
    sizes, rows = [], []
    for doc in range(n_docs):
        size = 0 if doc % 9 == 4 else int(rng.integers(1, 13))
        sizes.append(size)
        n_sent = int(rng.integers(3, 13))
        for _ in range(size):
            emo, cau = (int(v) for v in rng.integers(1, n_sent + 1, 2))
            rows.append(dict(pair=f"d{doc}e{emo}c{cau}[SEP]{len(rows)}",
                             label=int(rng.random() < 0.3),
                             emotion=int(rng.integers(0, 6)),
                             temporal_order=cau <= emo, doc_index=doc,
                             emo_sen_id=emo, cau_sen_id=cau))
    return sizes, rows


def _pair_sets(sizes, rows):
    t = PairSet([PairExample(**r) for r in rows], list(sizes))
    j = JPairSet([JPairExample(**r) for r in rows], list(sizes))
    return t, j


def _probs(n, seed):
    rng = np.random.default_rng(seed)
    p = rng.random(n)
    p[rng.random(n) < 0.2] = 0.5  # ties, and values rounding half to even
    p[rng.random(n) < 0.1] = 0.97
    return p.astype(np.float32)


def _rows(pair_set):
    return [dataclasses.asdict(e) for e in pair_set.examples]


@pytest.mark.parametrize("knob", list(KNOBS))
@pytest.mark.parametrize("strategy", STRATEGIES)
def test_generate_self_train_pairs_matches_jax(strategy, knob):
    sizes, rows = _docs()
    t_set, j_set = _pair_sets(sizes, rows)
    iterations = (0, 1, 3) if strategy == "temporal_order_modification" \
        else (0,)
    for it in iterations:
        probs = _probs(len(rows), seed=10 + it)
        t_rng, j_rng = np.random.default_rng(7), np.random.default_rng(7)
        got = generate_self_train_pairs(t_set, probs, SelfStrategy(strategy),
                                        iteration=it, rng=t_rng,
                                        **KNOBS[knob])
        want = j_generate(j_set, probs, JSelfStrategy(strategy),
                          iteration=it, rng=j_rng, **KNOBS[knob])
        assert len(want) > 0
        assert _rows(got) == _rows(want), (strategy, knob, it)
        assert got.docs_pair_size == want.docs_pair_size
        assert t_rng.integers(1 << 30) == j_rng.integers(1 << 30)
    if knob == "max_dist":  # hard negatives were emitted as singletons
        assert 1 in got.docs_pair_size


class _Records:
    def __init__(self):
        self.records = []

    def log(self, record):
        self.records.append(record)


_SECONDS = ("eval_seconds", "pseudo_seconds", "train_seconds")


def _script(monkeypatch, module, eval_result, probs_seq, f1_seq):
    """Replace the self-training module's evaluate and train_epochs by a
    script: the i-th evaluation returns probs_seq[i], the i-th fine-tune
    returns F1 f1_seq[i] and records what it was given."""
    calls = {"eval": 0, "train": []}

    def evaluate(*args, **kwargs):
        probs = probs_seq[calls["eval"]]
        calls["eval"] += 1
        return eval_result(0.0, 0.0, 0.0, probs)

    def train_epochs(cfg, state, train_step, eval_step, arrays, *args, **kw):
        calls["train"].append((arrays, kw["best_f1_so_far"],
                               kw["data_rng"].integers(1 << 30),
                               kw["epochs"]))
        f1 = f1_seq[len(calls["train"]) - 1]
        return state, (f1 / 2, f1 / 3, f1)

    monkeypatch.setattr(module, "evaluate", evaluate)
    monkeypatch.setattr(module, "train_epochs", train_epochs)
    return calls


@pytest.mark.parametrize("strategy,anchor", [
    ("random", None), ("temporal_order_modification", None),
    ("threshold", (0.5, 0.5, 0.45))])
def test_self_train_matches_jax(monkeypatch, strategy, anchor):
    from carel_tpu.train.loop import EvalResult as JEvalResult

    from carel_tpu_torch.train.loop import EvalResult

    sizes, rows = _docs(seed=3)
    t_set, j_set = _pair_sets(sizes, rows)
    probs_seq = [_probs(len(rows), seed=20 + i) for i in range(4)]
    probs_seq[2] = np.full(len(rows), 0.25, np.float32)  # threshold: empty
    f1_seq = [0.3, 0.6, 0.4, 0.7]
    kw = dict(self_iteration=4, self_epochs=3, seed=5,
              self_strategy=strategy)
    t_cfg = CarelConfig(train=TrainConfig(
        **{**kw, "self_strategy": SelfStrategy(strategy)}))
    j_cfg = JCarelConfig(train=JTrainConfig(
        **{**kw, "self_strategy": JSelfStrategy(strategy)}))

    runs = {}
    for name, module, cfg, pair_set, result, state in (
            ("port", t_driver, t_cfg, t_set, EvalResult,
             type("S", (), {"model": torch.nn.Linear(1, 1)})()),
            ("jax", j_driver, j_cfg, j_set, JEvalResult,
             type("S", (), {"params": None})())):
        calls = _script(monkeypatch, module, result, probs_seq, f1_seq)
        logger = _Records()
        _, best = module.self_train(
            cfg, state, None, None, pair_set, None, 0, lambda s: s, "m",
            logger=logger, track_memorization=True, best_cache={},
            initial_best=anchor)
        events = [{k: v for k, v in r.items() if k not in _SECONDS}
                  for r in logger.records]
        train = [(_rows(a), b, r, e) for a, b, r, e in calls["train"]]
        runs[name] = (best, events, train, calls["eval"])

    assert runs["port"] == runs["jax"]
    best, events, train, evals = runs["port"]
    assert evals == 4 and len(train) >= 2
    names = [e["event"] for e in events]
    assert names.count("selftrain_best") == len(train)
    assert "memorization" in names
    assert best[2] == max([(anchor or (0, 0, 0))[2], *f1_seq[:len(train)]])
    if strategy == "threshold":
        assert "selftrain_empty" in names and len(train) == 3
