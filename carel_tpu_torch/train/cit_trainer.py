"""CIT (conditional-independence triple) classifier, end-to-end driver;
port of carel_tpu/train/cit_trainer.py.

Reproduces mc_classifier.py's full experiment (:442-547): train the triple
classifier on gold-pair triples with embedding-KNN negatives
(data/triples.build_cit_triples), test it as a FILTER over a pair
classifier's predictions (each predicted-positive pair "e[SEP]c" becomes the
triple "e[SEP]c[SEP]c"; the CIT verdict overwrites that pair's entry in the
prediction vector, :377-387), and report binary P/R/F1 of the refined
predictions against the true candidate labels. Self-training (:167-238,
:520-545) rebuilds triples from the current best predictions per document,
with per-document KNN negatives, for ``self_iteration`` rounds of
``self_epochs`` each.

The reference's CITClassifier (:65-82) is the PairClassifier (encoder
pooler, dropout, linear 768 -> 1), so the training machinery is the port's
train/pair_trainer.py: eager steps, one Adam. JAX's quirks are kept:

- clause indices come from the FIRST occurrence of a text
  (``texts.index``), and a self-chain pair conditions on the emotion clause;
- the evaluation triples and their indices are fixed from the original
  predictions; only the values written over them change;
- ``np.round`` of the probabilities rounds half to even;
- training carries on from the current params, not the best ones;
- with ``encoder_params`` the encoder takes them and the Adam starts anew
  (it always does here: the optimizer is built with the model).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from carel_tpu_torch.config import EncoderConfig
from carel_tpu_torch.data.batching import encode_pairs, iter_batches
from carel_tpu_torch.data.bow import BowVocab
from carel_tpu_torch.data.ecpe_format import Document
from carel_tpu_torch.data.pairs import PairExample, PairSet
from carel_tpu_torch.data.triples import _knn_index, predicted_triples
from carel_tpu_torch.device import resolve_device
from carel_tpu_torch.train.logging import JsonlLogger
from carel_tpu_torch.train.metrics import prf_with_forced_misses
from carel_tpu_torch.train.pair_trainer import (PairTrainerConfig, _predict,
                                                _snapshot, build_pair_trainer)
from carel_tpu_torch.train.steps import batch_to_device


@dataclass(frozen=True)
class CitConfig:
    # mc_classifier.py:445-450
    max_len: int = 128
    batch_size: int = 32
    epochs: int = 1
    self_epochs: int = 5
    self_iteration: int = 10
    learning_rate: float = 1e-5
    dropout: float = 0.1
    eval_batch_size: int = 512
    neighbor_rank: int = 2  # faiss [0][2]: 3rd nearest incl. the query
    seed: int = 42


def predicted_pair_triples(
    pair_texts: Sequence[str], predictions: np.ndarray
) -> Tuple[PairSet, List[int]]:
    """Triples for currently-predicted-positive pairs + their indices in the
    prediction vector (data/triples.predicted_triples)."""
    return predicted_triples((i, text, 6) for i, (text, lab) in
                             enumerate(zip(pair_texts, predictions))
                             if int(lab) == 1)


def selftrain_triples(
    docs: Sequence[Document],
    docs_pair_size: Sequence[int],
    pair_texts: Sequence[str],
    predictions: np.ndarray,
    embedder: Callable[[List[str]], np.ndarray],
    neighbor_rank: int = 2,
) -> PairSet:
    """Pseudo-labelled training triples from the current predictions
    (generate_self_train_data, mc_classifier.py:167-238): walk the test
    documents with the candidate-pair counts, and for every predicted-positive
    pair emit the positive triple plus a KNN-negative whose middle clause is
    the 3rd-nearest neighbour of the cause clause within the document.

    Reference quirks kept: clause indices are recovered by FIRST-occurrence
    text lookup (`sentence_list.index(...)`, :214, :224), and the self-chain
    case conditions on the emotion clause (:211-218)."""
    out = PairSet()
    curr = 0
    for doc_index, doc in enumerate(docs):
        n_pairs = docs_pair_size[doc_index] if doc_index < len(
            docs_pair_size) else 0
        texts = [(cl.text_field3 or cl.text).strip().replace(" ", "")
                 for cl in doc.clauses]
        emb = None
        n_added = 0
        for k in range(n_pairs):
            i = curr + k
            if i >= len(predictions) or int(predictions[i]) != 1:
                continue
            parts = str(pair_texts[i]).split("[SEP]")
            if len(parts) < 2:
                continue
            emo_text, cau_text = parts[0], parts[1]
            try:
                emo_idx = texts.index(emo_text)
                cau_idx = texts.index(cau_text)
            except ValueError:
                continue
            if emb is None:
                emb = np.asarray(embedder(texts))
            if emo_text == cau_text:
                nn = _knn_index(emb, emo_idx, neighbor_rank)
                pos = f"{emo_text}[SEP]{emo_text}[SEP]{emo_text}"
                neg = f"{emo_text}[SEP]{texts[nn]}[SEP]{emo_text}"
            else:
                nn = _knn_index(emb, cau_idx, neighbor_rank)
                pos = f"{emo_text}[SEP]{cau_text}[SEP]{cau_text}"
                neg = f"{emo_text}[SEP]{texts[nn]}[SEP]{cau_text}"
            out.examples.append(PairExample(
                pair=pos, label=1, emotion=6, temporal_order=True,
                doc_index=doc_index))
            out.examples.append(PairExample(
                pair=neg, label=0, emotion=6, temporal_order=True,
                doc_index=doc_index))
            n_added += 2
        out.docs_pair_size.append(n_added)
        curr += n_pairs
    return out


def run_cit(
    cfg: CitConfig,
    encoder_cfg: EncoderConfig,
    tokenizer,
    train_triples: PairSet,
    test_docs: Sequence[Document],
    docs_pair_size: Sequence[int],
    pair_texts: Sequence[str],
    pred_labels: np.ndarray,  # pair-classifier predictions over candidates
    true_labels: np.ndarray,  # gold labels over the same candidates
    embedder: Callable[[List[str]], np.ndarray],
    logger: Optional[JsonlLogger] = None,
    encoder_params: Optional[Dict[str, torch.Tensor]] = None,
    device="cuda",
    params: Optional[Dict[str, torch.Tensor]] = None,
) -> dict:
    """Train + self-train the CIT filter on ``device`` (the GPU unless
    "cpu" is asked for); returns the base and best refined P/R/F1, the best
    refined predictions and the best params (a state_dict). ``params`` (the
    whole classifier's state_dict) replaces the random init from
    ``cfg.seed``; ``encoder_params`` then replaces its encoder's. Each
    evaluation logs a "cit_<phase>_eval" event with the train steps taken
    since the last one."""
    device = resolve_device(device)
    logger = logger or JsonlLogger(echo=False)
    language = getattr(tokenizer, "language", "zh")
    bow = BowVocab.from_words([], language)

    def encode(ps):
        return encode_pairs(ps, tokenizer, bow, cfg.max_len)

    ptc = PairTrainerConfig(
        max_len=cfg.max_len, batch_size=cfg.batch_size, epochs=cfg.epochs,
        self_epochs=cfg.self_epochs, self_iteration=cfg.self_iteration,
        learning_rate=cfg.learning_rate, dropout=cfg.dropout,
        eval_batch_size=cfg.eval_batch_size, seed=cfg.seed)
    model, _, train_step, eval_step = build_pair_trainer(
        ptc, encoder_cfg, device, params)
    if encoder_params is not None:
        model.encoder.load_state_dict(encoder_params)

    data_rng = np.random.default_rng(cfg.seed)
    predictions = np.asarray(pred_labels, np.float32).copy()
    true_labels = np.asarray(true_labels, np.float32)
    best = {"p": 0.0, "r": 0.0, "f1": -1.0,
            "predictions": predictions.copy(), "params": _snapshot(model)}

    # the eval triple set and its indices are FIXED from the original
    # pair-classifier predictions (read_pair_data runs once,
    # mc_classifier.py:469-470); only the overwritten values evolve
    eval_triples, eval_indices = predicted_pair_triples(
        pair_texts, predictions)
    eval_arrays = encode(eval_triples) if eval_indices else None

    def evaluate(phase, iteration, steps):
        """CIT filters the prediction vector (mc_classifier.py:377-387)."""
        refined = predictions.copy()
        if eval_indices:
            probs = _predict(eval_step, eval_arrays, cfg.eval_batch_size,
                             device)
            refined[np.asarray(eval_indices)] = np.round(probs)
        p, r, f1 = prf_with_forced_misses(true_labels, refined, 0)
        logger.log({"event": f"cit_{phase}_eval", "iteration": iteration,
                    "p": p, "r": r, "f1": f1,
                    "n_triples": len(eval_indices), "steps": steps})
        if f1 > best["f1"]:
            best.update(p=p, r=r, f1=f1, predictions=refined,
                        params=_snapshot(model))

    def run_epochs(arrays, epochs, phase, it=0):
        for _ in range(epochs):
            steps = 0
            for batch in iter_batches(arrays, cfg.batch_size, rng=data_rng):
                train_step(batch_to_device(batch.as_dict(), device))
                steps += 1
            evaluate(phase, it, steps)

    run_epochs(encode(train_triples), cfg.epochs, "base")
    base = {"p": best["p"], "r": best["r"], "f1": best["f1"]}

    for it in range(1, cfg.self_iteration + 1):
        pseudo = selftrain_triples(
            test_docs, docs_pair_size, pair_texts, best["predictions"],
            embedder, cfg.neighbor_rank)
        if len(pseudo) == 0:
            logger.log({"event": "cit_selftrain_empty", "iteration": it})
            break
        logger.log({"event": "cit_selftrain", "iteration": it,
                    "n_triples": len(pseudo)})
        run_epochs(encode(pseudo), cfg.self_epochs, "self", it)

    return {"base": base,
            "best": {"p": best["p"], "r": best["r"], "f1": best["f1"]},
            "predictions": best["predictions"],
            "params": best["params"]}
