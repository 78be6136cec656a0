"""Clause-level DANN emotion-classifier driver, port of
carel_tpu/stage1/dann_driver.py.

Reproduces the full experiment of `emotion_classifier.py:448-553`: read the
source and target domain files into clause-level (sentence, label) sets
(:216-252), train the 7-class clause classifier with inverse-frequency
imbalanced sampling (:273, :499), evaluate micro-P/R/F1 over labels 0-5 on
the full target set each epoch (:388-392), then run `self_iteration`
self-training rounds where the WHOLE target set is pseudo-labelled by the
current best model (generate_self_train_data, :255-277; no confidence
threshold, unlike the doc-level stage 1) and becomes the training set.

`use_domain_loss` toggles between the reference's shipped recipe (False:
the domain term is commented out of its train loop, :279-288, 330-347) and
the full DANN objective (True, the default).

The best model is kept as a copy of its state_dict (params and running
statistics); each self-training iteration copies it back into the same
parameter tensors, so the one Adam of the run keeps its state (step count
included) across the base phase and every iteration, as in the reference.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from carel_tpu_torch.config import EncoderConfig
from carel_tpu_torch.data.ecpe_format import parse_ecpe_file
from carel_tpu_torch.device import resolve_device
from carel_tpu_torch.models.dann import (ClauseEmotionDANN, init_dann,
                                         predict_dann, train_dann)
from carel_tpu_torch.models.hf_port import load_encoder_checkpoint
from carel_tpu_torch.stage1.trainer import snapshot
from carel_tpu_torch.train.metrics import micro_prf


@dataclass(frozen=True)
class DannConfig:
    source_domain: str = "society"
    target_domain: str = "finance"
    doc_dir: str = "domains/THUCTC_multiple"
    epochs: int = 20  # epochs_num (emotion_classifier.py:467)
    self_iteration: int = 5  # :468
    self_epochs: int = 10  # opt.epochs_num = 10 before the loop (:530)
    batch_size: int = 32  # :469
    learning_rate: float = 1e-5  # :471
    domain_weight: float = 3.0  # GRL lambda (:472)
    max_len: int = 128  # ECPEDataset.max_len (:183)
    use_domain_loss: bool = True
    seed: int = 42


def read_clause_data(path: str) -> Tuple[list, np.ndarray]:
    """Clause-level (sentence, label) pairs (emotion_classifier.py:216-252):
    the comma-truncated clause text (field 3) with spaces stripped, and the
    emotion code 0..6 (6 = null)."""
    sentences, labels = [], []
    for doc in parse_ecpe_file(path):
        for c in doc.clauses:
            sentences.append((c.text_field3 or c.text).replace(" ", ""))
            labels.append(c.emotion)
    return sentences, np.asarray(labels, np.int32)


def encode_clauses(tokenizer, sentences, labels, max_len: int) -> dict:
    enc = tokenizer.encode_batch(sentences, max_len)
    return {
        "input_ids": enc.input_ids,
        "attention_mask": enc.attention_mask,
        "token_type_ids": enc.token_type_ids,
        "labels": np.asarray(labels, np.int32),
    }


def flat_prf(pred: np.ndarray, true: np.ndarray):
    """sklearn micro P/R/F1 with labels=[0..5] over flat clause arrays
    (emotion_classifier.py:388-392)."""
    n = len(pred)
    return micro_prf(pred[None, :], true[None, :], np.asarray([n]))


def build_dann_model(cfg: DannConfig, encoder_cfg: EncoderConfig,
                     device="cuda", dropout: float = 0.1,
                     encoder_ckpt: str = "") -> ClauseEmotionDANN:
    """The model with Flax-style random init from ``cfg.seed`` (a CPU
    generator) on ``device``; seeds the device's default generator, which
    dropout draws from. ``dropout`` is the model's (the reference's
    0.1). With ``encoder_ckpt`` (a local HF checkpoint dir, or the port's
    encoder dir) the encoder then takes its weights and the sizes of its
    tables, keeping ``encoder_cfg``'s other fields, as the JAX driver does;
    an orbax dir raises."""
    device = resolve_device(device)
    enc_state = None
    if encoder_ckpt:
        encoder_cfg, enc_state = load_encoder_checkpoint(encoder_ckpt,
                                                         encoder_cfg)
    torch.manual_seed(cfg.seed)
    model = ClauseEmotionDANN(encoder_cfg, dropout=dropout,
                              domain_weight=cfg.domain_weight)
    init_dann(model, cfg.seed)
    if enc_state is not None:
        model.encoder.load_state_dict(enc_state)
    return model.to(device)


def read_domains(cfg: DannConfig, data_root: str, max_clauses: int = 0):
    """(source, target) clause sets of the two domain files, cut to
    ``max_clauses`` each when it is not 0, not yet encoded."""
    out = []
    for dom in (cfg.source_domain, cfg.target_domain):
        sent, y = read_clause_data(os.path.join(data_root, cfg.doc_dir,
                                                f"{dom}.txt"))
        if max_clauses:
            sent, y = sent[:max_clauses], y[:max_clauses]
        out.append((sent, y))
    return out


def run_dann(
    cfg: DannConfig,
    encoder_cfg: EncoderConfig,
    tokenizer,
    data_root: str,
    logger=None,
    device="cuda",
    max_clauses: int = 0,  # test-size cap; 0 = all
    encoder_ckpt: str = "",  # a local HF checkpoint dir
) -> dict:
    """Full DANN experiment on ``device``; returns the best base and
    self-training metrics and the best state_dict."""
    source, target = (encode_clauses(tokenizer, sent, y, cfg.max_len)
                      for sent, y in read_domains(cfg, data_root,
                                                  max_clauses))
    model = build_dann_model(cfg, encoder_cfg, device,
                             encoder_ckpt=encoder_ckpt)
    return fit_dann(cfg, model, source, target, logger)


def fit_dann(cfg: DannConfig, model: ClauseEmotionDANN, source: dict,
             target: dict, logger=None, losses: Optional[list] = None
             ) -> dict:
    """run_dann on a model already built and encoded clause sets: the base
    phase, then the self-training iterations. ``losses``, when given,
    receives every step's (emotion, domain) losses (device tensors)."""
    best = {"p": 0.0, "r": 0.0, "f1": -1.0, "state": snapshot(model)}

    def evaluate(model, epoch, phase, iteration=0):
        pred = predict_dann(model, target).argmax(-1)
        p, r, f1 = flat_prf(pred, target["labels"])
        if logger:
            logger.log({"event": f"dann_{phase}_eval", "epoch": epoch,
                        "iteration": iteration, "p": p, "r": r, "f1": f1})
        if f1 > best["f1"]:
            best.update(p=p, r=r, f1=f1, state=snapshot(model))

    # base phase: labeled source vs unlabeled target
    optimizer = train_dann(
        model, source, target,
        epochs=cfg.epochs, batch_size=cfg.batch_size,
        learning_rate=cfg.learning_rate, seed=cfg.seed, logger=logger,
        labeled_domain=0, use_domain_loss=cfg.use_domain_loss,
        eval_fn=lambda m, e: evaluate(m, e, "base"), losses=losses)
    base_best = {"p": best["p"], "r": best["r"], "f1": best["f1"]}

    # self-training: pseudo-label the ENTIRE target set with the current
    # best model and train on it from there (emotion_classifier.py:255-277,
    # 527-543); the Adam carries across iterations (:500 creates one)
    for it in range(1, cfg.self_iteration + 1):
        model.load_state_dict(best["state"])
        pseudo = dict(target)
        pseudo["labels"] = predict_dann(model, target).argmax(-1).astype(
            np.int32)
        if logger:
            logger.log({"event": "dann_selftrain", "iteration": it,
                        "pseudo_label_hist":
                            np.bincount(pseudo["labels"],
                                        minlength=7).tolist()})
        optimizer = train_dann(
            model, pseudo, source,
            epochs=cfg.self_epochs, batch_size=cfg.batch_size,
            learning_rate=cfg.learning_rate, seed=cfg.seed + it,
            logger=logger, optimizer=optimizer, labeled_domain=1,
            use_domain_loss=cfg.use_domain_loss,
            eval_fn=lambda m, e, _it=it: evaluate(m, e, "self", _it),
            losses=losses)

    return {
        "base": base_best,
        "best": {"p": best["p"], "r": best["r"], "f1": best["f1"]},
        "state_dict": best["state"],
    }
