"""Stage-1 trainer: document-level emotion detection, self-training and
pair-file generation; port of carel_tpu/stage1/trainer.py.

Reproduces baseline_emotion_classifier_final_devin.py's train() (:330-553):
train on the source domain, evaluate micro-PRF (labels 0-5) on the target,
confidence-threshold self-training (the best emotion clause's probability
above ``threshold`` pseudo-labels the document), iterate while the
self-train set grows, and write
pair_data/predicted_emotion/source_{src}/{tgt}.txt on each new best self-F1.

Optimizer parity quirk: the reference builds a NEW Adam inside the batch
loop (devin :381, :477), so no optimizer state accumulates; each step is
sign-SGD with Adam's step-1 bias correction, p -= lr * g / (|g| + 1e-8).
``fresh_adam=True`` (the default) does exactly that; False uses a torch
Adam (eps 1e-8) whose state carries across the base and the self-training
epochs.

The step is eager, as the JAX package's is a per-step jit with no scanned
epoch. JAX params are values and torch params are not: where the JAX
trainer keeps ``best_params = params``, this one keeps a copy of the
state_dict, and each self-training iteration copies the best back into the
same parameter tensors (so a carried Adam's state stays attached).

The clause-level DANN variant is a separate driver (stage1/dann_driver.py,
CLI verb ``dann``).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from carel_tpu_torch.config import EncoderConfig
from carel_tpu_torch.device import resolve_device
from carel_tpu_torch.models.hf_port import load_encoder_checkpoint
from carel_tpu_torch.models.stage1 import DocEmotionModel, init_stage1_
from carel_tpu_torch.stage1.data import DocArrays
from carel_tpu_torch.stage1.pair_writer import write_pair_data
from carel_tpu_torch.train.logging import JsonlLogger
from carel_tpu_torch.train.metrics import micro_prf


@dataclass(frozen=True)
class Stage1Config:
    language: str = "zh"
    source_domain: str = "home"
    target_domain: str = "education"
    max_sen_len: int = 60
    max_doc_len: int = 75
    n_hidden: int = 100
    n_class: int = 7
    training_epoch: int = 10
    self_epoch: int = 5
    threshold: float = 0.7
    # pseudo-label up to top_k confident emotion clauses per doc; the 'com'
    # variant (baseline_emotion_classifier_com.py:33-34) uses top_k=2
    top_k: int = 1
    batch_size: int = 4
    learning_rate: float = 2e-5
    keep_softmax: float = 1.0
    l2_reg: float = 1e-5
    emotion_weight: float = 1.0
    clause_mixer: str = "bilstm"
    fresh_adam: bool = True  # reference's new-Adam-per-step quirk
    seed: int = 42
    save_dir: str = ""  # pair-file output dir; default mirrors the reference


def snapshot(model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """A copy of the model's state_dict that later steps do not change."""
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


@torch.no_grad()
def fresh_adam_update_(params, lr: float, eps: float = 1e-8) -> None:
    """One step of a freshly built Adam on every param with a gradient:
    p += (-lr * g) / (|g| + eps)."""
    params = [p for p in params if p.grad is not None]
    grads = [p.grad for p in params]
    num = torch._foreach_mul(grads, -lr)
    den = torch._foreach_abs(grads)
    torch._foreach_add_(den, eps)
    torch._foreach_div_(num, den)
    torch._foreach_add_(params, num)


def to_device(arr: DocArrays, idx, device) -> dict:
    """The model inputs and targets of documents ``idx`` on ``device``."""
    sub = arr.take(idx)
    return {
        "x_ids": torch.from_numpy(sub.x_ids).to(device),
        "x_masks": torch.from_numpy(sub.x_masks).to(device),
        "x_types": torch.from_numpy(sub.x_types).to(device),
        "doc_len": torch.from_numpy(sub.doc_len.astype(np.float32)).to(device),
        "y_emotion": torch.from_numpy(sub.y_emotion).to(device),
    }


def stage1_loss(cfg: Stage1Config, model: DocEmotionModel, batch: dict):
    """-sum(y * log(pred + 1e-12)) / max(sum(doc_len), 1) * emotion_weight
    + l2_reg * reg (devin :378-379); padded clause rows have all-zero
    one-hots and add nothing."""
    pred, reg = model(batch["x_ids"], batch["x_masks"], batch["x_types"],
                      deterministic=False)
    valid = torch.clamp(torch.sum(batch["doc_len"]), min=1.0)
    ce = -torch.sum(batch["y_emotion"] * torch.log(pred + 1e-12)) / valid
    return ce * cfg.emotion_weight + reg * cfg.l2_reg


def make_stage1_step(cfg: Stage1Config, model: DocEmotionModel,
                     optimizer: Optional[torch.optim.Optimizer] = None):
    """step(batch) -> loss (on the device): one update, the fresh-Adam one
    unless ``optimizer`` is given."""
    params = [p for p in model.parameters() if p.requires_grad]

    def step(batch: dict) -> torch.Tensor:
        for p in params:
            p.grad = None
        loss = stage1_loss(cfg, model, batch)
        loss.backward()
        if optimizer is None:
            fresh_adam_update_(params, cfg.learning_rate)
        else:
            optimizer.step()
        return loss.detach()

    return step


@torch.no_grad()
def predict_docs(model: DocEmotionModel, arr: DocArrays, device,
                 batch_size: int = 8) -> np.ndarray:
    """Probabilities [N, D, n_class] in batches of ``batch_size``
    documents, deterministic."""
    preds = []
    for s in range(0, len(arr), batch_size):
        b = to_device(arr, np.arange(s, min(s + batch_size, len(arr))),
                      device)
        pred, _ = model(b["x_ids"], b["x_masks"], b["x_types"],
                        deterministic=True)
        preds.append(pred.cpu().numpy())
    return np.concatenate(preds, 0)


def self_label(arr: DocArrays, probs: np.ndarray, threshold: float,
               top_k: int = 1) -> Optional[DocArrays]:
    """Pseudo-label target docs whose best emotion clause(s) clear the
    threshold (generate_self_train_data, devin :106-160; the 'com' variant
    keeps up to top_k confident clauses, com :33-34); the other clauses
    become class 6."""
    keep, y_new = [], []
    for i in range(len(arr)):
        d = int(arr.doc_len[i])
        candidates = []  # (prob, clause, emotion)
        for j in range(d):
            e = int(np.argmax(probs[i, j]))
            if e != 6:
                candidates.append((float(probs[i, j, e]), j, e))
        candidates.sort(reverse=True)
        chosen = [(j, e) for p, j, e in candidates[:top_k] if p > threshold]
        if chosen:
            y = np.zeros_like(arr.y_emotion[i])
            chosen_map = dict(chosen)
            for j in range(d):
                if j in chosen_map:
                    y[j, chosen_map[j]] = 1.0
                else:
                    y[j, 6] = 1.0
            keep.append(i)
            y_new.append(y)
    if not keep:
        return None
    sub = arr.take(np.asarray(keep))
    sub.y_emotion = np.stack(y_new)
    return sub


def run_epoch(cfg: Stage1Config, arr: DocArrays, step, data_rng, device
              ) -> list:
    """One shuffled epoch; the last batch is padded with the first indices
    of the shuffled order. Returns the losses (on the device)."""
    order = np.arange(len(arr))
    data_rng.shuffle(order)
    losses = []
    for s in range(0, len(order), cfg.batch_size):
        idx = order[s: s + cfg.batch_size]
        if len(idx) < cfg.batch_size:
            idx = np.concatenate([idx, order[: cfg.batch_size - len(idx)]])
        losses.append(step(to_device(arr, idx, device)))
    return losses


def eval_prf(model, test: DocArrays, device):
    probs = predict_docs(model, test, device)
    pred_op = np.argmax(probs, -1)
    true_op = np.argmax(test.y_emotion, -1)
    return micro_prf(pred_op, true_op, test.doc_len), probs


def build_stage1_model(cfg: Stage1Config, encoder_cfg: EncoderConfig,
                       device="cuda", encoder_ckpt: str = ""
                       ) -> DocEmotionModel:
    """The model with Flax-style random init from ``cfg.seed`` (a CPU
    generator, so it does not depend on the device) on ``device``; seeds
    the device's default generator, which dropout draws from. With
    ``encoder_ckpt`` (a local HF checkpoint dir, or the port's encoder
    dir) the encoder then takes its weights and the sizes of its tables, keeping ``encoder_cfg``'s other
    fields, as the JAX trainer does (devin :265 downloads hub BERT); an
    orbax dir raises."""
    device = resolve_device(device)
    enc_state = None
    if encoder_ckpt:
        encoder_cfg, enc_state = load_encoder_checkpoint(encoder_ckpt,
                                                         encoder_cfg)
    torch.manual_seed(cfg.seed)
    model = DocEmotionModel(encoder_cfg, cfg.n_hidden, cfg.n_class,
                            cfg.keep_softmax, cfg.clause_mixer)
    init_stage1_(model, torch.Generator().manual_seed(cfg.seed))
    if enc_state is not None:
        model.encoder.load_state_dict(enc_state)
    return model.to(device)


def train_stage1(
    cfg: Stage1Config,
    encoder_cfg: EncoderConfig,
    train_arr: DocArrays,
    test_arr: DocArrays,
    tokenizer,
    logger: Optional[JsonlLogger] = None,
    write_pairs: bool = True,
    device="cuda",
    encoder_ckpt: str = "",  # a local HF checkpoint dir
) -> Tuple[Dict[str, torch.Tensor], Tuple[float, float, float],
           Optional[str]]:
    """Full stage-1 run on ``device``. Returns (the best state_dict, best
    (p, r, f1), the pair file's path or None)."""
    model = build_stage1_model(cfg, encoder_cfg, device, encoder_ckpt)
    return fit_stage1(cfg, model, train_arr, test_arr, tokenizer, logger,
                      write_pairs)


def fit_stage1(
    cfg: Stage1Config,
    model: DocEmotionModel,
    train_arr: DocArrays,
    test_arr: DocArrays,
    tokenizer,
    logger: Optional[JsonlLogger] = None,
    write_pairs: bool = True,
    losses: Optional[list] = None,
) -> Tuple[Dict[str, torch.Tensor], Tuple[float, float, float],
           Optional[str]]:
    """train_stage1 on a model already built: base epochs, then
    self-training, with the model's params left as the last epoch made
    them. ``losses``, when given, receives every step's loss (device
    tensors)."""
    device = next(model.parameters()).device
    logger = logger or JsonlLogger(echo=False)
    optimizer = None
    if not cfg.fresh_adam:
        optimizer = torch.optim.Adam(
            [p for p in model.parameters() if p.requires_grad],
            lr=cfg.learning_rate, eps=1e-8, fused=device.type == "cuda")
    step = make_stage1_step(cfg, model, optimizer)
    data_rng = np.random.default_rng(cfg.seed)
    losses = [] if losses is None else losses

    save_dir = cfg.save_dir or os.path.join(
        "pair_data/predicted_emotion", f"source_{cfg.source_domain}")
    pair_file = None

    best_f1 = -1.0
    best_params = snapshot(model)
    best_probs = None
    for epoch in range(1, cfg.training_epoch + 1):
        losses += run_epoch(cfg, train_arr, step, data_rng, device)
        (p, r, f1), probs = eval_prf(model, test_arr, device)
        logger.log({"event": "stage1_eval", "epoch": epoch,
                    "p": p, "r": r, "f1": f1})
        if f1 > best_f1:
            best_f1, best_params, best_probs = f1, snapshot(model), probs
    best = (0.0, 0.0, best_f1)

    # self-training: iterate while the pseudo-labelled set grows
    self_best_f1 = -1.0
    last_size = 0
    probs = best_probs
    while True:
        # each iteration restarts from the best checkpoint (devin :449)
        model.load_state_dict(best_params)
        pseudo = self_label(test_arr, probs, cfg.threshold, cfg.top_k)
        size = len(train_arr) + (len(pseudo) if pseudo is not None else 0)
        if size <= last_size or pseudo is None:
            break
        last_size = size
        merged = train_arr.concat(pseudo)
        logger.log({"event": "stage1_selftrain", "set_size": size})
        for epoch in range(1, cfg.self_epoch + 1):
            losses += run_epoch(cfg, merged, step, data_rng, device)
            (p, r, f1), ep_probs = eval_prf(model, test_arr, device)
            logger.log({"event": "stage1_self_eval", "epoch": epoch,
                        "p": p, "r": r, "f1": f1})
            if f1 > self_best_f1:
                self_best_f1 = f1
                best_params = snapshot(model)
                probs = ep_probs
                best = (p, r, f1)
                if write_pairs:
                    pair_file = os.path.join(
                        save_dir, f"{cfg.target_domain}.txt")
                    write_pair_data(pair_file, test_arr,
                                    np.argmax(probs, -1), tokenizer)
                    logger.log({"event": "stage1_pair_file",
                                "path": pair_file})

    return best_params, best, pair_file
