"""End-to-end driver of the original 3-latent DRL trainer; port of
carel_tpu/train/original_driver.py.

Reproduces drl_classifier.py:802-1041 (and the bow_loss variant's learned
BoW re-weighting, drl_classifier_bow_loss.py:246-257): old-split zh data
(train domains/THUCTC_multiple/<source>.txt, test pair_data/emotion/
<target>.txt with the forced misses), the step of train/steps_original.py
(eager, as JAX's per-step ``jit``), a full evaluation each epoch with the
best-F1 checkpoint saved and, after every phase, reloaded
(drl_classifier.py:954), and the self-training loop (strategy ``random`` by
default, drl_classifier.py:734-799).

Seeds as in JAX: numpy's ``seed`` for the base batches, ``seed + 13`` for
self-training's pseudo sets, ``seed + 100 + i`` for iteration i's batches;
the parameters come from a CPU generator seeded ``seed``, dropout from the
device's default generator seeded ``seed``, the sampling noise from a
generator on the device seeded ``seed + 1``, and evaluation's noise from one
seeded ``seed + 7`` (JAX: ``jax.random.key(seed + 7)``).
"""

from __future__ import annotations

import dataclasses
import os
import random
import time
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from carel_tpu_torch.config import CarelConfig, EncoderConfig
from carel_tpu_torch.data.batching import PairArrays, encode_pairs, iter_batches
from carel_tpu_torch.data.bow import build_bow_vocab_zh, open_segmentation
from carel_tpu_torch.data.ecpe_format import parse_ecpe_file
from carel_tpu_torch.data.pairs import PairSet, build_pairs
from carel_tpu_torch.data.tokenizer import build_tokenizer
from carel_tpu_torch.device import resolve_device
from carel_tpu_torch.models.drl_original import (DrlOriginalModel,
                                                 OriginalModelConfig)
from carel_tpu_torch.models.encoder import init_flax_
from carel_tpu_torch.models.hf_port import load_encoder_checkpoint
from carel_tpu_torch.selftrain.strategies import generate_self_train_pairs
from carel_tpu_torch.train import checkpoint as ckpt
from carel_tpu_torch.train.logging import JsonlLogger
from carel_tpu_torch.train.loop import evaluate
from carel_tpu_torch.train.steps import batch_to_device, make_eval_step
from carel_tpu_torch.train.steps_original import (OriginalLossConfig,
                                                  OriginalTrainState,
                                                  create_original_state,
                                                  make_original_train_step)

Best = Tuple[float, float, float]


def _train_phase(cfg: CarelConfig, state: OriginalTrainState, step: Callable,
                 eval_step: Callable, train_arrays: PairArrays,
                 test_arrays: PairArrays, num_unpred: int, model_id: str,
                 epochs: int, logger: JsonlLogger, data_rng, eval_gen,
                 best: Best) -> Tuple[OriginalTrainState, Best]:
    """One train() call of the reference (:808-960): epochs over batches
    (the KL counter is the batch index within the epoch), an evaluation an
    epoch, the checkpoint saved on a best F1, and the best checkpoint
    reloaded at the end whenever one exists (drl_classifier.py:954), also
    when this phase saved none."""
    model = state.model
    device = next(model.parameters()).device
    saved = False
    for epoch in range(1, epochs + 1):
        t0 = time.time()
        losses = []
        for it, batch in enumerate(iter_batches(
                train_arrays, cfg.train.batch_size, shuffle=True,
                rng=data_rng)):
            metrics = step(state, batch_to_device(batch.as_dict(), device),
                           it)
            losses.append(metrics["vae_loss"])
        loss = float(torch.stack(losses).mean()) if losses else float("nan")
        res = evaluate(eval_step, model, test_arrays, num_unpred, eval_gen,
                       cfg.train.eval_batch_size)
        logger.log({"event": "eval", "epoch": epoch, "loss": loss,
                    "steps": len(losses), "precision": res.precision,
                    "recall": res.recall, "f1": res.f1,
                    "epoch_seconds": time.time() - t0})
        if res.f1 > best[2]:
            best = (res.precision, res.recall, res.f1)
            ckpt.save_best(cfg.train.checkpoint_dir, model_id,
                           model.state_dict())
            saved = True
            logger.log({"event": "best", "epoch": epoch, "f1": res.f1})
    if saved or os.path.exists(ckpt.best_path(cfg.train.checkpoint_dir,
                                              model_id)):
        model.load_state_dict(ckpt.load_best(cfg.train.checkpoint_dir,
                                             model_id, device))
    return state, best


def build_original_state(cfg: CarelConfig, loss_cfg: OriginalLossConfig,
                         model_cfg: OriginalModelConfig, device="cuda",
                         params: Optional[Dict[str, torch.Tensor]] = None,
                         encoder_state: Optional[Dict[str, torch.Tensor]]
                         = None) -> OriginalTrainState:
    """The model on ``device`` (Flax-style random init from the train
    seed, or ``params``; ``encoder_state`` then replaces the encoder's) and
    its two optimizer groups; seeds dropout and the sampling generator."""
    device = resolve_device(device)
    seed = cfg.train.seed
    torch.manual_seed(seed)
    model = DrlOriginalModel(model_cfg)
    if params is None:
        init_flax_(model, torch.Generator().manual_seed(seed))
    else:
        model.load_state_dict(params)
    if encoder_state is not None:
        model.encoder.load_state_dict(encoder_state)
    model.to(device)
    return create_original_state(
        loss_cfg, model, torch.Generator(device=device).manual_seed(seed + 1))


def train_original(
    cfg: CarelConfig,
    state: OriginalTrainState,
    step: Callable,
    train_arrays: PairArrays,
    test_arrays: PairArrays,
    test_pairs: PairSet,
    num_unpred: int,
    encode: Callable[[PairSet], PairArrays],
    model_id: str,
    logger: Optional[JsonlLogger] = None,
) -> Tuple[OriginalTrainState, Best, Best]:
    """The base phase, then ``cfg.train.self_iteration`` self-training
    iterations (drl_classifier.py:1019-1039), each from the best reloaded;
    returns (state, base best, self-training best)."""
    logger = logger or JsonlLogger(echo=False)
    device = next(state.model.parameters()).device
    # stochastic evaluation, the latents re-sampled on every batch
    # (get_pair_preds, drl_classifier.py:337-351), as the flagship's
    eval_step = make_eval_step(sample=True)
    seed = cfg.train.seed
    eval_gen = torch.Generator(device=device).manual_seed(seed + 7)
    state, base_best = _train_phase(
        cfg, state, step, eval_step, train_arrays, test_arrays, num_unpred,
        model_id, cfg.train.epochs, logger, np.random.default_rng(seed),
        eval_gen, (0.0, 0.0, 0.0))
    logger.log({"event": "base_done", "p": base_best[0], "r": base_best[1],
                "f1": base_best[2]})

    self_best = (0.0, 0.0, 0.0)
    self_rng = np.random.default_rng(seed + 13)
    for i in range(cfg.train.self_iteration):
        res = evaluate(eval_step, state.model, test_arrays, num_unpred,
                       eval_gen, cfg.train.eval_batch_size)
        pseudo = generate_self_train_pairs(
            test_pairs, res.probs, cfg.train.self_strategy, iteration=i,
            round_up=cfg.train.round_up, rng=self_rng,
            conf_margin=cfg.train.self_conf_margin)
        if len(pseudo) == 0:
            logger.log({"event": "selftrain_empty", "iteration": i + 1})
            continue
        logger.log({"event": "selftrain_iter", "iteration": i + 1,
                    "pseudo_pairs": len(pseudo)})
        state, self_best = _train_phase(
            cfg, state, step, eval_step, encode(pseudo), test_arrays,
            num_unpred, model_id, cfg.train.self_epochs, logger,
            np.random.default_rng(seed + 100 + i), eval_gen, self_best)
        logger.log({"event": "selftrain_best", "iteration": i + 1,
                    "f1": self_best[2]})
    if cfg.train.self_iteration:
        logger.log({"event": "self_done", "p": self_best[0],
                    "r": self_best[1], "f1": self_best[2]})
    return state, base_best, self_best


def run_original(
    cfg: CarelConfig,
    loss_cfg: OriginalLossConfig,
    encoder_cfg: EncoderConfig,
    model_id: str,
    cache_dir: str = ".carel_cache",
    logger: Optional[JsonlLogger] = None,
    max_train_docs: int = 0,
    max_test_docs: int = 0,
    device="cuda",
) -> Tuple[OriginalTrainState, Best, Best]:
    """Full original-DRL run on ``device`` (the GPU unless "cpu" is asked
    for). Returns (state, base best, self-training best)."""
    from carel_tpu_torch.pipeline import fit_max_len, resolve_paths

    device = resolve_device(device)
    logger = logger or JsonlLogger(echo=False)
    train_path, test_path, bow_path = resolve_paths(cfg)
    train_docs = parse_ecpe_file(train_path)
    test_docs = parse_ecpe_file(test_path)
    if max_train_docs:
        train_docs = train_docs[:max_train_docs]
    if max_test_docs:
        test_docs = test_docs[:max_test_docs]
    rng = random.Random(cfg.data.seed)
    train_pairs = build_pairs(train_docs, test=False, rng=rng)
    test_pairs = build_pairs(test_docs, test=True, rng=rng)
    os.makedirs(cache_dir, exist_ok=True)
    # jieba's words through the cache of the three input files
    segmenter = open_segmentation(cache_dir, (train_path, test_path, bow_path))
    bow = build_bow_vocab_zh(bow_path, segmenter)
    tok_cache = os.path.join(cache_dir, f"tokenizer_{cfg.data.language}.json")
    hf = cfg.data.tokenizer if cfg.data.tokenizer not in ("auto", "") else None
    corpus = None
    if hf is None and not os.path.exists(tok_cache):
        corpus = [c.text for doc in parse_ecpe_file(bow_path)
                  for c in doc.clauses]
    tokenizer = build_tokenizer(cfg.data.language, corpus, tok_cache, hf)

    enc = dataclasses.replace(encoder_cfg, vocab_size=tokenizer.vocab_size)
    encoder_state = None
    if cfg.model.pretrained_encoder:
        enc, encoder_state = load_encoder_checkpoint(
            cfg.model.pretrained_encoder, enc)
    max_len = cfg.data.max_len or fit_max_len(
        tokenizer, train_pairs.pairs + test_pairs.pairs)

    def encode(pair_set: PairSet) -> PairArrays:
        return encode_pairs(pair_set, tokenizer, bow, max_len)

    train_arrays, test_arrays = encode(train_pairs), encode(test_pairs)
    segmenter.save()
    num_unpred = test_pairs.num_unpred_emotions
    logger.log({"event": "config", "preset": "drl_original",
                "model_id": model_id, "device": str(device),
                "train_pairs": len(train_arrays),
                "test_pairs": len(test_arrays), "num_unpred": num_unpred,
                "bow_dim": len(bow), "max_len": max_len,
                "learned_bow_weights": loss_cfg.learned_bow_weights})

    model_cfg = OriginalModelConfig(
        encoder=enc, bow_dim=len(bow), ec_num_class=1,
        compat_sampling=cfg.model.compat_sampling)
    state = build_original_state(cfg, loss_cfg, model_cfg, device,
                                 encoder_state=encoder_state)
    return train_original(cfg, state, make_original_train_step(loss_cfg),
                          train_arrays, test_arrays, test_pairs, num_unpred,
                          encode, model_id, logger)
