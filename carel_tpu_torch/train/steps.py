"""Train and eval steps, port of carel_tpu/train/steps.py.

Ported so far: the single-gradient step of the none, mmd and hsic
regularizers (flagship forward :184-263, train :820-845). The BoW
reconstruction term is always the fused loss (kernels K3/K4 on CUDA, the
plain version on the CPU), so the model never computes the [B, V] decoder
logits in training; the MMD term goes through kernels K1/K2 and the HSIC term
through K5/K6 on CUDA.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from carel_tpu_torch.config import CarelConfig, Regularizer
from carel_tpu_torch.losses.classify import (
    binary_smoothed_bce,
    cause_bce_loss,
    emotion_ce_loss,
    pair_bce_pos_weighted,
)
from carel_tpu_torch.losses.registry import regularizer_loss
from carel_tpu_torch.losses.vae import annealed_kl_weight, kl_loss
from carel_tpu_torch.ops.cuda_bow import fused_bow_loss
from carel_tpu_torch.train.state import TrainState


def batch_to_device(batch: Dict[str, np.ndarray],
                    device: torch.device) -> Dict[str, torch.Tensor]:
    """numpy batch (``Batch.as_dict()``) -> tensors on ``device``."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in batch.items()}


def vae_and_classifier_loss(
    cfg: CarelConfig,
    out: Dict[str, torch.Tensor],
    batch: Dict[str, torch.Tensor],
    iteration: int,
    decoder: torch.nn.Linear,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The weighted multi-task loss (flagship :208-261) for none/mmd/hsic;
    the reconstruction term is the fused BoW loss from the generative
    embedding and the decoder's weights."""
    lc = cfg.loss
    mask = batch["example_mask"]
    pair_labels = batch["pair_labels"]

    if cfg.model.binary_emotion:
        emo = binary_smoothed_bce(out["emotion_logits"],
                                  torch.ones_like(pair_labels),
                                  lc.label_smoothing, 1, mask)
    else:
        emo = emotion_ce_loss(out["emotion_logits"], batch["emotion_labels"],
                              mask)
    cau = cause_bce_loss(out["cause_logits"], pair_labels, lc.label_smoothing,
                         mask)
    pair = pair_bce_pos_weighted(out["pair_logits"], pair_labels,
                                 lc.label_smoothing, mask)

    ann = annealed_kl_weight(iteration, lc.kl_ann_iterations, lc.ec_kl_lambda)
    kl_e = ann * kl_loss(out["emotion_mu"], out["emotion_log_var"], mask)
    kl_c = ann * kl_loss(out["cause_mu"], out["cause_log_var"], mask)

    recon = fused_bow_loss(out["generative_emb"], decoder.weight,
                           decoder.bias, batch["bow_indices"],
                           batch["bow_weights"], lc.label_smoothing, mask)
    reg = regularizer_loss(out, lc, mask)

    # hsic: the cause term takes the EMOTION weight (ec_hsic :249-253)
    cau_weight = (lc.emo_mul_loss_weight if lc.regularizer == Regularizer.HSIC
                  else lc.cau_mul_loss_weight)
    total = (reg
             + lc.emo_mul_loss_weight * emo
             + cau_weight * cau
             + lc.pair_mul_loss_weight * pair
             + kl_e + kl_c + recon)
    metrics = {
        "loss": total,
        "emo_loss": emo,
        "cau_loss": cau,
        "pair_loss": pair,
        "kl_emotion": kl_e,
        "kl_cause": kl_c,
        "recon_loss": recon,
        "reg_loss": reg,
    }
    return total, metrics


def make_train_step(cfg: CarelConfig) -> Callable:
    """The train step for this config's regularizer:
    ``step(state, batch, iteration, eps=None) -> metrics`` (0-d tensors,
    not synchronized). ``eps`` = (eps_emotion, eps_cause) fixes the sampling
    noise; otherwise it comes from ``state.generator``."""
    reg = cfg.loss.regularizer
    if reg not in (Regularizer.NONE, Regularizer.MMD, Regularizer.HSIC):
        raise NotImplementedError(
            f"the {reg.value!r} train step is not ported to carel_tpu_torch "
            "yet (ROADMAP Queue 1: gan/vi steps)")

    def step(state: TrainState, batch: Dict[str, torch.Tensor],
             iteration: int,
             eps: Optional[Sequence[torch.Tensor]] = None) -> Dict:
        model = state.model
        out = model(batch["input_ids"], batch["attention_mask"],
                    batch["token_type_ids"], deterministic=False,
                    sample=True, compute_recon=False, eps=eps,
                    generator=state.generator)
        total, metrics = vae_and_classifier_loss(
            cfg, out, batch, iteration, model.heads.decoder)
        state.optimizer.zero_grad(set_to_none=True)
        total.backward()
        state.optimizer.step()
        state.step += 1
        return {k: v.detach() for k, v in metrics.items()}

    return step


def make_eval_step(sample: bool = True) -> Callable:
    """Batched eval: pair probabilities (get_pair_preds, flagship :265-282).
    The reference re-samples the latents at eval; ``sample`` keeps that, with
    the noise drawn from the generator passed in."""

    @torch.no_grad()
    def step(model, batch: Dict[str, torch.Tensor],
             generator: torch.Generator) -> torch.Tensor:
        return model.pair_probabilities(
            batch["input_ids"], batch["attention_mask"],
            batch["token_type_ids"], sample=sample,
            generator=generator).float()

    return step
