"""Train step of the original 3-latent DRL (drl_classifier.py); port of
carel_tpu/train/steps_original.py.

Six optimizers in the reference (five RMSprops for the adversaries and an
Adam for the VAE and classifiers, :985-991); its zero-all, backward-each,
step-all sequence is one gradient of the summed loss with an optimizer a
group. So, as in JAX, the step takes ONE backward of vae_loss + disc_losses:

- the adversaries' own BCEs read detached latents, so they reach only the
  adversaries; the entropy terms read the live latents through the same
  adversaries, so the adversaries' gradients carry both, as JAX's single
  ``value_and_grad`` gives them;
- the main group (encoder, classifiers, decoder) steps the fused Adam
  (train/state.py ``adam``, lr ``vae_lr``), the five adversaries step
  ``DiscRMSprop`` (``adv_lr``, decay 0.99, eps inside the root);
- the six latent heads are frozen (the reference's get_params quirk,
  :956-976): ``requires_grad_(False)``, the gradient still flows through
  them to the encoder.

Loss weights: con_adv .03, ec_adv 1, ecce_adv 3, con_mul 3, ec_mul 10,
pair_mul 30, the KLs annealed by the within-epoch batch index, the
reconstruction (:323-331, flag defaults :41-49). The four BoW terms (the
content adversary's two sigmoid BCEs, the content classifier's and the
decoder's softmax BCEs) are dense [B, V] BCEs with p clipped to
[1e-12, 1 - 1e-7] in fp32, as JAX computes them outside any Pallas kernel;
they do not go through the fused BoW kernels. The bow_loss variant reuses
sigmoid(content_logits) as detached per-word BCE weights
(drl_classifier_bow_loss.py:246-257).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch
from torch import nn

from carel_tpu_torch.losses.classify import (binary_smoothed_bce,
                                             entropy_loss, masked_mean)
from carel_tpu_torch.losses.vae import annealed_kl_weight, kl_loss
from carel_tpu_torch.models.drl_original import ADVERSARIES, LATENT_HEADS
from carel_tpu_torch.ops.bow_recon import densify_bow
from carel_tpu_torch.train.state import DiscRMSprop, adam

MAIN, DISC, FROZEN = "main", "disc", "frozen"


@dataclass(frozen=True)
class OriginalLossConfig:
    con_adv_loss_weight: float = 0.03
    ec_adv_loss_weight: float = 1.0
    ecce_adv_loss_weight: float = 3.0
    con_mul_loss_weight: float = 3.0
    ec_mul_loss_weight: float = 10.0
    pair_mul_loss_weight: float = 30.0
    ec_kl_lambda: float = 0.03
    con_kl_lambda: float = 0.03
    kl_ann_iterations: int = 20000
    label_smoothing: float = 0.1
    epsilon: float = 1e-8
    learned_bow_weights: bool = False  # the bow_loss variant
    vae_lr: float = 1e-5
    adv_lr: float = 3e-3


def original_losses(cfg: OriginalLossConfig, out: Dict[str, torch.Tensor],
                    batch: Dict[str, torch.Tensor], iteration: int
                    ) -> Tuple[torch.Tensor, torch.Tensor, Dict]:
    """(vae_loss, disc_losses, metrics) of one forward. ``iteration`` is the
    within-epoch batch index; its KL weights are computed in double on the
    host (JAX computes them in fp32)."""
    mask = batch["example_mask"]
    bow_dim = out["recon_logits"].shape[-1]
    bow = densify_bow(batch["bow_indices"], batch["bow_weights"], bow_dim)
    smoothed_bow = bow * (1 - cfg.label_smoothing) \
        + cfg.label_smoothing / bow_dim
    emo_labels = torch.ones_like(batch["pair_labels"])  # binary all-ones
    cau_labels = batch["pair_labels"]

    weights_con = weights_ec = None
    if cfg.learned_bow_weights:
        con_w = torch.sigmoid(out["content_logits"].float())
        weights_con = con_w
        weights_ec = 1.0 - con_w

    def bce_bow(logits, weights=None, kind="sigmoid"):
        logits = logits.float()
        p = (torch.softmax(logits, -1) if kind == "softmax"
             else torch.sigmoid(logits))
        # the clip's bounds become fp32 constants, as in JAX (1 - 1e-7 is
        # 0.99999988 in fp32)
        p = torch.clamp(p, 1e-12, 1.0 - 1e-7)
        per = -(smoothed_bow * torch.log(p)
                + (1.0 - smoothed_bow) * torch.log1p(-p))
        if weights is not None:
            per = per * weights.detach()
        return masked_mean(torch.mean(per, -1), mask)

    ls = cfg.label_smoothing
    # discriminator losses (detached latents)
    disc_losses = (
        bce_bow(out["content_disc_emo_sg"], weights_ec)
        + bce_bow(out["content_disc_cau_sg"], weights_ec)
        + binary_smoothed_bce(out["emotion_disc_sg"], emo_labels, ls, 1, mask)
        + binary_smoothed_bce(out["cause_disc_sg"], cau_labels, ls, 1, mask)
        + binary_smoothed_bce(out["ec_disc_sg"], emo_labels, ls, 1, mask)
        + binary_smoothed_bce(out["ce_disc_sg"], cau_labels, ls, 1, mask)
    )

    # adversarial entropies on live latents
    def ent(name):
        return entropy_loss(out[name], cfg.epsilon, mask)

    con_entropy = ent("content_disc_emo") + ent("content_disc_cau")
    ec_entropy = ent("emotion_disc") + ent("cause_disc")
    ecce_entropy = ent("ec_disc") + ent("ce_disc")

    # multitask
    emo_mul = binary_smoothed_bce(out["emotion_logits"], emo_labels, ls, 1,
                                  mask)
    cau_mul = binary_smoothed_bce(out["cause_logits"], cau_labels, ls, 1,
                                  mask)
    con_mul = bce_bow(out["content_logits"], weights_con, kind="softmax")
    pair_mul = binary_smoothed_bce(out["pair_logits"], cau_labels, ls, 1,
                                   mask)

    ann_ec = annealed_kl_weight(iteration, cfg.kl_ann_iterations,
                                cfg.ec_kl_lambda)
    ann_con = annealed_kl_weight(iteration, cfg.kl_ann_iterations,
                                 cfg.con_kl_lambda)
    kls = (ann_ec * kl_loss(out["emotion_mu"], out["emotion_log_var"], mask)
           + ann_ec * kl_loss(out["cause_mu"], out["cause_log_var"], mask)
           + ann_con * kl_loss(out["content_mu"], out["content_log_var"],
                               mask))

    recon = bce_bow(out["recon_logits"], kind="softmax")

    vae_loss = (cfg.con_adv_loss_weight * con_entropy
                + cfg.ec_adv_loss_weight * ec_entropy
                + cfg.ecce_adv_loss_weight * ecce_entropy
                + cfg.ec_mul_loss_weight * (emo_mul + cau_mul)
                + cfg.con_mul_loss_weight * con_mul
                + cfg.pair_mul_loss_weight * pair_mul
                + kls + recon)

    return vae_loss, disc_losses, {
        "vae_loss": vae_loss, "disc_loss": disc_losses,
        "pair_loss": pair_mul, "recon_loss": recon,
    }


def param_labels(model: nn.Module) -> Dict[str, str]:
    """Optimizer group of every parameter, by its module path: the five
    adversaries ``disc``, the six latent heads ``frozen`` (the flagship's
    get_params quirk), the rest ``main``."""

    def label_for(name: str) -> str:
        keys = name.split(".")
        if any(k in ADVERSARIES for k in keys):
            return DISC
        if any(k in LATENT_HEADS for k in keys):
            return FROZEN
        return MAIN

    return {name: label_for(name) for name, _ in model.named_parameters()}


@dataclass
class OriginalTrainState:
    """The model, the main Adam, the adversaries' RMSprop, the sampling
    generator and the count of steps."""

    model: nn.Module
    optimizer: torch.optim.Optimizer
    disc_optimizer: torch.optim.Optimizer
    generator: torch.Generator
    labels: Dict[str, str]
    step: int = 0


def create_original_state(cfg: OriginalLossConfig, model: nn.Module,
                          generator: torch.Generator) -> OriginalTrainState:
    """The two optimizer groups of ``model`` (on its device); the latent
    heads get ``requires_grad_(False)``."""
    labels = param_labels(model)
    groups: Dict[str, list] = {MAIN: [], DISC: []}
    for name, p in model.named_parameters():
        if labels[name] == FROZEN:
            p.requires_grad_(False)
        else:
            groups[labels[name]].append(p)
    device = next(model.parameters()).device
    return OriginalTrainState(
        model=model, optimizer=adam(groups[MAIN], cfg.vae_lr, device),
        disc_optimizer=DiscRMSprop(groups[DISC], lr=cfg.adv_lr, decay=0.99,
                                   eps=1e-8),
        generator=generator, labels=labels)


def make_original_train_step(cfg: OriginalLossConfig) -> Callable:
    """The eager step: ``step(state, batch, iteration, eps=None) ->
    metrics`` (0-d tensors, not synchronized). ``iteration`` is the
    within-epoch batch index; ``eps`` = (eps_content, eps_emotion,
    eps_cause) fixes the sampling noise, otherwise it is drawn from
    ``state.generator``. One backward of vae_loss + disc_losses; the main
    Adam and the adversaries' RMSprop step from its gradients."""

    def step(state: OriginalTrainState, batch: Dict[str, torch.Tensor],
             iteration: int,
             eps: Optional[Sequence[torch.Tensor]] = None) -> Dict:
        model = state.model
        model.zero_grad(set_to_none=True)
        out = model(batch["input_ids"], batch["attention_mask"],
                    batch["token_type_ids"], deterministic=False,
                    sample=True, eps=eps, generator=state.generator)
        vae_loss, disc_losses, metrics = original_losses(cfg, out, batch,
                                                         iteration)
        (vae_loss + disc_losses).backward()
        state.optimizer.step()
        state.disc_optimizer.step()
        state.step += 1
        return {k: v.detach() for k, v in metrics.items()}

    return step
