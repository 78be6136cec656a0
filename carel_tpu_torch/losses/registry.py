"""Disentanglement-regularizer registry, port of carel_tpu/losses/registry.py.

One entry per reference trainer family (SURVEY.md §2.2): none, mmd, hsic,
gan, vi. Each term consumes the DrlModel output dict and returns the scalar
added to the VAE/classifier loss; GAN's discriminator losses and VI's
approximation loss, which train their own parameter groups, are separate
functions for the multi-optimizer train steps.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from carel_tpu_torch.config import LossConfig, Regularizer
from carel_tpu_torch.losses.classify import (
    binary_smoothed_bce,
    entropy_loss,
    masked_mean,
)
from carel_tpu_torch.ops.cuda_pairwise import hsic_statistic, mmd_statistic


def club_aprx_loss(out: Dict, mask=None) -> torch.Tensor:
    """Negative log-likelihood training the approximation net p(e|c)
    (vi_final :421-426), from the CLUB outputs on the detached cause latent
    and the detached emotion latent, so only the club params get gradient."""
    mu, lv = out["club_mu_sg"], out["club_lv_sg"]
    e = out["z_emotion"].detach()
    ll = torch.sum(-((mu - e) ** 2) / torch.exp(lv) - lv, dim=-1)
    return -masked_mean(ll, mask)


def club_upper_loss(out: Dict, perm: torch.Tensor, mask=None) -> torch.Tensor:
    """CLUB-style upper bound on I(e;c): positive against shuffled-negative
    contrast (vi_final :428-439). ``perm`` permutes all B rows, masked ones
    included, as ``jax.random.permutation(rng, B)`` does in the JAX
    package."""
    mu, lv = out["club_mu"], out["club_lv"]
    e = out["z_emotion"]
    positive = -((mu - e) ** 2) / torch.exp(lv)
    negative = -((mu - e[perm]) ** 2) / torch.exp(lv)
    diff = torch.sum(positive, dim=-1) - torch.sum(negative, dim=-1)
    return masked_mean(diff, mask) / 2.0


def gan_disc_losses(out: Dict, cfg: LossConfig, emotion_labels, cause_labels,
                    mask=None):
    """Discriminator BCEs on detached latents (ec_gan :224-240, :458-468)."""
    ec = binary_smoothed_bce(out["ec_disc_logits_sg"], emotion_labels,
                             cfg.label_smoothing, 1, mask)
    ce = binary_smoothed_bce(out["ce_disc_logits_sg"], cause_labels,
                             cfg.label_smoothing, 1, mask)
    return ec, ce


def regularizer_loss(out: Dict, cfg: LossConfig, mask=None,
                     vi_beta: Optional[float] = None,
                     perm: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The weighted disentanglement term added to the main loss.

    mmd: -weight * MMD (flagship :231-233, :256 — the sign flip is the
    trick), through the fused MMD kernel on CUDA; hsic: weight * HSIC
    (ec_hsic :213-214), through the HSIC kernels on CUDA; gan: weight *
    (entropy(ec_disc) + entropy(ce_disc)) (ec_gan :275-279); vi: vi_beta
    (1 when not given) * club_upper with the batch permutation ``perm``
    (vi_final :772-781); none: 0.
    """
    reg = cfg.regularizer
    if reg == Regularizer.NONE:
        return torch.zeros((), dtype=torch.float32,
                           device=out["z_emotion"].device)
    if reg == Regularizer.MMD:
        m = mmd_statistic(out["z_emotion"], out["z_cause"], cfg.mmd_alphas,
                          mask)
        return cfg.mmd_loss_weight * (-m)
    if reg == Regularizer.HSIC:
        h = hsic_statistic(out["z_emotion"], out["z_cause"], cfg.hsic_sigma,
                           cfg.hsic_sigma, mask)
        return cfg.hsic_weight * h
    if reg == Regularizer.GAN:
        ent = (entropy_loss(out["ec_disc_logits"], cfg.epsilon, mask)
               + entropy_loss(out["ce_disc_logits"], cfg.epsilon, mask))
        return cfg.ecce_adv_loss_weight * ent
    if reg == Regularizer.VI:
        if perm is None:
            raise ValueError("the vi regularizer needs the batch permutation")
        beta = 1.0 if vi_beta is None else vi_beta
        return beta * club_upper_loss(out, perm, mask)
    raise ValueError(f"unknown regularizer {reg}")
