"""Disentanglement-regularizer registry, port of carel_tpu/losses/registry.py.

One entry per reference trainer family (SURVEY.md §2.2). Ported so far:
none, mmd and hsic. The gan and vi terms raise NotImplementedError until
their ROADMAP items land.
"""

from __future__ import annotations

from typing import Dict

import torch

from carel_tpu_torch.config import LossConfig, Regularizer
from carel_tpu_torch.ops.cuda_pairwise import hsic_statistic, mmd_statistic

_NOT_PORTED = {
    Regularizer.GAN: "ROADMAP Queue 1: gan/vi steps",
    Regularizer.VI: "ROADMAP Queue 1: gan/vi steps",
}


def regularizer_loss(out: Dict, cfg: LossConfig, mask=None) -> torch.Tensor:
    """The weighted disentanglement term added to the main loss.

    mmd: -weight * MMD (flagship :231-233, :256 — the sign flip is the
    trick), through the fused MMD kernel on CUDA; hsic: weight * HSIC
    (ec_hsic :213-214), through the HSIC kernels on CUDA; none: 0.
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
    if reg in _NOT_PORTED:
        raise NotImplementedError(
            f"regularizer {reg.value!r} is not ported to carel_tpu_torch yet "
            f"({_NOT_PORTED[reg]})")
    raise ValueError(f"unknown regularizer {reg}")
