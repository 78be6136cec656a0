"""Classifier losses: emotion CE, cause BCE, pos-weighted pair BCE.

Port of carel_tpu/losses/classify.py (reference get_emotion_mul_loss /
get_cause_mul_loss / get_pair_mul_loss, flagship :461-513, and the GAN
variant's entropy loss, ec_gan :486-495). All computed from logits with
masked means so padded rows are inert.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def masked_mean(x: torch.Tensor, mask=None) -> torch.Tensor:
    if mask is None:
        return torch.mean(x)
    return torch.sum(x * mask) / torch.clamp(torch.sum(mask), min=1.0)


def emotion_ce_loss(logits: torch.Tensor, labels: torch.Tensor,
                    mask=None) -> torch.Tensor:
    """6-class cross entropy on the sampled emotion latent (flagship :461-476)."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, 1, labels.long()[:, None])[:, 0]
    return masked_mean(nll, mask)


def binary_smoothed_bce(
    logits: torch.Tensor,  # [B, 1]
    labels: torch.Tensor,  # [B] float
    label_smoothing: float,
    num_class: int = 1,
    mask=None,
) -> torch.Tensor:
    """BCE(sigmoid(logits), labels*(1-ls)+ls/num_class), numerically stable
    from logits (flagship :478-492)."""
    target = labels * (1.0 - label_smoothing) + label_smoothing / num_class
    x = logits[:, 0].float()
    per = torch.clamp(x, min=0.0) - x * target + torch.log1p(
        torch.exp(-torch.abs(x)))
    return masked_mean(per, mask)


def cause_bce_loss(logits, labels, label_smoothing, mask=None):
    return binary_smoothed_bce(logits, labels, label_smoothing, 1, mask)


def pair_bce_pos_weighted(
    logits: torch.Tensor,  # [B, 1]
    labels: torch.Tensor,  # [B] float 0/1
    label_smoothing: float,
    mask=None,
) -> torch.Tensor:
    """BCEWithLogits with per-batch pos_weight = (N-P)/P and the reference's
    inf-guard: a batch with no positives (pos_weight = inf) gives zero loss
    (flagship :494-513)."""
    if mask is None:
        mask = torch.ones_like(labels)
    n = torch.sum(mask)
    p = torch.sum(labels * mask)
    pos_weight = (n - p) / torch.clamp(p, min=1.0)

    target = labels * (1.0 - label_smoothing) + label_smoothing
    x = logits[:, 0].float()
    per = -(pos_weight * target * F.logsigmoid(x)
            + (1.0 - target) * F.logsigmoid(-x))
    loss = masked_mean(per, mask)
    return torch.where(p > 0, loss, torch.zeros_like(loss))



def entropy_loss(logits: torch.Tensor, epsilon: float = 1e-8,
                 mask=None) -> torch.Tensor:
    """Negative entropy of sigmoid predictions, mean(sum(p * log(p + eps)))
    (ec_gan :486-495): minimizing it drives the adversary toward
    uncertainty."""
    p = torch.sigmoid(logits.float())
    per = torch.sum(p * torch.log(p + epsilon), dim=-1)
    return masked_mean(per, mask)
