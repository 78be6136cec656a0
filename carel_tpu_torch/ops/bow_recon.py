"""BoW reconstruction loss from dense decoder logits, plain PyTorch.

Reference semantics (carel_tpu/ops/bow_recon.py):

    pred   = softmax(decoder(latents))                   # [B, V]
    target = bow * (1 - ls) + ls / V                     # label smoothing
    loss   = BCE(pred, target)  (mean over real rows x V)

with torch's nn.BCELoss clamp of each log at -100. The BoW targets arrive
sparse (term indices [B, T] padded with -1, normalized counts [B, T]) and are
densified per batch on the device. The training step does not use this path:
it calls the fused loss of ``ops/cuda_bow.py``, which never stores the
[B, V] logits.
"""

from __future__ import annotations

from typing import Optional

import torch


def densify_bow(bow_indices: torch.Tensor, bow_weights: torch.Tensor,
                vocab_size: int) -> torch.Tensor:
    """Scatter-add sparse (indices with -1 padding, weights) to a dense
    [B, V] float32 matrix; duplicate indices add up."""
    B = bow_indices.shape[0]
    valid = bow_indices >= 0
    safe = torch.where(valid, bow_indices, 0).long()
    w = torch.where(valid, bow_weights.float(), 0.0)
    dense = torch.zeros(B, vocab_size, dtype=torch.float32,
                        device=bow_weights.device)
    return dense.scatter_add_(1, safe, w)


def _bce(pred: torch.Tensor, target: torch.Tensor, eps: float = 1e-12):
    # torch nn.BCELoss clamps log to >= -100
    logp = torch.clamp(torch.log(torch.clamp(pred, min=eps)), min=-100.0)
    log1mp = torch.clamp(torch.log(torch.clamp(1.0 - pred, min=eps)),
                         min=-100.0)
    return -(target * logp + (1.0 - target) * log1mp)


def bow_reconstruction_loss(
    decoder_logits: torch.Tensor,  # [B, V]
    bow_indices: torch.Tensor,  # [B, T]
    bow_weights: torch.Tensor,  # [B, T]
    label_smoothing: float = 0.1,
    example_mask: Optional[torch.Tensor] = None,  # [B]
) -> torch.Tensor:
    """Mean BCE(softmax(logits), smoothed bow) over real examples."""
    V = decoder_logits.shape[1]
    pred = torch.softmax(decoder_logits.float(), dim=-1)
    bow = densify_bow(bow_indices, bow_weights, V)
    target = bow * (1.0 - label_smoothing) + label_smoothing / V
    per_example = torch.mean(_bce(pred, target), dim=-1)
    if example_mask is None:
        return torch.mean(per_example)
    denom = torch.clamp(torch.sum(example_mask), min=1.0)
    return torch.sum(per_example * example_mask) / denom
