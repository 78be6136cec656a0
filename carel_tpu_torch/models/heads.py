"""VAE heads over the encoder output, port of carel_tpu/models/heads.py.

The reference's DrlClassifier head stack (flagship :164-182): the two
diagonal-Gaussian latents (emotion/cause mu + log_var), the three classifiers
and the BoW softmax decoder. The attention adapters (newsplit :184-331) are
not ported yet.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from carel_tpu_torch.config import ModelConfig


def sample_prior(
    mu: torch.Tensor,
    log_var: torch.Tensor,
    compat: bool = True,
    eps: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Reparameterized sample from N(mu, sigma).

    compat=True reproduces the reference quirk (flagship :345-351): ONE noise
    vector of shape (ec_dim,) shared across the batch, and std = exp(log_var)
    (not exp(0.5 * log_var)). compat=False is the textbook VAE sampling with
    per-example noise. ``eps`` supplies the noise; otherwise it is drawn from
    ``generator`` (a generator on mu's device).
    """
    shape = (mu.shape[-1],) if compat else mu.shape
    if eps is None:
        eps = torch.randn(shape, generator=generator, device=mu.device,
                          dtype=mu.dtype)
    if compat:
        return mu + eps[None, :] * torch.exp(log_var)
    return mu + eps * torch.exp(0.5 * log_var)


class VaeHeads(nn.Module):
    """Latent heads + classifiers + BoW decoder (flagship :164-182)."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        d, ec = cfg.encoder.hidden_dim, cfg.ec_dim
        self.emotion_mu = nn.Linear(d, ec)
        self.emotion_log_var = nn.Linear(d, ec)
        self.cause_mu = nn.Linear(d, ec)
        self.cause_log_var = nn.Linear(d, ec)
        e_classes = 1 if cfg.binary_emotion else cfg.e_num_class
        self.emotion_classifier = nn.Linear(ec, e_classes)
        self.cause_classifier = nn.Linear(ec, cfg.c_num_class)
        self.pair_classifier = nn.Linear(2 * ec, cfg.pair_num_class)
        self.decoder = nn.Linear(2 * ec, cfg.bow_dim)
        self.dropout = cfg.dropout

    def latent_params(self, emotion_feat, cause_feat):
        return (
            self.emotion_mu(emotion_feat),
            self.emotion_log_var(emotion_feat),
            self.cause_mu(cause_feat),
            self.cause_log_var(cause_feat),
        )

    def _drop(self, x, deterministic: bool):
        return F.dropout(x, self.dropout, training=not deterministic)

    def emotion_logits(self, z_e, deterministic: bool = True):
        return self.emotion_classifier(self._drop(z_e, deterministic))

    def cause_logits(self, z_c, deterministic: bool = True):
        return self.cause_classifier(self._drop(z_c, deterministic))

    def pair_logits(self, pair_emb, deterministic: bool = True):
        return self.pair_classifier(self._drop(pair_emb, deterministic))

    def decode(self, generative_emb):
        return self.decoder(generative_emb)
