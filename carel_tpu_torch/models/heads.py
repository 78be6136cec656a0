"""VAE heads and attention adapters over the encoder output, port of
carel_tpu/models/heads.py.

The reference's DrlClassifier head stack (flagship :164-182): the two
diagonal-Gaussian latents (emotion/cause mu + log_var), the three classifiers
and the BoW softmax decoder; and the newsplit attention adapters (newsplit
:184-331): a learnable query attending over the last hidden state with
softmax ('raw'), sparsemax or entmax15 attention.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from carel_tpu_torch.config import AdapterKind, ModelConfig
from carel_tpu_torch.ops.entmax import entmax15, sparsemax


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


class DotProductAttention(nn.Module):
    """Flax's ``MultiHeadDotProductAttention`` as the raw adapter calls it:
    ``num_heads`` heads, qkv_features = out_features = D, no dropout, the
    padding mask as a key mask, computed at the inputs' dtype (the fp32
    params cast to it, as Flax's ``dtype=hidden.dtype`` promotes them).
    The projections are Linear layers named as Flax's (``query``, ``key``,
    ``value``, ``out``); convert.py maps its kernels [D, heads, head_dim]
    and [heads, head_dim, D] onto them. The query is scaled by
    1/sqrt(head_dim) before the scores, masked scores take the dtype's
    most negative value, and the softmax runs over the keys."""

    def __init__(self, hidden_dim: int, num_heads: int):
        super().__init__()
        if hidden_dim % num_heads:
            raise ValueError(f"hidden_dim {hidden_dim} is not a multiple of "
                             f"head_number {num_heads}")
        self.num_heads = num_heads
        self.query = nn.Linear(hidden_dim, hidden_dim)
        self.key = nn.Linear(hidden_dim, hidden_dim)
        self.value = nn.Linear(hidden_dim, hidden_dim)
        self.out = nn.Linear(hidden_dim, hidden_dim)

    def forward(self, inputs_q: torch.Tensor, inputs_kv: torch.Tensor,
                mask: torch.Tensor) -> torch.Tensor:
        dtype = inputs_kv.dtype
        B, _, D = inputs_kv.shape
        h = self.num_heads
        hd = D // h

        def proj(layer, x):  # [B, n, D] -> [B, n, heads, head_dim]
            return F.linear(x, layer.weight.to(dtype),
                            layer.bias.to(dtype)).view(B, -1, h, hd)

        q = proj(self.query, inputs_q)
        k = proj(self.key, inputs_kv)
        v = proj(self.value, inputs_kv)
        # Flax divides by sqrt(head_dim) rounded to the dtype
        q = q / float(torch.tensor(math.sqrt(hd)).to(dtype))
        scores = torch.einsum("bqhd,bkhd->bhqk", q, k)
        keep = mask[:, None, None, :] > 0
        scores = torch.where(keep, scores, torch.finfo(dtype).min)
        weights = torch.softmax(scores, dim=-1).to(dtype)
        ctx = torch.einsum("bhqk,bkhd->bqhd", weights, v).reshape(B, -1, D)
        return F.linear(ctx, self.out.weight.to(dtype),
                        self.out.bias.to(dtype))


class AttentionAdapter(nn.Module):
    """One learnable query ``[1, 1, D]`` (N(0, 1) init) attending over the
    sequence, broadcast over the batch (newsplit :184-331).

    kind=RAW is standard multi-head softmax attention with an output
    projection (the reference's nn.MultiheadAttention, newsplit :299-301),
    at the hidden states' dtype. kind=SPARSEMAX / ENTMAX are the reference's
    custom subclasses (newsplit :184-277): q and k projections in fp32
    (outside autocast), scores q.k / sqrt(D) with -1e9 where the mask is 0,
    the sparse transform over the key positions, and the output taken
    against the UNPROJECTED hidden states (their ``.matmul(value)``) in
    fp32, cast back to the hidden dtype. ``v_proj`` is held so that the
    checkpoint has the reference's shape; its output is never used, so it
    is never computed (XLA drops it in the JAX package) and it gets no
    gradient."""

    def __init__(self, hidden_dim: int, num_heads: int, kind: AdapterKind):
        super().__init__()
        self.kind = kind
        self.query = nn.Parameter(torch.zeros(1, 1, hidden_dim))
        if kind == AdapterKind.RAW:
            self.mha = DotProductAttention(hidden_dim, num_heads)
        else:
            self.q_proj = nn.Linear(hidden_dim, hidden_dim)
            self.k_proj = nn.Linear(hidden_dim, hidden_dim)
            self.v_proj = nn.Linear(hidden_dim, hidden_dim)

    @torch.no_grad()
    def init_flax_own_(self, generator: torch.Generator) -> None:
        """The query's init, Flax's normal(1.0); init_flax_ initialises the
        Linear layers."""
        self.query.normal_(0.0, 1.0, generator=generator)

    def forward(self, hidden: torch.Tensor,
                mask: torch.Tensor) -> torch.Tensor:
        """hidden [B, L, D], mask [B, L] (1 = real token) -> [B, D] in the
        hidden states' dtype."""
        B, _, D = hidden.shape
        q = self.query.expand(B, 1, D).to(hidden.dtype)
        if self.kind == AdapterKind.RAW:
            return self.mha(q, hidden, mask)[:, 0, :]
        with torch.autocast(device_type=hidden.device.type, enabled=False):
            h32 = hidden.float()
            qp = self.q_proj(q.float())
            kp = self.k_proj(h32)
            scores = torch.einsum("bqd,bkd->bqk", qp, kp) / math.sqrt(D)
            scores = torch.where(mask[:, None, :] > 0, scores, -1e9)
            if self.kind == AdapterKind.SPARSEMAX:
                weights = sparsemax(scores)
            else:
                weights = entmax15(scores)
            out = torch.einsum("bqk,bkd->bqd", weights, h32)
        return out[:, 0, :].to(hidden.dtype)


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
