"""Transformer encoder (BERT/RoBERTa family), port of carel_tpu/models/encoder.py.

Kept from the JAX encoder:

- BERT positions, and RoBERTa positions ``cumsum(mask) * mask + pad_id``;
- token-type embeddings, the embeddings LayerNorm (eps 1e-12);
- the word, position and token-type lookups as gathers added in that order,
  whose backward, one call of kernel K10 on CUDA for all three tables
  (``ops/cuda_embedding.py: embeddings``), adds in a fixed order, so that
  training repeats its bits on the card;
- the -1e9 additive mask bias, in fp32;
- a fused qkv projection whose output is laid out (3, heads, head_dim);
- the xla attention core (``attention_impl="xla"``, the default): scores
  accumulated in fp32 from the (bf16) q and k, softmax, dropout on the
  probabilities, probabilities @ values (``ops/xla_attention.py``: a
  forward and a backward kernel on CUDA in bf16, its plain ops on the CPU
  and for an fp32 encoder);
- ``attention_impl="flash"``: flash attention with the stock kernel's
  segment mask and no dropout on the probabilities
  (``ops/cuda_attention.py``: kernels K7-K9 on CUDA, its plain version on
  the CPU), on every device. Without dropout both paths give the same
  pooled output and hidden states at real positions; at pad positions they
  differ, since a pad query attends to pad keys under the segment mask;
- exact-erf GELU, post-LN residuals, and a dense+tanh pooler over [CLS];
- under a mesh with a 'model' axis over 1 (``parallel/tp.py:
  shard_params_tp``), the Megatron split: each rank runs its heads (the
  flash kernels on ``h / tp`` heads) and its MLP columns, and the partial
  out and ``mlp_out`` products are summed over 'model' before their bias is
  added once; with ``tp`` None the layers are as above.

With ``dtype="bfloat16"`` the encoder runs under bf16 autocast with LayerNorm
in fp32 and its outputs cast back to bf16, as the JAX encoder computes matmuls
in bf16 with fp32 params. Parameters start from Flax's initialisers
(``init_flax_``), so a run from random init starts from the JAX package's
distribution.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from carel_tpu_torch.config import EncoderConfig
from carel_tpu_torch.ops.cuda_attention import (flash_attention_packed,
                                                segment_ids)
from carel_tpu_torch.ops.cuda_embedding import embeddings
from carel_tpu_torch.ops.xla_attention import attention_ops, xla_attention
from carel_tpu_torch.parallel.tp import copy_to_tp, reduce_from_tp

ATTENTION_IMPLS = ("xla", "flash")

# std of a standard normal truncated to [-2, 2]; Flax's lecun_normal divides
# by it so the truncated draw keeps variance 1/fan_in
_TRUNC_STD = 0.87962566103423978


@torch.no_grad()
def init_flax_(module: nn.Module, generator: torch.Generator) -> None:
    """Initialise every Linear, Embedding and LayerNorm under ``module`` as
    Flax does: lecun-normal (truncated) Dense kernels and zero biases, the
    nn.Embed default N(0, 1/features), LayerNorm ones and zeros; a module
    with parameters of its own initialises them in ``init_flax_own_``."""
    for m in module.modules():
        if isinstance(m, nn.Linear):
            std = math.sqrt(1.0 / m.in_features) / _TRUNC_STD
            nn.init.trunc_normal_(m.weight, 0.0, std, -2.0 * std, 2.0 * std,
                                  generator=generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.Embedding):
            m.weight.normal_(0.0, math.sqrt(1.0 / m.embedding_dim),
                             generator=generator)
        elif isinstance(m, nn.LayerNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
        # a module's parameters of its own (an adapter's query)
        own = getattr(m, "init_flax_own_", None)
        if own is not None:
            own(generator)


class SelfAttention(nn.Module):
    def __init__(self, cfg: EncoderConfig):
        super().__init__()
        if cfg.attention_impl not in ATTENTION_IMPLS:
            raise ValueError(f"attention_impl {cfg.attention_impl!r}: use "
                             f"one of {ATTENTION_IMPLS}")
        self.impl = cfg.attention_impl
        self.num_heads = cfg.num_heads
        self.head_dim = cfg.hidden_dim // cfg.num_heads
        self.dropout = cfg.dropout
        self.qkv = nn.Linear(cfg.hidden_dim, 3 * cfg.hidden_dim)
        self.out = nn.Linear(cfg.hidden_dim, cfg.hidden_dim)
        # the mesh when the heads are split over its 'model' axis
        self.tp = None

    def _qkv(self, x: torch.Tensor) -> torch.Tensor:
        """[B, L, 3, heads, head_dim] over this rank's heads."""
        B, L, _ = x.shape
        if self.tp is None:
            return self.qkv(x).view(B, L, 3, self.num_heads, self.head_dim)
        heads = self.qkv.weight.shape[0] // (3 * self.head_dim)
        lo = self.tp.tp_rank * heads
        # the qkv bias is replicated; each rank reads its heads' part
        b = copy_to_tp(self.qkv.bias, self.tp).view(
            3, self.num_heads, self.head_dim)[:, lo:lo + heads]
        return F.linear(copy_to_tp(x, self.tp), self.qkv.weight,
                        b.reshape(-1)).view(B, L, 3, heads, self.head_dim)

    def _out(self, ctx: torch.Tensor) -> torch.Tensor:
        if self.tp is None:
            return self.out(ctx)
        part = reduce_from_tp(F.linear(ctx, self.out.weight), self.tp)
        return part + self.out.bias.to(part.dtype)

    def forward(self, x: torch.Tensor, bias: torch.Tensor,
                deterministic: bool) -> torch.Tensor:
        """``bias`` is the additive fp32 mask bias [B, 1, 1, L] under "xla"
        and the int32 segment ids [B, L] under "flash"."""
        qkv = self._qkv(x)
        if self.impl == "flash":
            return self._out(flash_attention_packed(
                qkv, bias, 1.0 / math.sqrt(self.head_dim)))
        if qkv.is_cuda and qkv.dtype != torch.bfloat16:
            # an fp32 encoder on CUDA keeps the plain ops
            ctx = attention_ops(qkv, bias, self.dropout, not deterministic)
        else:
            # the kernel pair on CUDA; a CPU tensor takes the plain ops
            ctx = xla_attention(qkv, bias, self.dropout, not deterministic)
        return self._out(ctx)


class EncoderLayer(nn.Module):
    def __init__(self, cfg: EncoderConfig):
        super().__init__()
        self.dropout = cfg.dropout
        self.attention = SelfAttention(cfg)
        self.attention_ln = nn.LayerNorm(cfg.hidden_dim, eps=cfg.layer_norm_eps)
        self.mlp_in = nn.Linear(cfg.hidden_dim, cfg.mlp_dim)
        self.mlp_out = nn.Linear(cfg.mlp_dim, cfg.hidden_dim)
        self.mlp_ln = nn.LayerNorm(cfg.hidden_dim, eps=cfg.layer_norm_eps)
        # the mesh when the MLP columns are split over its 'model' axis
        self.tp = None

    def _mlp(self, x: torch.Tensor) -> torch.Tensor:
        if self.tp is None:
            return self.mlp_out(F.gelu(self.mlp_in(x)))
        h = F.gelu(self.mlp_in(copy_to_tp(x, self.tp)))
        part = reduce_from_tp(F.linear(h, self.mlp_out.weight), self.tp)
        return part + self.mlp_out.bias.to(part.dtype)

    def forward(self, x, bias, deterministic: bool, dtype: torch.dtype):
        training = not deterministic
        attn = F.dropout(self.attention(x, bias, deterministic), self.dropout,
                         training=training)
        x = self.attention_ln(x + attn).to(dtype)
        mlp = self._mlp(x)
        mlp = F.dropout(mlp, self.dropout, training=training)
        return self.mlp_ln(x + mlp).to(dtype)


class TransformerEncoder(nn.Module):
    """BERT-style encoder returning (last_hidden_state, pooler_output)."""

    def __init__(self, cfg: EncoderConfig):
        super().__init__()
        self.cfg = cfg
        d = cfg.hidden_dim
        self.word_embeddings = nn.Embedding(cfg.vocab_size, d)
        self.position_embeddings = nn.Embedding(cfg.max_position, d)
        self.token_type_embeddings = (
            nn.Embedding(cfg.type_vocab_size, d)
            if cfg.type_vocab_size > 0 else None)
        self.embeddings_ln = nn.LayerNorm(d, eps=cfg.layer_norm_eps)
        self.layers = nn.ModuleList(
            EncoderLayer(cfg) for _ in range(cfg.num_layers))
        self.pooler = nn.Linear(d, d)

    def forward(
        self,
        input_ids: torch.Tensor,  # [B, L] int
        attention_mask: torch.Tensor,  # [B, L] int/float
        token_type_ids: Optional[torch.Tensor] = None,  # [B, L] int
        deterministic: bool = True,
        pool: bool = True,
    ):
        """(last hidden state [B, L, D], pooled output [B, D]); with
        ``pool=False`` the pooler does not run and the second is None (the
        adapters read the hidden states only)."""
        cfg = self.cfg
        bf16 = cfg.dtype == "bfloat16"
        dtype = torch.bfloat16 if bf16 else torch.float32
        B, L = input_ids.shape
        input_ids = input_ids.long()
        # no cast cache: each weight is cast once a forward anyway, and a
        # cached cast would outlive a CUDA-graph capture of the step
        with torch.autocast(device_type=input_ids.device.type,
                            dtype=torch.bfloat16, enabled=bf16,
                            cache_enabled=False):
            if cfg.arch == "roberta":
                # HF RoBERTa position ids: pads get pad_token_id; real tokens
                # count from pad_token_id + 1
                mask = attention_mask.long()
                positions = torch.cumsum(mask, dim=1) * mask + cfg.pad_token_id
            else:
                positions = torch.arange(
                    L, device=input_ids.device)[None, :].expand(B, L)
            ids = [input_ids, positions]
            tables = [self.word_embeddings.weight,
                      self.position_embeddings.weight]
            if self.token_type_embeddings is not None:
                if token_type_ids is None:
                    token_type_ids = torch.zeros_like(input_ids)
                ids.append(token_type_ids.long())
                tables.append(self.token_type_embeddings.weight)
            # (word + position) + token type, one backward for all three
            x = embeddings(ids, tables)
            x = self.embeddings_ln(x).to(dtype)
            x = F.dropout(x, cfg.dropout, training=not deterministic)

            if cfg.attention_impl == "flash":
                # the flash path masks by segment: real tokens 1, pads 0
                bias = segment_ids(attention_mask)
            else:
                # additive mask bias, fp32 so the softmax stays stable
                bias = (1.0 - attention_mask.float()) * -1e9
                bias = bias[:, None, None, :]
            for layer in self.layers:
                x = layer(x, bias, deterministic, dtype)
            pooled = torch.tanh(self.pooler(x[:, 0])) if pool else None
        return x, pooled


def tiny_encoder_config(vocab_size: int = 512, **kw) -> EncoderConfig:
    """A 2-layer toy encoder for CPU-runnable tests and smoke training."""
    defaults = dict(
        vocab_size=vocab_size,
        hidden_dim=64,
        num_layers=2,
        num_heads=4,
        mlp_dim=128,
        max_position=160,
        type_vocab_size=2,
        dropout=0.1,
        dtype="float32",
    )
    defaults.update(kw)
    return EncoderConfig(**defaults)
