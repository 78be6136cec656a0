"""DeepSeek-V2 as the pair classifier's encoder (DeepSeek-AI 2024,
arXiv:2405.04434; the published ``modeling_deepseek.py``:
DeepseekV2RMSNorm, DeepseekV2YarnRotaryEmbedding, DeepseekV2Attention,
DeepseekV2MLP, MoEGate, DeepseekV2MoE), used as
``DeepseekV2ForSequenceClassification`` uses it: the final RMSNorm's hidden
state at each row's last real token is the pooled output that the CAREL
heads read. ``DrlModel`` builds it when ``cfg.encoder.arch`` is
"deepseek_v2" (``config.DeepseekV2Config``).

A layer is pre-norm: ``x + attention(norm(x))``, then ``x + mlp(norm(x))``;
the first ``first_k_dense_replace`` layers have a dense SwiGLU MLP, the rest
a mixture of experts. Kept from the published model:

- RMSNorm computed in fp32 and cast back, the weight times the cast;
- multi-head latent attention without q compression: q = q_proj(x) as
  [heads, nope | rope]; kv_a_proj_with_mqa(x) = [latent | k_pe], the
  latent through RMSNorm and kv_b_proj to [heads, k_nope | v]; one rope key
  k_pe shared by the heads; the checkpoint's interleaved rope layout
  de-interleaved before ``rotate_half``; YaRN frequencies and the softmax
  scale (q_head_dim^-1/2 m^2, m = 0.1 mscale_all_dim ln(factor) + 1);
  causal attention plus the pad keys as an fp32 additive bias; no
  attention dropout (the model has none);
- the gate: fp32 logits of the fp32 input, softmax, greedy top-k, no
  renormalisation (``norm_topk_prob`` False), times
  ``routed_scaling_factor``; the routed experts' outputs summed with those
  weights in fp32 and cast once; the shared experts as one SwiGLU of width
  ``n_shared_experts x moe_intermediate_size``, added to that.

Departures, shared with the plain references: the top-k slots are in
descending order of weight (the published gate asks ``sorted=False``);
rotary positions are applied in fp32 to the bf16 q and k; the residual
stream is kept in fp32 between layers (the sublayers run in bf16 under
autocast with fp32 master weights); no balance loss (``aux_loss_alpha`` is
0 here).

Expert parallelism as one rank sees it: the layer holds the routed experts
``cfg.held_range()``, routes over all of them, and computes its experts'
part for the tokens routed to them (``ops/moe.py``); the absent experts'
part is left out. No code stands in for the other ranks. The mixture
layers add, on the device, the rows routed to held experts, the rows their
buffers were sized for, and the largest count of one expert in one layer
and step, into ``moe_counters`` ([3] int64, a buffer of the encoder; the
epoch step reads it with the losses).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from carel_tpu_torch.config import DeepseekV2Config
from carel_tpu_torch.models.encoder import _TRUNC_STD
from carel_tpu_torch.ops import moe
from carel_tpu_torch.ops.cuda_embedding import embeddings
from carel_tpu_torch.ops.xla_attention import attention_scores

# moe_counters: rows routed to held experts, rows the buffers were sized
# for, the largest count of one held expert in one layer and step
HELD_ROWS, BUFFER_ROWS, MAX_EXPERT_ROWS = 0, 1, 2


@torch.no_grad()
def _lecun_(w: torch.Tensor, fan_in: int, generator) -> None:
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std,
                          generator=generator)


class RMSNorm(nn.Module):
    def __init__(self, d: int, eps: float):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(d))
        self.eps = eps

    def init_flax_own_(self, generator) -> None:
        with torch.no_grad():
            self.weight.fill_(1.0)

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        with torch.autocast(device_type=x.device.type, enabled=False):
            y = x.float()
            y = y * torch.rsqrt(y.pow(2).mean(-1, keepdim=True) + self.eps)
            return (self.weight * y.to(dtype)).to(dtype)


def yarn_get_mscale(scale: float, mscale: float = 1.0) -> float:
    if scale <= 1:
        return 1.0
    return 0.1 * mscale * math.log(scale) + 1.0


def yarn_inv_freq(cfg: DeepseekV2Config, device=None) -> torch.Tensor:
    """The YaRN inverse frequencies [rope_dim / 2], fp32, made on
    ``device`` (a captured step copies nothing from the host)."""
    dim, base = cfg.qk_rope_head_dim, cfg.rope_theta
    orig = cfg.rope_original_max_position

    def correction_dim(rot):
        return (dim * math.log(orig / (rot * 2 * math.pi))) / (
            2 * math.log(base))

    low = max(math.floor(correction_dim(cfg.rope_beta_fast)), 0)
    high = min(math.ceil(correction_dim(cfg.rope_beta_slow)), dim - 1)
    if low == high:
        high += 0.001
    exps = torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim
    freq_extra = 1.0 / (base ** exps)
    freq_inter = 1.0 / (cfg.rope_factor * base ** exps)
    ramp = torch.clamp((torch.arange(dim // 2, dtype=torch.float32,
                                     device=device) - low)
                       / (high - low), 0, 1)
    extra = 1.0 - ramp
    return freq_inter * (1 - extra) + freq_extra * extra


def rope_cos_sin(cfg: DeepseekV2Config, L: int, device):
    """(cos, sin) [L, rope_dim] fp32 of positions 0..L-1."""
    inv = yarn_inv_freq(cfg, device)
    freqs = torch.outer(torch.arange(L, device=device, dtype=torch.float32),
                        inv)
    m = yarn_get_mscale(cfg.rope_factor, cfg.rope_mscale) / \
        yarn_get_mscale(cfg.rope_factor, cfg.rope_mscale_all_dim)
    emb = torch.cat([freqs, freqs], dim=-1)
    return emb.cos() * m, emb.sin() * m


def softmax_scale(cfg: DeepseekV2Config) -> float:
    m = yarn_get_mscale(cfg.rope_factor, cfg.rope_mscale_all_dim)
    return (cfg.qk_nope_head_dim + cfg.qk_rope_head_dim) ** -0.5 * m * m


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """Rotary positions on x [B, h, L, d] in fp32, the checkpoint's
    interleaved pairs de-interleaved first."""
    b, h, s, d = x.shape
    x = x.float().view(b, h, s, d // 2, 2).transpose(4, 3).reshape(b, h, s, d)
    rot = torch.cat([-x[..., d // 2:], x[..., :d // 2]], dim=-1)
    return x * cos + rot * sin


def attention_bias(attention_mask: torch.Tensor) -> torch.Tensor:
    """[B, 1, L, L] fp32: 0 where query i may read key j (j <= i and j a
    real token), -1e9 elsewhere."""
    L = attention_mask.shape[1]
    causal = torch.ones(L, L, dtype=torch.bool,
                        device=attention_mask.device).tril()
    ok = causal[None] & (attention_mask[:, None, :] != 0)
    return torch.where(ok, 0.0, -1e9)[:, None].float()


class LatentAttention(nn.Module):
    """Multi-head latent attention (MLA), no q compression."""

    def __init__(self, cfg: DeepseekV2Config):
        super().__init__()
        if cfg.qk_rope_head_dim % 2:
            raise ValueError("the rope head size must be even")
        d, h = cfg.hidden_dim, cfg.num_heads
        self.h = h
        self.nope, self.rope = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
        self.v_dim, self.lora = cfg.v_head_dim, cfg.kv_lora_rank
        self.scale = softmax_scale(cfg)
        self.q_proj = nn.Linear(d, h * (self.nope + self.rope), bias=False)
        self.kv_a_proj_with_mqa = nn.Linear(d, self.lora + self.rope,
                                            bias=False)
        self.kv_a_ln = RMSNorm(self.lora, cfg.layer_norm_eps)
        self.kv_b_proj = nn.Linear(self.lora, h * (self.nope + self.v_dim),
                                   bias=False)
        self.o_proj = nn.Linear(h * self.v_dim, d, bias=False)

    def forward(self, x, bias, cos, sin, dtype):
        B, L, _ = x.shape
        h = self.h
        q = self.q_proj(x).view(B, L, h, -1).transpose(1, 2)
        q_nope, q_pe = q.split([self.nope, self.rope], dim=-1)
        latent, k_pe = self.kv_a_proj_with_mqa(x).split(
            [self.lora, self.rope], dim=-1)
        k_pe = k_pe.reshape(B, L, 1, self.rope).transpose(1, 2)
        kv = self.kv_b_proj(self.kv_a_ln(latent, dtype)).view(
            B, L, h, -1).transpose(1, 2)
        k_nope, v = kv.split([self.nope, self.v_dim], dim=-1)
        q_pe = apply_rope(q_pe, cos, sin).to(dtype)
        k_pe = apply_rope(k_pe, cos, sin).to(dtype)
        q = torch.cat([q_nope.to(dtype), q_pe], dim=-1)
        k = torch.cat([k_nope.to(dtype), k_pe.expand(B, h, L, self.rope)],
                      dim=-1)
        # fp32 sums of the bf16 q, k products; softmax in fp32
        with torch.autocast(device_type=x.device.type, enabled=False):
            scores = attention_scores(q, k) * self.scale
        probs = torch.softmax(scores + bias, dim=-1).to(v.dtype)
        ctx = (probs @ v).transpose(1, 2).reshape(B, L, h * self.v_dim)
        return self.o_proj(ctx)


class SwiGLU(nn.Module):
    def __init__(self, d: int, width: int):
        super().__init__()
        self.gate_proj = nn.Linear(d, width, bias=False)
        self.up_proj = nn.Linear(d, width, bias=False)
        self.down_proj = nn.Linear(width, d, bias=False)

    def forward(self, x):
        return self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))


class RoutedExperts(nn.Module):
    """The held experts' SwiGLU weights, stacked: ``gate_up`` [held, 2 I,
    D] (each expert's gate rows, then its up rows) and ``down`` [held, D,
    I]."""

    def __init__(self, d: int, width: int, held: int):
        super().__init__()
        self.gate_up = nn.Parameter(torch.empty(held, 2 * width, d))
        self.down = nn.Parameter(torch.empty(held, d, width))

    def init_flax_own_(self, generator) -> None:
        _lecun_(self.gate_up, self.gate_up.shape[2], generator)
        _lecun_(self.down, self.down.shape[2], generator)


class MoE(nn.Module):
    def __init__(self, cfg: DeepseekV2Config,
                 counters: Optional[torch.Tensor] = None):
        super().__init__()
        d, width = cfg.hidden_dim, cfg.moe_intermediate_size
        self.top_k = cfg.num_experts_per_tok
        self.first, self.held = cfg.held_range()
        self.norm_topk_prob = cfg.norm_topk_prob
        self.scaling = cfg.routed_scaling_factor
        self.gate = nn.Parameter(torch.empty(cfg.n_routed_experts, d))
        self.experts = RoutedExperts(d, width, self.held)
        self.shared_experts = SwiGLU(d, width * cfg.n_shared_experts)
        # the encoder's moe_counters, or None
        self.counters = counters
        # a list that collects each forward's top-k expert ids when set
        self.record = None

    def init_flax_own_(self, generator) -> None:
        _lecun_(self.gate, self.gate.shape[1], generator)

    def route(self, x: torch.Tensor):
        """(weights [T, k] fp32, expert ids [T, k]) of x [T, D]."""
        with torch.autocast(device_type=x.device.type, enabled=False):
            logits = F.linear(x.float(), self.gate.float())
            scores = logits.softmax(dim=-1, dtype=torch.float32)
            weights, ids = torch.topk(scores, self.top_k, dim=-1,
                                      sorted=True)
            if self.norm_topk_prob:
                weights = weights / (weights.sum(-1, keepdim=True) + 1e-20)
            return weights * self.scaling, ids

    def routed(self, x: torch.Tensor) -> torch.Tensor:
        """The held experts' part of the layer's output for x [T, D]."""
        weights, ids = self.route(x)
        if self.record is not None:
            self.record.append(ids.detach())
        plan = moe.dispatch(ids, self.first, self.held)
        if self.counters is not None:
            with torch.no_grad():
                c = self.counters
                c[HELD_ROWS] += plan.counts.sum()
                c[BUFFER_ROWS] += plan.rows
                c[MAX_EXPERT_ROWS] = torch.maximum(c[MAX_EXPERT_ROWS],
                                                   plan.counts.max())
        return moe.routed_experts(x, weights, plan, self.experts.gate_up,
                                  self.experts.down)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, L, D = x.shape
        xt = x.reshape(B * L, D)
        return (self.routed(xt) + self.shared_experts(xt)).view(B, L, D)


class DecoderLayer(nn.Module):
    def __init__(self, cfg: DeepseekV2Config, dense: bool,
                 counters: Optional[torch.Tensor]):
        super().__init__()
        self.input_ln = RMSNorm(cfg.hidden_dim, cfg.layer_norm_eps)
        self.self_attn = LatentAttention(cfg)
        self.post_attention_ln = RMSNorm(cfg.hidden_dim, cfg.layer_norm_eps)
        self.mlp = SwiGLU(cfg.hidden_dim, cfg.mlp_dim) if dense \
            else MoE(cfg, counters)

    def forward(self, x, bias, cos, sin, dtype):
        x = x + self.self_attn(self.input_ln(x, dtype), bias, cos, sin, dtype)
        return x + self.mlp(self.post_attention_ln(x, dtype))


class DeepseekV2Encoder(nn.Module):
    """(hidden states [B, L, D] after the final RMSNorm, pooled [B, D]: the
    hidden state at each row's last real token) of right-padded rows."""

    def __init__(self, cfg: DeepseekV2Config):
        super().__init__()
        self.cfg = cfg
        cfg.held_range()
        if cfg.type_vocab_size or cfg.dropout:
            raise ValueError("DeepSeek-V2 has no token types and no dropout")
        if cfg.attention_impl != "xla":
            raise ValueError("the DeepSeek-V2 encoder runs its attention as "
                             "plain ops (attention_impl 'xla')")
        self.register_buffer("moe_counters",
                             torch.zeros(3, dtype=torch.long),
                             persistent=False)
        self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.hidden_dim)
        self.layers = nn.ModuleList(
            DecoderLayer(cfg, i < cfg.first_k_dense_replace,
                         self.moe_counters)
            for i in range(cfg.num_layers))
        self.final_ln = RMSNorm(cfg.hidden_dim, cfg.layer_norm_eps)
        # the mesh, when one is set: tensor parallelism is not supported
        self.tp = None

    def _apply(self, fn, recurse=True):
        # .to() and .cuda() replace the buffer; the layers follow it
        super()._apply(fn, recurse)
        for m in self.moe_layers():
            m.counters = self.moe_counters
        return self

    def moe_layers(self):
        return [layer.mlp for layer in self.layers
                if isinstance(layer.mlp, MoE)]

    def forward(self, input_ids, attention_mask, token_type_ids=None,
                deterministic: bool = True, pool: bool = True):
        """``token_type_ids`` and ``deterministic`` are accepted and unused
        (no token types, no dropout)."""
        cfg = self.cfg
        bf16 = cfg.dtype == "bfloat16"
        dtype = torch.bfloat16 if bf16 else torch.float32
        B, L = input_ids.shape
        with torch.autocast(device_type=input_ids.device.type,
                            dtype=torch.bfloat16, enabled=bf16,
                            cache_enabled=False):
            x = embeddings([input_ids.long()], [self.embed_tokens.weight])
            x = x.float()
            bias = attention_bias(attention_mask)
            cos, sin = rope_cos_sin(cfg, L, input_ids.device)
            for layer in self.layers:
                x = layer(x, bias, cos, sin, dtype)
            x = self.final_ln(x, dtype)
            pooled = None
            if pool:
                last = attention_mask.long().sum(1) - 1
                pooled = x[torch.arange(B, device=x.device), last]
        return x, pooled
