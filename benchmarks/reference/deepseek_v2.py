"""A DeepSeek-V2 encoder (DeepSeek-AI 2024, arXiv:2405.04434) over a dict
of fp32 tensors, as the published ``modeling_deepseek.py`` computes it
(DeepseekV2RMSNorm, DeepseekV2YarnRotaryEmbedding, DeepseekV2Attention
without q compression, MoEGate with greedy top-k over an fp32 softmax,
DeepseekV2MoE, DeepseekV2MLP), used as a sequence classifier: the final
RMSNorm's hidden state at each row's last real token is the pooled output.
Plain torch: the routed experts are a Python loop over the held experts,
each over the tokens its own gate sent to it. No kernel of the program.

``c`` holds the model's config.json keys with ``n_routed_experts`` the
router's width; ``held`` = (first, count) is the range of routed experts
this share holds, whose part alone is computed, as the program computes
it. Products that the configuration runs in bf16 go through ``num.linear``
/ ``num.bmm`` (``Numerics``); the gate's logits, fp32 in the
configuration, through ``num.head_linear``.

Departures from the published model, shared with the program: the top-k
slots in descending order (the published gate asks ``sorted=False``); the
residual stream in fp32; no balance loss (``aux_loss_alpha`` 0). The
tensors' names are the program's keys; each expert stack is one matrix
[held x rows, cols], which the program views as [held, rows, cols].
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from reference.numerics import Numerics


def encoder_spec(c: dict, held: Tuple[int, int],
                 prefix: str = "encoder.") -> List[Tuple[str, tuple]]:
    """(name, shape) of every tensor of the encoder."""
    d, h = c["hidden_size"], c["num_attention_heads"]
    nope, rope, vd = (c["qk_nope_head_dim"], c["qk_rope_head_dim"],
                      c["v_head_dim"])
    lora, mi = c["kv_lora_rank"], c["moe_intermediate_size"]
    n = held[1]
    spec = [("embed_tokens.weight", (c["vocab_size"], d))]
    for i in range(c["num_hidden_layers"]):
        p = f"layers.{i}."
        spec += [(p + "input_ln.weight", (d,)),
                 (p + "self_attn.q_proj.weight", (h * (nope + rope), d)),
                 (p + "self_attn.kv_a_proj_with_mqa.weight", (lora + rope, d)),
                 (p + "self_attn.kv_a_ln.weight", (lora,)),
                 (p + "self_attn.kv_b_proj.weight", (h * (nope + vd), lora)),
                 (p + "self_attn.o_proj.weight", (d, h * vd)),
                 (p + "post_attention_ln.weight", (d,))]
        if i < c["first_k_dense_replace"]:
            f = c["intermediate_size"]
            spec += [(p + "mlp.gate_proj.weight", (f, d)),
                     (p + "mlp.up_proj.weight", (f, d)),
                     (p + "mlp.down_proj.weight", (d, f))]
        else:
            s = mi * c["n_shared_experts"]
            spec += [(p + "mlp.gate", (c["n_routed_experts"], d)),
                     (p + "mlp.experts.gate_up", (n * 2 * mi, d)),
                     (p + "mlp.experts.down", (n * d, mi)),
                     (p + "mlp.shared_experts.gate_proj.weight", (s, d)),
                     (p + "mlp.shared_experts.up_proj.weight", (s, d)),
                     (p + "mlp.shared_experts.down_proj.weight", (d, s))]
    spec.append(("final_ln.weight", (d,)))
    return [(prefix + name, shape) for name, shape in spec]


def rms_norm(x, w, eps):
    x = x.float()
    return w * (x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps))


def _mscale(scale, m=1.0):
    return 1.0 if scale <= 1 else 0.1 * m * math.log(scale) + 1.0


def rope_tables(c: dict, L: int, device):
    """YaRN's (cos, sin) [L, rope dim] in fp32 and the softmax scale."""
    rs = c["rope_scaling"]
    dim, base = c["qk_rope_head_dim"], c["rope_theta"]
    orig, factor = rs["original_max_position_embeddings"], rs["factor"]

    def corr(rot):
        return dim * math.log(orig / (rot * 2 * math.pi)) / (
            2 * math.log(base))

    low = max(math.floor(corr(rs["beta_fast"])), 0)
    high = min(math.ceil(corr(rs["beta_slow"])), dim - 1)
    if low == high:
        high += 0.001
    pos = torch.arange(0, dim, 2, dtype=torch.float32) / dim
    extra, inter = 1.0 / base ** pos, 1.0 / (factor * base ** pos)
    mask = 1.0 - ((torch.arange(dim // 2, dtype=torch.float32) - low)
                  / (high - low)).clamp(0, 1)
    inv = (inter * (1 - mask) + extra * mask).to(device)
    t = torch.arange(L, dtype=torch.float32, device=device)
    emb = torch.cat([torch.outer(t, inv)] * 2, -1)
    m = _mscale(factor, rs["mscale"]) / _mscale(factor, rs["mscale_all_dim"])
    scale = (c["qk_nope_head_dim"] + dim) ** -0.5 \
        * _mscale(factor, rs["mscale_all_dim"]) ** 2
    return emb.cos() * m, emb.sin() * m, scale


def rotate(x, cos, sin):
    """The published apply_rotary_pos_emb on x [B, h, L, d]: the
    interleaved pairs de-interleaved, then rotate_half."""
    b, h, s, d = x.shape
    x = x.view(b, h, s, d // 2, 2).transpose(4, 3).reshape(b, h, s, d)
    half = torch.cat([-x[..., d // 2:], x[..., :d // 2]], -1)
    return x * cos + half * sin


def swiglu(x, wg, wu, wd, num: Numerics):
    return num.linear(F.silu(num.linear(x, wg, None))
                      * num.linear(x, wu, None), wd, None)


def moe(P, p, c, x, held, num: Numerics, record=None, force=None,
        balance: bool = False):
    """The layer's output for x [T, D]: the held experts' part of the
    routed sum plus the shared experts. ``record`` collects the top-k ids
    of this gate; ``force`` replaces them (the weights are then the scores
    there); ``balance`` first makes the gate orthogonal, in place, to the
    mean of x over its rows (``balance_gates``)."""
    T, d = x.shape
    k, mi = c["num_experts_per_tok"], c["moe_intermediate_size"]
    if balance:
        m = x.mean(0)
        m = m / m.norm()
        gate = P[p + "mlp.gate"]
        gate -= torch.outer(gate @ m, m)
    scores = torch.softmax(num.head_linear(x, P[p + "mlp.gate"], None), -1)
    w, ids = torch.topk(scores, k, dim=-1, sorted=True)
    if record is not None:
        record.append(ids.detach())
    if force is not None:
        ids = force.to(ids.device)
        w = scores.gather(1, ids)
    if c["norm_topk_prob"]:
        w = w / (w.sum(-1, keepdim=True) + 1e-20)
    w = w * c["routed_scaling_factor"]
    first, n = held
    gate_up = P[p + "mlp.experts.gate_up"].view(n, 2 * mi, d)
    down = P[p + "mlp.experts.down"].view(n, d, mi)
    out = torch.zeros(T, d, device=x.device)
    for e in range(n):
        sel = ids == first + e
        tok = sel.any(1).nonzero()[:, 0]
        if len(tok) == 0:
            continue
        we = (w * sel).sum(1)[tok]
        g, u = num.linear(x[tok], gate_up[e], None).chunk(2, -1)
        y = num.linear(F.silu(g) * u, down[e], None)
        out = out.index_add(0, tok, we[:, None] * y)
    q = p + "mlp.shared_experts."
    return out + swiglu(x, P[q + "gate_proj.weight"], P[q + "up_proj.weight"],
                        P[q + "down_proj.weight"], num)


def encode(P: Dict[str, torch.Tensor], c: dict, ids: torch.Tensor,
           mask: torch.Tensor, held: Tuple[int, int], num: Numerics,
           record: Optional[list] = None, force: Optional[list] = None,
           prefix: str = "encoder.", balance: bool = False):
    """(hidden states [B, L, D], pooled [B, D]) in fp32 of right-padded
    rows; ``record`` and ``force`` hold one entry a mixture layer;
    ``balance``: see ``balance_gates``."""
    B, L = ids.shape
    eps, h = c["rms_norm_eps"], c["num_attention_heads"]
    nope, rope, vd = (c["qk_nope_head_dim"], c["qk_rope_head_dim"],
                      c["v_head_dim"])
    lora = c["kv_lora_rank"]
    cos, sin, scale = rope_tables(c, L, ids.device)
    causal = torch.ones(L, L, dtype=torch.bool, device=ids.device).tril()
    ok = causal[None] & (mask[:, None, :] != 0)
    bias = torch.where(ok, 0.0, -1e9)[:, None]
    x = P[prefix + "embed_tokens.weight"][ids.long()]
    forced = iter(force) if force is not None else None
    for i in range(c["num_hidden_layers"]):
        p = prefix + f"layers.{i}."
        a = rms_norm(x, P[p + "input_ln.weight"], eps)
        q = num.linear(a, P[p + "self_attn.q_proj.weight"], None).view(
            B, L, h, nope + rope).transpose(1, 2)
        q_nope, q_pe = q.split([nope, rope], -1)
        lat, k_pe = num.linear(a, P[p + "self_attn.kv_a_proj_with_mqa.weight"],
                               None).split([lora, rope], -1)
        k_pe = k_pe.reshape(B, L, 1, rope).transpose(1, 2)
        kv = num.linear(rms_norm(lat, P[p + "self_attn.kv_a_ln.weight"], eps),
                        P[p + "self_attn.kv_b_proj.weight"], None).view(
            B, L, h, nope + vd).transpose(1, 2)
        k_nope, v = kv.split([nope, vd], -1)
        qq = torch.cat([q_nope, rotate(q_pe, cos, sin)], -1)
        kk = torch.cat([k_nope, rotate(k_pe, cos, sin).expand(B, h, L, rope)],
                       -1)
        probs = torch.softmax(num.bmm(qq, kk.transpose(-1, -2)) * scale
                              + bias, -1)
        ctx = num.bmm(probs, v).transpose(1, 2).reshape(B, L, h * vd)
        x = x + num.linear(ctx, P[p + "self_attn.o_proj.weight"], None)
        a = rms_norm(x, P[p + "post_attention_ln.weight"], eps)
        if i < c["first_k_dense_replace"]:
            x = x + swiglu(a, P[p + "mlp.gate_proj.weight"],
                           P[p + "mlp.up_proj.weight"],
                           P[p + "mlp.down_proj.weight"], num)
        else:
            x = x + moe(P, p, c, a.reshape(B * L, -1), held, num, record,
                        next(forced) if forced else None,
                        balance).view(B, L, -1)
    x = rms_norm(x, P[prefix + "final_ln.weight"], eps)
    last = mask.long().sum(1) - 1
    return x, x[torch.arange(B, device=x.device), last]


@torch.no_grad()
def balance_gates(P: Dict[str, torch.Tensor], c: dict, ids: torch.Tensor,
                  mask: torch.Tensor, held: Tuple[int, int]) -> None:
    """Make each mixture layer's gate, in place, orthogonal to the mean of
    that layer's input over the rows ``ids`` (every position), layer after
    layer in one fp32 forward. Random weights give the residual stream a
    direction shared by every token that grows with depth (0.24 to 0.52 of
    a token's norm over 13 layers at hidden 256), and a random gate turns
    it into one preference for all tokens: a layer then sends up to all its
    tokens to one expert and the held experts' rows follow the seed. A
    trained router (DeepSeek-V2 trains its gates with a balance loss)
    spreads the tokens; so do the gates made so (the largest expert's
    share 0.18-0.21 of the tokens, the held rows 0.72-0.77 of a token
    against 0.75 even, five seeds at hidden 256)."""
    encode(P, c, ids, mask, held, Numerics("fp32"), balance=True)
