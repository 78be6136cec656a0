"""A BERT / RoBERTa encoder over a dict of fp32 tensors (Devlin et al.
2019; Liu et al. 2019), as the configuration's ``config.json`` describes
it: word + position + token-type embeddings, LayerNorm, dropout; per layer
self-attention with an additive -1e9 mask on padded keys, dropout on the
probabilities, the output projection, dropout, residual and post-LN; the
exact-erf GELU MLP, dropout, residual and post-LN; the tanh pooler over
the first token. RoBERTa numbers real positions from pad_id + 1 and gives
pads pad_id.

Departures from the published models, shared with the program: the q, k
and v projections are one [3 D, D] matrix whose rows are laid out (q, k,
v) x heads x head size; the names of the tensors are the program's keys.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from reference.numerics import Numerics


def encoder_spec(c: dict, prefix: str = "encoder.") -> List[Tuple[str, tuple]]:
    """(name, shape) of every tensor of the encoder of config ``c``."""
    d, f = c["hidden_size"], c["intermediate_size"]
    spec = [("word_embeddings.weight", (c["vocab_size"], d)),
            ("position_embeddings.weight", (c["max_position_embeddings"], d))]
    if c["type_vocab_size"] > 0:
        spec.append(("token_type_embeddings.weight",
                     (c["type_vocab_size"], d)))
    spec += [("embeddings_ln.weight", (d,)), ("embeddings_ln.bias", (d,))]
    for i in range(c["num_hidden_layers"]):
        p = f"layers.{i}."
        spec += [(p + "attention.qkv.weight", (3 * d, d)),
                 (p + "attention.qkv.bias", (3 * d,)),
                 (p + "attention.out.weight", (d, d)),
                 (p + "attention.out.bias", (d,)),
                 (p + "attention_ln.weight", (d,)),
                 (p + "attention_ln.bias", (d,)),
                 (p + "mlp_in.weight", (f, d)), (p + "mlp_in.bias", (f,)),
                 (p + "mlp_out.weight", (d, f)), (p + "mlp_out.bias", (d,)),
                 (p + "mlp_ln.weight", (d,)), (p + "mlp_ln.bias", (d,))]
    spec += [("pooler.weight", (d, d)), ("pooler.bias", (d,))]
    return [(prefix + n, s) for n, s in spec]


# fused tensors and their parts along the first dimension: the key's bias
# moves only by round-off (softmax ignores it), so the check reads q, k and
# v as leaves of their own
FUSED = {"attention.qkv.weight": ("q", "k", "v"),
         "attention.qkv.bias": ("q", "k", "v")}


def parts(name: str, t: torch.Tensor):
    """(leaf name, view) of each part of ``t``."""
    for suffix, labels in FUSED.items():
        if name.endswith(suffix):
            return [(f"{name}[{lab}]", c)
                    for lab, c in zip(labels, t.chunk(len(labels), 0))]
    return [(name, t)]


@torch.no_grad()
def part_norms(named) -> Dict[str, float]:
    """{leaf: L2 norm} over the parts of the (name, tensor) pairs, in
    float64, fetched in one copy."""
    keys, norms = [], []
    for name, t in named:
        for key, view in parts(name, t):
            keys.append(key)
            norms.append(torch.linalg.vector_norm(view.double()))
    return dict(zip(keys, torch.stack(norms).tolist())) if norms else {}


def layer_norm(x, w, b, eps):
    return F.layer_norm(x, (x.shape[-1],), w, b, eps)


def encode(P: Dict[str, torch.Tensor], c: dict, ids: torch.Tensor,
           attention_mask: torch.Tensor, token_type_ids: torch.Tensor,
           num: Numerics, mask_dtype: torch.dtype, train: bool,
           pool: bool = True, prefix: str = "encoder."):
    """(last hidden state [B, L, D], pooled [B, D] or None), fp32."""
    def p(name):
        return P[prefix + name]

    B, L = ids.shape
    eps = c["layer_norm_eps"]
    h, d = c["num_attention_heads"], c["hidden_size"]
    hd = d // h
    p_hidden = c["hidden_dropout_prob"] if train else 0.0
    p_attn = c["attention_probs_dropout_prob"] if train else 0.0
    if c["model_type"] == "roberta":
        m = attention_mask.long()
        positions = torch.cumsum(m, dim=1) * m + c["pad_token_id"]
    else:
        positions = torch.arange(L, device=ids.device)[None, :].expand(B, L)
    x = p("word_embeddings.weight")[ids.long()] \
        + p("position_embeddings.weight")[positions]
    if c["type_vocab_size"] > 0:
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(ids)
        x = x + p("token_type_embeddings.weight")[token_type_ids.long()]
    x = layer_norm(x, p("embeddings_ln.weight"), p("embeddings_ln.bias"),
                   eps)
    x = num.drop(x, p_hidden, mask_dtype)
    bias = ((1.0 - attention_mask.float()) * -1e9)[:, None, None, :]
    for i in range(c["num_hidden_layers"]):
        q_ = f"layers.{i}."
        qkv = num.linear(x, p(q_ + "attention.qkv.weight"),
                         p(q_ + "attention.qkv.bias")).view(B, L, 3, h, hd)
        q, k, v = (t.transpose(1, 2) for t in qkv.unbind(2))
        scores = num.bmm(q, k.transpose(-1, -2)) / math.sqrt(hd)
        probs = torch.softmax(scores + bias, dim=-1)
        probs = num.drop(probs, p_attn, mask_dtype)
        ctx = num.bmm(probs, v).transpose(1, 2).reshape(B, L, d)
        a = num.linear(ctx, p(q_ + "attention.out.weight"),
                       p(q_ + "attention.out.bias"))
        a = num.drop(a, p_hidden, mask_dtype)
        x = layer_norm(x + a, p(q_ + "attention_ln.weight"),
                       p(q_ + "attention_ln.bias"), eps)
        f = F.gelu(num.linear(x, p(q_ + "mlp_in.weight"),
                              p(q_ + "mlp_in.bias")))
        o = num.linear(f, p(q_ + "mlp_out.weight"), p(q_ + "mlp_out.bias"))
        o = num.drop(o, p_hidden, mask_dtype)
        x = layer_norm(x + o, p(q_ + "mlp_ln.weight"), p(q_ + "mlp_ln.bias"),
                       eps)
    pooled = None
    if pool:
        pooled = torch.tanh(num.linear(x[:, 0], p("pooler.weight"),
                                       p("pooler.bias")))
    return x, pooled
