"""Stage-1 document-level emotion model, port of carel_tpu/models/stage1.py.

Reference: biLSTM (baseline_emotion_classifier_final_devin.py:283-329):
per-clause encoder pooler -> linear 768->2h -> BiLSTM over the clause axis
-> 7-way softmax per clause, plus an L2 term on the final layer.

The clause batch is folded into the encoder batch ([B, D, S] -> [B*D, S]).
The clause mixer is chosen by ``clause_mixer``:

- ``"bilstm"``: ``torch.nn.LSTM``, bidirectional, over all D clause
  positions with a zero initial carry and no packing, as the JAX package's
  two ``nn.RNN(OptimizedLSTMCell)`` scans run (no seq_lengths: the backward
  direction starts on the padded clauses at the end). Flax's gates are
  i, f, g, o with c' = f*c + i*g and h' = o*tanh(c'), torch's order. Flax's
  cell has no input bias, so ``bias_ih`` stays 0 and is not trained;
- ``"transformer"``: Flax's ``MultiHeadDotProductAttention`` (4 heads, qkv
  features 2h, biases, no mask: padded clauses are attended to), post-LN
  residuals with Flax's LayerNorm eps 1e-6 and the tanh-approximate GELU of
  ``nn.gelu``.

The model returns the softmax probabilities [B, D, 7] and the L2 term
``safe_norm(W) + safe_norm(b)`` of the final layer, with 1e-12 inside each
square root (the bias starts at exactly zero, where a bare norm's gradient
is 0/0).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from carel_tpu_torch.config import EncoderConfig
from carel_tpu_torch.models.encoder import (_TRUNC_STD, TransformerEncoder,
                                            init_flax_)

CLAUSE_MIXERS = ("bilstm", "transformer")


class FlaxMultiHeadAttention(nn.Module):
    """Flax ``MultiHeadDotProductAttention`` self-attention without a mask
    or dropout: per-head query/key/value projections (here one Linear each,
    its output laid out (heads, head_dim)), the query scaled by
    1/sqrt(head_dim), softmax over the keys, and the output projection."""

    def __init__(self, features: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.head_dim = features // num_heads
        self.query = nn.Linear(features, features)
        self.key = nn.Linear(features, features)
        self.value = nn.Linear(features, features)
        self.out = nn.Linear(features, features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, D, Fd = x.shape
        shape = (B, D, self.num_heads, self.head_dim)
        q = self.query(x).view(shape) / math.sqrt(self.head_dim)
        k = self.key(x).view(shape)
        v = self.value(x).view(shape)
        w = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", q, k), dim=-1)
        return self.out(torch.einsum("bhqk,bkhd->bqhd", w, v)
                        .reshape(B, D, Fd))


class ClauseTransformer(nn.Module):
    def __init__(self, hidden_size: int, num_heads: int = 4):
        super().__init__()
        d = 2 * hidden_size
        self.attn = FlaxMultiHeadAttention(d, num_heads)
        self.ln1 = nn.LayerNorm(d, eps=1e-6)
        self.mlp_in = nn.Linear(d, 2 * d)
        self.mlp_out = nn.Linear(2 * d, d)
        self.ln2 = nn.LayerNorm(d, eps=1e-6)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.ln1(x + self.attn(x))
        h = self.mlp_out(F.gelu(self.mlp_in(x), approximate="tanh"))
        return self.ln2(x + h)


class BiLSTM(nn.LSTM):
    """Bidirectional LSTM over the clause axis, [B, D, F] -> [B, D, 2h]."""

    def __init__(self, in_features: int, hidden_size: int):
        super().__init__(in_features, hidden_size, batch_first=True,
                         bidirectional=True)
        for name in ("bias_ih_l0", "bias_ih_l0_reverse"):
            getattr(self, name).requires_grad_(False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x)[0]


class DocEmotionModel(nn.Module):
    def __init__(self, encoder_cfg: EncoderConfig, n_hidden: int = 100,
                 n_class: int = 7, keep_softmax: float = 1.0,
                 clause_mixer: str = "bilstm"):
        super().__init__()
        if clause_mixer not in CLAUSE_MIXERS:
            raise ValueError(f"clause_mixer {clause_mixer!r}: use one of "
                             f"{CLAUSE_MIXERS}")
        self.keep_softmax = keep_softmax
        self.encoder = TransformerEncoder(encoder_cfg)
        self.senlayer = nn.Linear(encoder_cfg.hidden_dim, 2 * n_hidden)
        self.mixer = (ClauseTransformer(n_hidden)
                      if clause_mixer == "transformer"
                      else BiLSTM(2 * n_hidden, n_hidden))
        self.nnlayer_pos = nn.Linear(2 * n_hidden, n_class)

    def forward(self, x_ids: torch.Tensor, x_masks: torch.Tensor,
                x_types: torch.Tensor, deterministic: bool = True):
        """(probabilities [B, D, n_class], the L2 term) of [B, D, S]
        clause grids."""
        B, D, S = x_ids.shape
        _, pooled = self.encoder(x_ids.reshape(B * D, S),
                                 x_masks.reshape(B * D, S),
                                 x_types.reshape(B * D, S),
                                 deterministic=deterministic)
        s = self.senlayer(pooled.reshape(B, D, -1).float())
        s = self.mixer(s)
        s = F.dropout(s, 1.0 - self.keep_softmax, training=not deterministic)
        pred = torch.softmax(self.nnlayer_pos(s), dim=-1)

        def safe_norm(t):
            return torch.sqrt(torch.sum(torch.square(t)) + 1e-12)

        reg = safe_norm(self.nnlayer_pos.weight) + \
            safe_norm(self.nnlayer_pos.bias)
        return pred, reg


@torch.no_grad()
def init_stage1_(model: DocEmotionModel, generator: torch.Generator) -> None:
    """Flax's initialisers (``init_flax_``), and for the BiLSTM those of
    ``OptimizedLSTMCell``: each gate's input kernel lecun-normal over its
    fan-in, each recurrent kernel orthogonal, the biases zero."""
    init_flax_(model, generator)
    if isinstance(model.mixer, BiLSTM):
        lstm = model.mixer
        H = lstm.hidden_size
        std = math.sqrt(1.0 / lstm.input_size) / _TRUNC_STD
        for sfx in ("_l0", "_l0_reverse"):
            for gate in range(4):
                rows = slice(gate * H, (gate + 1) * H)
                nn.init.trunc_normal_(getattr(lstm, "weight_ih" + sfx)[rows],
                                      0.0, std, -2.0 * std, 2.0 * std,
                                      generator=generator)
                nn.init.orthogonal_(getattr(lstm, "weight_hh" + sfx)[rows],
                                    generator=generator)
            getattr(lstm, "bias_ih" + sfx).zero_()
            getattr(lstm, "bias_hh" + sfx).zero_()
