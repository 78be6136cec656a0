"""Plain (non-VAE) pair classifier, port of
carel_tpu/models/pair_classifier.py: encoder pooler -> dropout -> linear.

Reference: PairClassifier (pair_classifier.py:68-84), the baseline that
pair_inference.py and mc_classifier.py build on. Module names match the
JAX package's (``encoder``, ``classifier``), so convert.py maps its params.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from carel_tpu_torch.config import EncoderConfig
from carel_tpu_torch.models.encoder import TransformerEncoder


class PairClassifier(nn.Module):
    def __init__(self, encoder_cfg: EncoderConfig, dropout: float = 0.3):
        super().__init__()
        self.encoder = TransformerEncoder(encoder_cfg)
        self.classifier = nn.Linear(encoder_cfg.hidden_dim, 1)
        self.dropout = dropout

    def forward(self, input_ids, attention_mask, token_type_ids,
                deterministic: bool = True) -> torch.Tensor:
        """Logits [B, 1] in fp32 (the pooled output is upcast first)."""
        _, pooled = self.encoder(input_ids, attention_mask, token_type_ids,
                                 deterministic=deterministic)
        x = F.dropout(pooled.float(), self.dropout,
                      training=not deterministic)
        return self.classifier(x)
