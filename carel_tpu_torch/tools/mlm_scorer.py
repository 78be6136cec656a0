"""Directional conditional likelihood from the port's own MLM; port of
carel_tpu/tools/mlm_scorer.py.

Masked-LM pseudo-log-likelihood (Salazar et al., ACL 2020), length-
normalized: each hypothesis token is masked in turn behind the premise
context, and the scorer returns the mean of the masked tokens'
log-probabilities. Every call runs one fixed ``[hyp_cap, max_len]`` batch
through the MLM (row j masks the j-th hypothesis token; rows past the
hypothesis are copies that are not read), so a call costs the same whatever
its texts. The head runs only at each row's masked position: its log-softmax
there is the one JAX reads out of the full ``[hyp_cap, max_len, V]``
logits. When the premise fills the window no hypothesis token is left and
the call returns ``-inf``, as in JAX.

The model comes from ``pretrain --save_mlm`` (``pretrain/mlm.py:
load_mlm``); the plain encoder dirs hold no head. Plugs into
``tools/ordering.ordering_probe`` as ``entailment_scorer``.
"""

from __future__ import annotations

import numpy as np
import torch

from carel_tpu_torch.config import EncoderConfig
from carel_tpu_torch.device import resolve_device


class MlmScorer:
    """Callable (premise, hypothesis) -> mean masked-token log-prob, on
    ``device`` (the GPU unless "cpu" is asked for)."""

    def __init__(self, mlm_dir: str, tokenizer, encoder_cfg: EncoderConfig,
                 max_len: int = 64, hyp_cap: int = 32, device="cuda"):
        from carel_tpu_torch.pretrain.mlm import (MlmModel, load_mlm,
                                                  mask_id_of)

        self.device = resolve_device(device)
        self.tok = tokenizer
        self.max_len = max_len
        self.hyp_cap = hyp_cap
        self.mask_id = mask_id_of(tokenizer)
        self.model = MlmModel(encoder_cfg)
        self.model.load_state_dict(load_mlm(mlm_dir))
        self.model.to(self.device).eval()

    @torch.no_grad()
    def masked_logprobs(self, ids: np.ndarray, attn: np.ndarray,
                        pos: np.ndarray, tgt: np.ndarray) -> torch.Tensor:
        """log p(tgt[j] | row j) at position pos[j] of each row [H]."""
        dev = self.device
        ids, attn, pos, tgt = (torch.from_numpy(a).to(dev)
                               for a in (ids, attn, pos, tgt))
        hidden = self.model.hidden(ids, attn)
        rows = torch.arange(ids.shape[0], device=dev)
        logp = torch.log_softmax(self.model.head(hidden[rows, pos.long()]),
                                 dim=-1)
        return logp[rows, tgt.long()]

    def batch(self, premise: str, hypothesis: str):
        """(ids, attn, pos, tgt, number of scored rows) of one call, or
        None when the premise leaves no hypothesis token in the window."""
        prem = self.tok.tokenize_to_ids(str(premise))
        hyp = self.tok.tokenize_to_ids(str(hypothesis))[: self.hyp_cap]
        base = ([self.tok.cls_id] + prem + [self.tok.sep_id]
                + hyp + [self.tok.sep_id])
        if len(base) > self.max_len:
            base = base[: self.max_len - 1] + [self.tok.sep_id]
        start = len(prem) + 2  # [CLS] prem [SEP] | hyp...
        hyp_pos = list(range(start, min(start + len(hyp), len(base) - 1)))
        if not hyp_pos:
            return None
        H, L = self.hyp_cap, self.max_len
        row = np.full(L, self.tok.pad_id, np.int32)
        row[: len(base)] = base
        amask = np.zeros(L, np.int32)
        amask[: len(base)] = 1
        ids = np.tile(row, (H, 1))
        attn = np.tile(amask, (H, 1))
        pos = np.zeros(H, np.int32)
        tgt = np.zeros(H, np.int32)
        for j, p in enumerate(hyp_pos):
            tgt[j] = row[p]
            ids[j, p] = self.mask_id
            pos[j] = p
        return ids, attn, pos, tgt, len(hyp_pos)

    def __call__(self, premise: str, hypothesis: str) -> float:
        b = self.batch(premise, hypothesis)
        if b is None:  # premise filled the window; direction unscorable
            return float("-inf")
        *arrays, n = b
        lp = self.masked_logprobs(*arrays).cpu().numpy()
        return float(lp[:n].mean())
