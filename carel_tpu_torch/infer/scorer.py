"""PairScorer: serving API for emotion-cause pair scoring, port of
carel_tpu/infer/scorer.py.

The reference's inference is a script over pre-built files
(pair_inference.py); serving raw text requires rebuilding its whole ingest.
PairScorer packages tokenizer + model into one object that scores raw
(emotion_clause, cause_clause) pairs at a fixed batch shape.

    scorer = PairScorer.from_pipeline(pipe, model)
    probs = scorer.score_texts([("他很难过", "天气变冷"), ...])
    pairs = scorer.extract_document(clauses, emotion_ids)   # candidate sweep
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from carel_tpu_torch.config import CarelConfig
from carel_tpu_torch.data.tokenizer import BaseTokenizer
from carel_tpu_torch.device import resolve_device
from carel_tpu_torch.models.drl import DrlModel
from carel_tpu_torch.train.steps import batch_to_device, make_eval_step


class PairScorer:
    def __init__(self, cfg: CarelConfig, model: DrlModel,
                 tokenizer: BaseTokenizer, batch_size: int = 256,
                 sample: bool = False, spaced_sep: bool = False,
                 device="cuda"):
        """Serves ``model`` on ``device`` (the GPU unless the caller asks
        for the CPU); the sampling noise, when ``sample`` is set, comes from
        a generator on that device seeded 0."""
        self.cfg = cfg
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.tokenizer = tokenizer
        self.batch_size = batch_size
        self.max_len = cfg.data.max_len
        self.sep = " [SEP] " if spaced_sep else "[SEP]"
        self._eval = make_eval_step(sample=sample)
        self._generator = torch.Generator(device=self.device).manual_seed(0)

    @classmethod
    def from_pipeline(cls, pipe, model: DrlModel, **kw) -> "PairScorer":
        spaced = pipe.cfg.data.language == "en" and pipe.cfg.data.bow_optimize
        return cls(pipe.cfg, model, pipe.tokenizer, spaced_sep=spaced, **kw)

    def score_pair_strings(self, texts: Sequence[str]) -> np.ndarray:
        """Probabilities for pre-joined '<emo><sep><cause>' strings."""
        n = len(texts)
        out = np.zeros(n, np.float32)
        B = self.batch_size
        for s in range(0, n, B):
            chunk = list(texts[s : s + B])
            k = len(chunk)
            if k < B:
                chunk = chunk + [""] * (B - k)
            enc = self.tokenizer.encode_batch(chunk, self.max_len)
            batch = batch_to_device({
                "input_ids": enc.input_ids,
                "attention_mask": enc.attention_mask,
                "token_type_ids": enc.token_type_ids,
            }, self.device)
            p = self._eval(self.model, batch, self._generator).cpu().numpy()
            out[s : s + k] = p[:k]
        return out

    def score_texts(
        self, pairs: Sequence[Tuple[str, str]]
    ) -> np.ndarray:
        """Probabilities for raw (emotion_clause, cause_clause) pairs."""
        zh = self.cfg.data.language == "zh"
        texts = []
        for emo, cau in pairs:
            if zh or self.sep == "[SEP]":
                texts.append(emo.strip().replace(" ", "") + "[SEP]"
                             + cau.strip().replace(" ", ""))
            else:
                texts.append(emo.strip() + self.sep + cau.strip())
        return self.score_pair_strings(texts)

    def extract_document(
        self,
        clauses: Sequence[str],
        emotion_clause_ids: Sequence[int],  # 1-based, from stage 1
        threshold: float = 0.5,
    ) -> List[Tuple[int, int, float]]:
        """Candidate sweep for one document: every (predicted emotion clause,
        any clause) pair scored; returns (emo_id, cause_id, prob) above the
        threshold, sorted by probability."""
        cand = [(e, c) for e in emotion_clause_ids
                for c in range(1, len(clauses) + 1)]
        if not cand:
            return []
        probs = self.score_texts(
            [(clauses[e - 1], clauses[c - 1]) for e, c in cand])
        hits = [(e, c, float(p)) for (e, c), p in zip(cand, probs)
                if p > threshold]
        return sorted(hits, key=lambda x: -x[2])
