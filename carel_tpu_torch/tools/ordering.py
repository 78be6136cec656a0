"""Temporal-ordering probes over emotion-cause pairs; port of
carel_tpu/tools/ordering.py (host only).

Per gold pair: (a) positional statistics (does the cause precede the
emotion clause?) and (b), given a scorer, the directional comparison of
score(cause -> emotion) against score(emotion -> cause). The scorer is any
callable (premise, hypothesis) -> float, e.g. ``tools/mlm_scorer.MlmScorer``
over the port's own MLM (the reference's NLI and ChatYuan models cannot be
downloaded here).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional, Sequence

from carel_tpu_torch.data.ecpe_format import Document


@dataclass
class OrderingStats:
    total_pairs: int = 0
    cause_before: int = 0  # cause id < emotion id
    cause_equal: int = 0  # self-chain
    cause_after: int = 0
    forward_wins: int = 0  # score(cause -> emotion) > score(emotion -> cause)
    backward_wins: int = 0
    scored_pairs: int = 0

    @property
    def temporal_order_rate(self) -> float:
        """Fraction of pairs with cause <= emotion (the assumption behind the
        temporal_order strategy, newsplit :935)."""
        if self.total_pairs == 0:
            return 0.0
        return (self.cause_before + self.cause_equal) / self.total_pairs


def ordering_probe(
    docs: Sequence[Document],
    entailment_scorer: Optional[Callable[[str, str], float]] = None,
) -> OrderingStats:
    stats = OrderingStats()
    for doc in docs:
        for e, c in doc.pairs:
            if not (1 <= e <= doc.doc_len and 1 <= c <= doc.doc_len):
                continue
            stats.total_pairs += 1
            if c < e:
                stats.cause_before += 1
            elif c == e:
                stats.cause_equal += 1
            else:
                stats.cause_after += 1
            if entailment_scorer is not None and e != c:
                cause_text = doc.clause(c).text.strip()
                emo_text = doc.clause(e).text.strip()
                fwd = entailment_scorer(cause_text, emo_text)
                bwd = entailment_scorer(emo_text, cause_text)
                stats.scored_pairs += 1
                if fwd > bwd:
                    stats.forward_wins += 1
                elif bwd > fwd:
                    stats.backward_wins += 1
    return stats
