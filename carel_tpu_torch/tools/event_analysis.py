"""POS-structure analysis of cause clauses; port of
carel_tpu/tools/event_analysis.py (host only).

Profiles the grammatical shape of the gold cause clauses (event_analyse.py)
with jieba's POS tagger, imported where it is used.
"""

from __future__ import annotations

from collections import Counter
from dataclasses import dataclass, field
from typing import Sequence

from carel_tpu_torch.data.ecpe_format import Document


@dataclass
class EventAnalysis:
    clause_count: int = 0
    pos_counts: Counter = field(default_factory=Counter)
    leading_pos: Counter = field(default_factory=Counter)
    has_verb_rate: float = 0.0


def analyze_cause_clauses(docs: Sequence[Document]) -> EventAnalysis:
    """POS statistics over all gold cause clauses."""
    import jieba.posseg as pseg
    import jieba

    jieba.setLogLevel(60)
    out = EventAnalysis()
    with_verb = 0
    for doc in docs:
        for _, c in doc.pairs:
            if not 1 <= c <= doc.doc_len:
                continue
            text = doc.clause(c).text.strip().replace(" ", "")
            words = list(pseg.cut(text))
            if not words:
                continue
            out.clause_count += 1
            out.leading_pos[words[0].flag] += 1
            tags = [w.flag for w in words]
            out.pos_counts.update(tags)
            if any(t.startswith("v") for t in tags):
                with_verb += 1
    if out.clause_count:
        out.has_verb_rate = with_verb / out.clause_count
    return out
