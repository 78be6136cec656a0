"""Emotion-cause pair construction from parsed ECPE documents.

Reproduces the reference's read_ECPE_data semantics exactly — the acceptance
metric (pair-F1) lives or dies on this enumeration, not on the encoder:

- train mode: positives = gold pairs; negatives = (gold emotion x non-cause
  sentence) subsampled (without replacement) to |positives|
  (drl_classifier_ec_mmd_final_mul.py:685-701).
- test mode: gold pairs are reconciled against the stage-1 *predicted* emotion
  sentences (clauses whose emotion code != 6); pairs whose emotion stage 1
  missed are counted in num_unpred_emotions and dropped; candidate negatives
  are (matched emotion x non-cause sentence) plus (leftover predicted emotion x
  every sentence) (flagship :663-708).
- pair text = emotion clause + sep + cause clause; zh (and en without
  bow_optimize): spaces stripped, "[SEP]" separator; en with bow_optimize:
  spaces kept, " [SEP] " separator (newsplit :921-953).
- temporal_order = cause_sen_id <= emotion_sen_id (newsplit :935, :955).

The clause text used is `line.split(',')[3]` — the reference truncates clause
text at an embedded comma; Clause.text_field3 preserves that.
"""

from __future__ import annotations

import random
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

from carel_tpu_torch.data.ecpe_format import Document, NULL_EMOTION


@dataclass
class PairExample:
    pair: str  # "<emotion clause><sep><cause clause>"
    label: int  # 1 = true emotion-cause pair
    emotion: int  # emotion code of the emotion clause (0..5)
    temporal_order: bool  # cause precedes-or-equals emotion
    doc_index: int  # index of the source document
    emo_sen_id: int = 0
    cau_sen_id: int = 0


@dataclass
class PairSet:
    examples: List[PairExample] = field(default_factory=list)
    docs_pair_size: List[int] = field(default_factory=list)
    num_unpred_emotions: int = 0

    def __len__(self) -> int:
        return len(self.examples)

    @property
    def pairs(self) -> List[str]:
        return [e.pair for e in self.examples]

    @property
    def labels(self) -> List[int]:
        return [e.label for e in self.examples]


def _pair_text(doc: Document, emo_id: int, cau_id: int, spaced_sep: bool) -> str:
    emo_text = doc.clause(emo_id).text_field3
    cau_text = doc.clause(cau_id).text_field3
    if spaced_sep:
        # en + bow_optimize path (newsplit :925-927): the comma-truncated
        # field is joined VERBATIM — leading/trailing spaces inside the field
        # survive (harmless downstream: the WordPiece pre-tokenizer splits on
        # whitespace)
        return emo_text + " [SEP] " + cau_text
    # zh path: spaces removed from the field (flagship :710-727)
    return emo_text.replace(" ", "") + "[SEP]" + cau_text.replace(" ", "")


def build_pairs(
    docs: Sequence[Document],
    test: bool = False,
    spaced_sep: bool = False,
    rng: Optional[random.Random] = None,
) -> PairSet:
    """Construct the (pair, label, emotion, temporal_order) example set.

    rng drives the train-mode negative subsampling; defaults to the module
    `random` (the reference seeds it with 42 at import, flagship :27).
    """
    sample = (rng or random).sample
    out = PairSet()

    for doc_index, doc in enumerate(docs):
        doc_len = doc.doc_len
        # On well-formed corpora this filter is a no-op; it guards against
        # truncated documents whose gold pairs reference missing clauses
        # (the reference would raise there, flagship :710-714).
        pos_pairs: List[Tuple[int, int]] = [
            (e, c) for e, c in doc.pairs if 1 <= e <= doc_len and 1 <= c <= doc_len
        ]
        # predicted emotion sentences: emotion code != 6, in document order
        pred_emotions: List[int] = [
            cl.sen_id for cl in doc.clauses if cl.emotion != NULL_EMOTION
        ]
        sen_emo_dict = {
            cl.sen_id: cl.emotion
            for cl in doc.clauses
            if cl.emotion != NULL_EMOTION
        }

        if not test:
            emotions = list(dict.fromkeys(e for e, _ in pos_pairs))
        else:
            # reconcile gold pairs against stage-1 predictions
            # (flagship :665-681)
            true_emotions = [e for e, _ in pos_pairs]
            pair_indices: List[int] = []
            pre_e = -1
            for i, e in enumerate(true_emotions):
                if e not in pred_emotions and e != pre_e:
                    out.num_unpred_emotions += 1
                elif e == pre_e:
                    pair_indices.append(i)
                else:
                    pair_indices.append(i)
                    pred_emotions.remove(e)
                    pre_e = e
            pos_pairs = [pos_pairs[i] for i in pair_indices]
            emotions = list(dict.fromkeys(e for e, _ in pos_pairs))

        causes = [c for _, c in pos_pairs]

        # negatives: (matched emotion, non-cause sentence)
        non_cause_ids = [i + 1 for i in range(doc_len) if i + 1 not in causes]
        neg_pairs: List[Tuple[int, int]] = [
            (e, non_c) for e in emotions for non_c in non_cause_ids
        ]

        if not test:
            k = min(len(pos_pairs), len(neg_pairs))
            neg_pairs = sample(neg_pairs, k)
        else:
            # leftover predicted emotions (not matched to any gold pair) pair
            # with EVERY sentence (flagship :703-708)
            all_ids = [i + 1 for i in range(doc_len)]
            for e in pred_emotions:
                for c in all_ids:
                    neg_pairs.append((e, c))

        for emo_id, cau_id in pos_pairs:
            out.examples.append(
                PairExample(
                    pair=_pair_text(doc, emo_id, cau_id, spaced_sep),
                    label=1,
                    emotion=sen_emo_dict.get(emo_id, NULL_EMOTION),
                    temporal_order=cau_id <= emo_id,
                    doc_index=doc_index,
                    emo_sen_id=emo_id,
                    cau_sen_id=cau_id,
                )
            )
        for emo_id, cau_id in neg_pairs:
            out.examples.append(
                PairExample(
                    pair=_pair_text(doc, emo_id, cau_id, spaced_sep),
                    label=0,
                    emotion=sen_emo_dict.get(emo_id, NULL_EMOTION),
                    temporal_order=cau_id <= emo_id,
                    doc_index=doc_index,
                    emo_sen_id=emo_id,
                    cau_sen_id=cau_id,
                )
            )

        out.docs_pair_size.append(len(pos_pairs) + len(neg_pairs))

    return out
