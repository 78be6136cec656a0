"""Self-chain document handling, port of carel_tpu/data/self_chain.py.

"Self-chain" = a gold pair whose emotion and cause are the SAME clause
(e == c). Reproduces get_self_chain_docs / read_ECPE_self_chain_data
(drl_classifier_ec_mmd_self_chain.py:902-1010): detection over the
(deduped-emotion, cause) zip, and a pair reader whose TEST mode keeps only
self-chain documents with gold emotions (no stage-1 reconciliation, no full
cross-product negatives).
"""

from __future__ import annotations

import random
from typing import List, Optional, Sequence

from carel_tpu_torch.data.ecpe_format import Document
from carel_tpu_torch.data.pairs import PairExample, PairSet, _pair_text


def self_chain_doc_ids(docs: Sequence[Document]) -> List[str]:
    """Docs containing an e == c gold pair.

    Mirrors the reference's zip over (unique emotions, causes) — NOT over raw
    pairs (get_self_chain_docs :919-927), quirks included: a doc_id is
    appended once PER matching zip pair, so docs with several e == c pairs
    appear multiple times (the reader's `in` membership test makes the
    duplicates harmless, :950).
    """
    out = []
    for doc in docs:
        emotions = list(dict.fromkeys(e for e, _ in doc.pairs))
        causes = [c for _, c in doc.pairs]
        for e, c in zip(emotions, causes):
            if e == c:
                out.append(doc.doc_id)
    return out


def build_pairs_self_chain(
    docs: Sequence[Document],
    test: bool = False,
    spaced_sep: bool = False,
    rng: Optional[random.Random] = None,
) -> PairSet:
    """Pair construction for the self-chain variant.

    Train mode matches build_pairs' train mode (minus emotion labels, which
    this variant does not use). Test mode keeps only self-chain documents and
    enumerates (gold emotion x non-cause) negatives unsampled.
    """
    sample = (rng or random).sample
    chain_ids = set(self_chain_doc_ids(docs)) if test else None
    out = PairSet()

    for doc_index, doc in enumerate(docs):
        if test and doc.doc_id not in chain_ids:
            continue
        doc_len = doc.doc_len
        pos_pairs = [(e, c) for e, c in doc.pairs
                     if 1 <= e <= doc_len and 1 <= c <= doc_len]
        emotions = list(dict.fromkeys(e for e, _ in pos_pairs))
        causes = [c for _, c in pos_pairs]
        non_cause = [i + 1 for i in range(doc_len) if i + 1 not in causes]
        neg_pairs = [(e, nc) for e in emotions for nc in non_cause]
        if not test:
            neg_pairs = sample(neg_pairs, min(len(pos_pairs), len(neg_pairs)))

        sen_emo = {cl.sen_id: cl.emotion for cl in doc.clauses
                   if cl.emotion != 6}
        for label, plist in ((1, pos_pairs), (0, neg_pairs)):
            for e, c in plist:
                out.examples.append(PairExample(
                    pair=_pair_text(doc, e, c, spaced_sep),
                    label=label,
                    emotion=sen_emo.get(e, 6),
                    temporal_order=c <= e,
                    doc_index=doc_index,
                    emo_sen_id=e, cau_sen_id=c))
        out.docs_pair_size.append(len(pos_pairs) + len(neg_pairs))
    return out
