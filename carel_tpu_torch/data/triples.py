"""CIT (conditional-independence triple) data construction, a copy of
carel_tpu/data/triples.py.

Reproduces mc_classifier.py's triple building (:95-148): per gold pair, a
positive triple "emotion [SEP] conditioned [SEP] cause" and a negative triple
whose middle element is the 3rd-nearest neighbour of the cause clause under
L2 over sentence embeddings. Self-chain pairs (e == c) condition on the
emotion clause itself.

The reference used faiss and a downloaded SimCSE model; here KNN is exact
numpy (documents have <= 75 clauses) and the embedder is any callable
List[str] -> np.ndarray, e.g. carel_tpu_torch.embeddings.EncoderEmbedder.
``triples_from_predicted_pairs`` takes a pandas DataFrame and imports
nothing of pandas itself.
"""

from __future__ import annotations

from typing import Callable, Iterable, List, Sequence, Tuple

import numpy as np

from carel_tpu_torch.data.ecpe_format import Document
from carel_tpu_torch.data.pairs import PairExample, PairSet


def _knn_index(embeddings: np.ndarray, query_idx: int, k: int) -> int:
    """Index of the k-th nearest neighbour (0-based k; k=2 = faiss's [0][2],
    i.e. 3rd closest including the query itself)."""
    q = embeddings[query_idx]
    d2 = ((embeddings - q[None, :]) ** 2).sum(-1)
    order = np.argsort(d2, kind="stable")
    return int(order[min(k, len(order) - 1)])


def build_cit_triples(
    docs: Sequence[Document],
    embedder: Callable[[List[str]], np.ndarray],
    neighbor_rank: int = 2,
) -> PairSet:
    """Train triples with embedding-KNN negatives (mc_classifier :95-148)."""
    out = PairSet()
    for doc_index, doc in enumerate(docs):
        texts = [cl.text_field3.strip().replace(" ", "")
                 for cl in doc.clauses]
        if not doc.pairs:
            out.docs_pair_size.append(0)
            continue
        emb = np.asarray(embedder(texts))
        n_added = 0
        for e, c in doc.pairs:
            if not (1 <= e <= len(texts) and 1 <= c <= len(texts)):
                continue
            if e == c:
                pos = f"{texts[e-1]}[SEP]{texts[e-1]}[SEP]{texts[e-1]}"
                nn = _knn_index(emb, e - 1, neighbor_rank)
                neg = f"{texts[e-1]}[SEP]{texts[nn]}[SEP]{texts[e-1]}"
            else:
                pos = f"{texts[e-1]}[SEP]{texts[c-1]}[SEP]{texts[c-1]}"
                nn = _knn_index(emb, c - 1, neighbor_rank)
                neg = f"{texts[e-1]}[SEP]{texts[nn]}[SEP]{texts[c-1]}"
            out.examples.append(PairExample(
                pair=pos, label=1, emotion=doc.clause(e).emotion,
                temporal_order=c <= e, doc_index=doc_index,
                emo_sen_id=e, cau_sen_id=c))
            out.examples.append(PairExample(
                pair=neg, label=0, emotion=doc.clause(e).emotion,
                temporal_order=c <= e, doc_index=doc_index,
                emo_sen_id=e, cau_sen_id=c))
            n_added += 2
        out.docs_pair_size.append(n_added)
    return out


def predicted_triples(rows: Iterable[Tuple[int, str, int]]
                      ) -> Tuple[PairSet, List[int]]:
    """Test triples from predicted-positive pairs (read_pair_data,
    mc_classifier :150-165): each (index, "e[SEP]c", emotion) becomes the
    triple "e[SEP]c[SEP]c"; returns them and the indices kept (a text with
    no [SEP] is skipped)."""
    out = PairSet()
    indices: List[int] = []
    for i, text, emotion in rows:
        parts = str(text).split("[SEP]")
        if len(parts) < 2:
            continue
        triple = "[SEP]".join([parts[0], parts[1], parts[1]])
        out.examples.append(PairExample(
            pair=triple, label=1, emotion=emotion, temporal_order=True,
            doc_index=0))
        indices.append(i)
    out.docs_pair_size.append(len(out.examples))
    return out, indices


def triples_from_predicted_pairs(pred_df) -> PairSet:
    """predicted_triples over a pair-inference prediction table's rows
    whose label is 1 (its emotion column, where it has one, else 6)."""
    has_emotion = "emotion" in pred_df.columns
    pos = pred_df[pred_df["label"] == 1]
    return predicted_triples(
        (i, row["pair"], int(row["emotion"]) if has_emotion else 6)
        for i, (_, row) in enumerate(pos.iterrows()))[0]
