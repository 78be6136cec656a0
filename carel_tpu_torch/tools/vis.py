"""Domain-shift visualization; port of carel_tpu/tools/vis.py (host only).

Embed documents (TF-IDF or a given embedder), reduce to 2-d with PCA,
t-SNE or LDA by domain label, and scatter-plot them colored by domain into a
PNG (the reference's cd_ecpe_vis / doc_cluster_vis scripts). sklearn and
matplotlib are imported where they are used, so the module imports on a
machine without them.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np


def embed_tfidf(texts: Sequence[str], tokenizer=None, max_features: int = 5000
                ) -> np.ndarray:
    from sklearn.feature_extraction.text import TfidfVectorizer

    vec = TfidfVectorizer(tokenizer=tokenizer, max_features=max_features)
    return vec.fit_transform(list(texts)).toarray()


def reduce_2d(embeddings: np.ndarray, method: str = "pca",
              seed: int = 42, labels: Optional[Sequence] = None
              ) -> np.ndarray:
    if method == "pca":
        from sklearn.decomposition import PCA

        return PCA(n_components=2, random_state=seed).fit_transform(embeddings)
    if method == "tsne":
        from sklearn.manifold import TSNE

        n = embeddings.shape[0]
        perplexity = min(30.0, max(2.0, (n - 1) / 3))
        return TSNE(n_components=2, random_state=seed,
                    perplexity=perplexity, init="pca").fit_transform(
            embeddings)
    if method == "lda":
        # supervised Linear Discriminant projection by domain label
        # (en/chi_doc_cluster_vis.py:19,103-110)
        from sklearn.discriminant_analysis import LinearDiscriminantAnalysis

        if labels is None:
            raise ValueError("lda reduction needs domain labels")
        y = np.asarray(labels)
        n_comp = min(2, len(np.unique(y)) - 1)
        pts = LinearDiscriminantAnalysis(
            n_components=n_comp).fit_transform(embeddings, y)
        if pts.shape[1] == 1:  # 2 domains -> 1 discriminant axis; pad
            pts = np.concatenate([pts, np.zeros_like(pts)], axis=1)
        return pts
    raise ValueError(f"unknown reduction {method}")


def plot_domains(
    points2d: np.ndarray,
    labels: Sequence,
    out_path: str,
    title: str = "domain shift",
) -> str:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    labels = np.asarray(labels)
    fig, ax = plt.subplots(figsize=(8, 6))
    for lab in np.unique(labels):
        m = labels == lab
        ax.scatter(points2d[m, 0], points2d[m, 1], s=8, alpha=0.6,
                   label=str(lab))
    ax.legend(markerscale=2, fontsize=8)
    ax.set_title(title)
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path


def visualize_domain_shift(
    texts: Sequence[str],
    labels: Sequence,
    out_path: str,
    embedder: Optional[Callable[[Sequence[str]], np.ndarray]] = None,
    method: str = "pca",
    tokenizer=None,
) -> str:
    emb = (embedder(texts) if embedder is not None
           else embed_tfidf(texts, tokenizer))
    pts = reduce_2d(np.asarray(emb), method, labels=labels)
    return plot_domains(pts, labels, out_path)
