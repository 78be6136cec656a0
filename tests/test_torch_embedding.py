"""The fixed-order embedding backward (kernel K10, csrc/embedding.cu), on
the CPU, and the encoder's lookups.

The kernel runs only on the card. ``_emulated_backward`` repeats its four
steps in plain PyTorch: counts, each entry's rank among the earlier entries
of its index (so the entries sorted by index and position), sums of the
runs inside chunks of the sorted entries, and the pieces of the runs that
cross chunks added in chunk order. It is held against the sums that
``index_add_`` gives (rtol 1e-6 normwise; fp32 in another order) with short
chunks, so that runs cross several, and with one index holding every entry.
A table of a few rows with nearly every entry at one index (the token
types') is held the same way, and the encoder sends each of its lookups
through ``embedding``.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from carel_tpu_torch.models import encoder as tenc
from carel_tpu_torch.models.encoder import tiny_encoder_config
from carel_tpu_torch.ops import cuda_embedding


def _emulated_backward(ids, g, V, chunk):
    n, D = g.shape
    count = torch.bincount(ids, minlength=V)
    start = torch.cumsum(count, 0) - count
    sorted_e = torch.empty(n, dtype=torch.long)
    for e in range(n):
        rank = int((ids[:e] == ids[e]).sum())
        sorted_e[start[ids[e]] + rank] = e
    dW = torch.zeros(V, D)
    chunks = -(-n // chunk)
    part = torch.zeros(chunks, 2, D)
    for c in range(chunks):
        cs, ce = c * chunk, min(n, (c + 1) * chunk)
        j = cs
        while j < ce:
            v = int(ids[sorted_e[j]])
            rs, re = int(start[v]), int(start[v] + count[v])
            pe = min(re, ce)
            acc = torch.zeros(D)
            for jj in range(j, pe):
                acc = acc + g[sorted_e[jj]]
            if rs >= cs and re <= ce:
                dW[v] = acc
            else:
                part[c, 0 if rs < cs else 1] = acc
            j = pe
    for c in range(chunks):
        ce = (c + 1) * chunk
        if ce >= n:
            continue
        v = int(ids[sorted_e[ce - 1]])
        rs, re = int(start[v]), int(start[v] + count[v])
        if re <= ce or rs < c * chunk:
            continue
        acc = part[c, 1].clone()
        for c2 in range(c + 1, (re - 1) // chunk + 1):
            acc = acc + part[c2, 0]
        dW[v] = acc
    return dW, sorted_e


@pytest.mark.parametrize("case,chunk", [("zipf", 4), ("zipf", 64),
                                        ("one_index", 4), ("unique", 4)])
def test_emulated_backward_matches_index_add(case, chunk):
    rng = np.random.default_rng(len(case) + chunk)
    n, V, D = 150, 40, 7
    if case == "zipf":
        ids = np.minimum(rng.zipf(1.5, n) - 1, V - 1)
    elif case == "one_index":
        ids = np.zeros(n, np.int64)
    else:
        ids = rng.permutation(V)[: min(n, V)]
        n = len(ids)
    ids = torch.tensor(ids, dtype=torch.long)
    g = torch.tensor(rng.normal(size=(n, D)), dtype=torch.float32)
    dW, order = _emulated_backward(ids, g, V, chunk)
    # the sorted entries: by index, each index's in ascending position
    key = ids[order] * n + order
    assert bool((key[1:] > key[:-1]).all())
    want = torch.zeros(V, D).index_add_(0, ids, g)
    assert float(torch.linalg.vector_norm(dW - want)
                 / torch.linalg.vector_norm(want)) <= 1e-6


def test_embedding_is_the_plain_gather_on_the_cpu():
    w = torch.randn(30, 5, requires_grad=True)
    ids = torch.tensor([[1, 1, 29, 0], [3, 1, 1, 2]])
    g = torch.randn(2, 4, 5)
    out = cuda_embedding.embedding(ids, w)
    assert torch.equal(out, F.embedding(ids, w))
    (got,) = torch.autograd.grad(out, w, g)
    (want,) = torch.autograd.grad(F.embedding(ids, w), w, g)
    assert torch.equal(got, want)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_embedding.embedding_backward_kernel(ids.reshape(-1),
                                                 g.reshape(-1, 5), 30)


@pytest.mark.parametrize("rows", [1, 2, 3])
def test_emulated_backward_over_a_small_table(rows):
    """The token types' case: a table of a few rows, nearly every entry at
    index 0, so that one run crosses every chunk."""
    rng = np.random.default_rng(rows)
    n, D = 300, 6
    ids = np.where(rng.random(n) < 0.95, 0, rng.integers(0, rows, n))
    ids = torch.tensor(ids, dtype=torch.long)
    g = torch.tensor(rng.normal(size=(n, D)), dtype=torch.float32)
    dW, _ = _emulated_backward(ids, g, rows, 16)
    want = torch.zeros(rows, D).index_add_(0, ids, g)
    assert float(torch.linalg.vector_norm(dW - want)
                 / torch.linalg.vector_norm(want)) <= 1e-6


@pytest.mark.parametrize("arch", ["bert", "roberta"])
def test_encoder_lookups_go_through_embedding(arch, monkeypatch):
    """Every table of the encoder's embeddings is read by ``embedding``, the
    gather whose backward is K10 on the card."""
    seen = []

    def counted(ids, weight):
        seen.append(weight)
        return cuda_embedding.embedding(ids, weight)

    monkeypatch.setattr(tenc, "embedding", counted)
    cfg = tiny_encoder_config(vocab_size=50, dropout=0.0, arch=arch)
    enc = tenc.TransformerEncoder(cfg)
    ids = torch.randint(3, 50, (2, 7))
    enc(ids, torch.ones(2, 7, dtype=torch.long))
    tables = [enc.word_embeddings.weight, enc.position_embeddings.weight]
    if enc.token_type_embeddings is not None:
        tables.append(enc.token_type_embeddings.weight)
    assert len(seen) == len(tables)
    assert all(a is b for a, b in zip(seen, tables))
