"""The fixed-order embedding backward (kernel K10, csrc/embedding.cu), on
the CPU, and the encoder's lookups.

The kernel runs only on the card. ``_emulated_backward`` repeats its steps
for one call over one to three tables in plain PyTorch: the zeros of the
rows of absent indices; each table's stable LSD radix sort by index (a warp
a contiguous segment walked 32 entries a round, each entry ranked among the
equal digits of its round, the places from the exclusive scan of the
(digit, warp) counts; a key packs index and entry, or is the entry alone);
the sums of the runs inside chunks of the sorted entries; the pieces of the
runs that cross chunks added in chunk order. Every row must be written
exactly once. It is held against the sums that ``index_add_`` gives (rtol
1e-6 normwise; fp32 in another order) with short chunks, so that runs cross
several, with one index holding every entry, over small tables (the token
types'), and over the encoder's three tables in the bert, roberta and
no-token-type layouts; the sort with the kernel's digits and warps and with
narrower ones (several passes and rounds). The encoder's lookups go through
the one ``embeddings`` call, whose CPU forward and gradients are those of the
three plain lookups, and off the CPU through the one autograd Function
whose backward is the kernel (it raises, with no fallback, where there is
no card). On the card (``cuda``-marked) the kernel equals the emulator bit
for bit.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from carel_tpu_torch.models import encoder as tenc
from carel_tpu_torch.models.encoder import tiny_encoder_config
from carel_tpu_torch.ops import cuda_embedding

# the kernel's sort: 8-bit digits, 32 warps; its chunks of 64 sorted entries
KERNEL_SORT = {"digit_bits": 8, "warps": 32}
KERNEL_CHUNK = 64


def _radix_sort(ids, V, digit_bits=8, warps=32, packed=True):
    """(entries, indices): the kernel's stable LSD radix sort of one table's
    entries by index, step by step."""
    ids = [int(v) for v in ids]
    n = len(ids)
    ebits = (n - 1).bit_length()
    ibits = (V - 1).bit_length()

    def index_of(key):
        return key >> ebits if packed else ids[key]

    keys = [(v << ebits) | e if packed else e for e, v in enumerate(ids)]
    seg = -(-n // warps)
    bounds = [(min(n, w * seg), min(n, w * seg + seg)) for w in range(warps)]
    for shift in range(0, ibits, digit_bits):
        mask = (1 << min(digit_bits, ibits - shift)) - 1
        digit = [(index_of(k) >> shift) & mask for k in keys]
        hist = np.zeros((1 << digit_bits, warps), np.int64)
        for w, (lo, hi) in enumerate(bounds):
            for i in range(lo, hi):
                hist[digit[i], w] += 1
        flat = hist.reshape(-1)
        at = (np.cumsum(flat) - flat).reshape(hist.shape)
        out = [None] * n
        for w, (lo, hi) in enumerate(bounds):
            for base in range(lo, hi, 32):
                rnd = range(base, min(hi, base + 32))
                for i in rnd:  # rank among the equal digits below its lane
                    rank = sum(digit[j] == digit[i] for j in range(base, i))
                    out[at[digit[i], w] + rank] = keys[i]
                for i in rnd:
                    at[digit[i], w] += 1
        assert all(k is not None for k in out)
        keys = out
    emask = (1 << ebits) - 1
    entries = [k & emask if packed else k for k in keys]
    return entries, [index_of(k) for k in keys]


def _emulated_table(ids, g, V, chunk, **sort_kw):
    n, D = g.shape
    se, sv = _radix_sort(ids, V, **sort_kw)
    dW = torch.full((V, D), float("nan"))
    written = np.zeros(V, np.int64)
    present = set(int(v) for v in ids)
    for v in range(V):  # (1) the zeros of absent rows
        if v not in present:
            dW[v] = 0.0
            written[v] += 1
    chunks = -(-n // chunk)
    part = torch.full((chunks, 2, D), float("nan"))
    for c in range(chunks):  # (2)
        cs = c * chunk
        m = min(n, cs + chunk) - cs
        from_before = cs > 0 and sv[cs - 1] == sv[cs]
        goes_on = cs + m < n and sv[cs + m] == sv[cs + m - 1]
        acc, piece = torch.zeros(D), 0
        for j in range(m):
            acc = acc + g[se[cs + j]]
            if j + 1 < m and sv[cs + j + 1] == sv[cs + j]:
                continue
            if piece == 0 and from_before:
                part[c, 0] = acc
            elif j == m - 1 and goes_on:
                part[c, 1] = acc
            else:
                dW[sv[cs + j]] = acc
                written[sv[cs + j]] += 1
            piece, acc = j + 1, torch.zeros(D)
    for c in range(chunks):  # (3)
        cs, ce = c * chunk, (c + 1) * chunk
        if ce >= n:
            continue
        v = sv[ce - 1]
        if sv[ce] != v or (cs > 0 and sv[cs - 1] == v):
            continue
        last = max(i for i in range(ce, n) if sv[i] == v) // chunk
        acc = part[c, 1].clone()
        for c2 in range(c + 1, last + 1):
            acc = acc + part[c2, 0]
        dW[v] = acc
        written[v] += 1
    assert bool((written == 1).all()), "every row written exactly once"
    return dW, se, sv


def _emulated_backward(ids, g, rows, chunk=KERNEL_CHUNK, **sort_kw):
    """The kernel's dWs, one a table, for one call over the tables."""
    return [_emulated_table(t, g, V, chunk, **sort_kw)[0]
            for t, V in zip(ids, rows)]


def _relerr(got, want):
    return float(torch.linalg.vector_norm(got - want)
                 / torch.linalg.vector_norm(want))


def _check_sorted(ids, se, sv):
    ids = torch.as_tensor(ids)
    se, sv = torch.tensor(se), torch.tensor(sv)
    assert torch.equal(ids[se], sv)
    key = sv * len(se) + se  # by index, each index's in ascending position
    assert bool((key[1:] > key[:-1]).all())


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
    dW, order, indices = _emulated_table(ids, g, V, chunk)
    _check_sorted(ids, order, indices)
    want = torch.zeros(V, D).index_add_(0, ids, g)
    assert _relerr(dW, want) <= 1e-6


def test_embedding_is_the_plain_gather_on_the_cpu():
    w = torch.randn(30, 5, requires_grad=True)
    ids = torch.tensor([[1, 1, 29, 0], [3, 1, 1, 2]])
    g = torch.randn(2, 4, 5)
    out = cuda_embedding.embeddings([ids], [w])
    assert torch.equal(out, F.embedding(ids, w))
    (got,) = torch.autograd.grad(out, w, g)
    (want,) = torch.autograd.grad(F.embedding(ids, w), w, g)
    assert torch.equal(got, want)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_embedding.embeddings_backward_kernel([ids.reshape(-1)],
                                                  g.reshape(-1, 5), [30])


@pytest.mark.parametrize("rows", [1, 2, 3])
def test_emulated_backward_over_a_small_table(rows):
    """The token types' case: a table of a few rows, nearly every entry at
    index 0, so that one run crosses every chunk."""
    rng = np.random.default_rng(rows)
    n, D = 300, 6
    ids = np.where(rng.random(n) < 0.95, 0, rng.integers(0, rows, n))
    ids = torch.tensor(ids, dtype=torch.long)
    g = torch.tensor(rng.normal(size=(n, D)), dtype=torch.float32)
    (dW,) = _emulated_backward([ids], g, [rows], 16)
    want = torch.zeros(rows, D).index_add_(0, ids, g)
    assert _relerr(dW, want) <= 1e-6


def _layout_ids(layout, rng, B, L, V):
    """(ids of each table, rows of each table) as the encoder hands them to
    the backward: Zipf-like words; bert positions 0..L-1 and two type rows
    (types all 0, as the encoder's default); roberta positions
    cumsum(mask) * mask + 1 over 2 + L rows and one type row; no types."""
    words = np.minimum(rng.zipf(1.3, (B, L)) - 1, V - 1)
    if layout == "roberta":
        mask = np.arange(L)[None, :] < rng.integers(1, L + 1, B)[:, None]
        pos, pos_rows = np.cumsum(mask, axis=1) * mask + 1, L + 2
        types, type_rows = np.zeros((B, L), np.int64), 1
    else:
        pos, pos_rows = np.broadcast_to(np.arange(L), (B, L)), L
        types, type_rows = np.zeros((B, L), np.int64), 2
    ids = [words, pos] + ([types] if layout != "no_types" else [])
    rows = [V, pos_rows] + ([type_rows] if layout != "no_types" else [])
    return [torch.tensor(np.ascontiguousarray(i).reshape(-1),
                         dtype=torch.long) for i in ids], rows


@pytest.mark.parametrize("layout", ["bert", "roberta", "no_types"])
@pytest.mark.parametrize("chunk,sort_kw", [
    (8, KERNEL_SORT), (KERNEL_CHUNK, KERNEL_SORT),
    (8, {"digit_bits": 2, "warps": 3}),
    (8, {"digit_bits": 3, "warps": 5, "packed": False})])
def test_emulated_three_tables_match_index_add(layout, chunk, sort_kw):
    """One call over the encoder's tables: each table's dW within 1e-6
    normwise of index_add_, its entries sorted by (index, entry)."""
    rng = np.random.default_rng(len(layout) + chunk)
    B, L, V, D = 6, 19, 37, 5
    ids, rows = _layout_ids(layout, rng, B, L, V)
    g = torch.tensor(rng.normal(size=(B * L, D)), dtype=torch.float32)
    got = _emulated_backward(ids, g, rows, chunk, **sort_kw)
    want = cuda_embedding.embeddings_backward_plain(ids, g, rows)
    assert len(got) == len(want) == len(rows)
    for t, (a, b) in enumerate(zip(got, want)):
        assert a.shape == (rows[t], D)
        assert _relerr(a, b) <= 1e-6, t
        _, se, sv = _emulated_table(ids[t], g, rows[t], chunk, **sort_kw)
        _check_sorted(ids[t], se, sv)


@pytest.mark.parametrize("arch", ["bert", "roberta"])
def test_encoder_lookups_go_through_embedding(arch, monkeypatch):
    """Every table of the encoder's embeddings is read by one call of
    ``embeddings``, the sum whose backward is one K10 call on the card."""
    seen = []

    def counted(ids, weights):
        seen.append(list(weights))
        return cuda_embedding.embeddings(ids, weights)

    monkeypatch.setattr(tenc, "embeddings", counted)
    cfg = tiny_encoder_config(vocab_size=50, dropout=0.0, arch=arch)
    enc = tenc.TransformerEncoder(cfg)
    ids = torch.randint(3, 50, (2, 7))
    enc(ids, torch.ones(2, 7, dtype=torch.long))
    tables = [enc.word_embeddings.weight, enc.position_embeddings.weight]
    if enc.token_type_embeddings is not None:
        tables.append(enc.token_type_embeddings.weight)
    assert len(seen) == 1 and len(seen[0]) == len(tables)
    assert all(a is b for a, b in zip(seen[0], tables))


@pytest.mark.parametrize("layout", ["bert", "roberta", "no_types"])
def test_embeddings_on_the_cpu_are_the_plain_lookups(layout):
    """On the CPU the forward is bit-equal to (word + position) + token
    type of the plain lookups, and so are the gradients of every table."""
    rng = np.random.default_rng(4)
    ids, rows = _layout_ids(layout, rng, 3, 11, 29)
    ids = [i.reshape(3, 11) for i in ids]
    ws = [torch.tensor(rng.normal(size=(V, 8)), dtype=torch.float32,
                       requires_grad=True) for V in rows]
    g = torch.tensor(rng.normal(size=(3, 11, 8)), dtype=torch.float32)
    out = cuda_embedding.embeddings(ids, ws)
    want = F.embedding(ids[0], ws[0]) + F.embedding(ids[1], ws[1])
    if len(ws) == 3:
        want = want + F.embedding(ids[2], ws[2])
    assert torch.equal(out, want)
    assert out.grad_fn.name() == want.grad_fn.name()  # no Function of K10
    got = torch.autograd.grad(out, ws, g)
    for a, b in zip(got, torch.autograd.grad(want, ws, g)):
        assert torch.equal(a, b)


def test_embeddings_off_the_cpu_take_one_function():
    """A weight off the CPU (here on the meta device) goes through the one
    autograd Function of K10: the same forward as the plain lookups, and a
    backward that launches the kernel or raises: with no card it raises,
    with no fallback."""
    ids = [torch.zeros(2, 3, dtype=torch.long, device="meta")] * 3
    ws = [torch.empty(V, 4, device="meta", requires_grad=True)
          for V in (10, 3, 2)]
    out = cuda_embedding.embeddings(ids, ws)
    assert out.shape == (2, 3, 4)
    assert type(out.grad_fn).__name__ == "_EmbeddingsBackward"
    with pytest.raises(ValueError, match="CUDA"):
        torch.autograd.grad(out, ws, torch.empty(2, 3, 4, device="meta"))


# the float4 path (D = 24); the float path (D = 23, or g off a 16-byte
# boundary); one table of 70,000 rows at 40,000 entries, whose keys fit
# neither 32 bits (17 + 16) nor shared memory
@pytest.mark.cuda
@pytest.mark.parametrize("layout,D", [
    ("bert", 24), ("roberta", 24), ("no_types", 24), ("bert", 23),
    ("unaligned", 24), ("wide", 8)])
def test_kernel_equals_the_emulator(layout, D):
    """On the card: the kernel's dWs bit-equal to the emulator's over one
    call, with runs across several chunks."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    rng = np.random.default_rng(7)
    if layout == "wide":
        rows = [70000]
        ids = [torch.tensor(rng.integers(0, rows[0], 40000))]
    else:
        ids, rows = _layout_ids(layout.replace("unaligned", "bert"), rng, 40,
                                33, 300)
    n = len(ids[0])
    g = torch.tensor(rng.normal(size=(n, D)), dtype=torch.float32)
    want = _emulated_backward(ids, g, rows)
    g_card = g.cuda()
    if layout == "unaligned":
        g_card = torch.empty(n * D + 1, device="cuda")[1:].view(n, D)
        g_card.copy_(g)
        assert g_card.data_ptr() % 16 != 0
    got = cuda_embedding.embeddings_backward_kernel(
        [i.cuda() for i in ids], g_card, rows)
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b)
