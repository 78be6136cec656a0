"""The encoder's embedding lookups, whose backward adds in a fixed order:
CUDA kernel K10.

The encoder adds its word, position and token-type lookups into one output.
Each lookup is a gather, whose gradient adds the output gradients of every
entry with the same index; all three take the same output gradient.
torch's CUDA embedding backward fixes no order for that sum (over the token
types' table of two rows it did not repeat its bits on the card), and bf16
would carry any difference on through training. ``embeddings`` keeps the
gathers, added as ``(word + position) + token_type``, and gives the sum one
backward, ``embeddings_backward_kernel``
(``carel_tpu_torch/csrc/embedding.cu``): one call a step for every table, in
three launches (a stable radix sort of each table's entries by index beside
the zeros of the absent rows; sums of chunks of the sorted entries; the runs
that cross chunks added in chunk order), with no float atomics, so the same
inputs give the same bits on every run and every replay of a captured step.
The JAX package's gather transposes into XLA's scatter-add.

A CPU weight takes ``torch.nn.functional.embedding`` and its own backward,
the plain version; a CUDA weight runs the kernel or raises. There is no
fallback. ``embeddings_backward_plain`` (one ``index_add_`` a table) is the
yardstick the kernel is held against; the port does not call it.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F

from carel_tpu_torch.ops import native

# kernel launches since the last reset, counted where the C entry point runs
launches = {"emb_bwd": 0}


def embeddings_backward_kernel(ids: Sequence[torch.Tensor], g: torch.Tensor,
                               rows: Sequence[int]) -> list:
    """K10: for each table t (one to three), dW_t [rows[t], D] with dW_t[v]
    the sum of the rows of g [n, D] whose id in ids[t] [n] (int64, in [0,
    rows[t])) is v, in ascending row order; 0 where there is none. One call,
    three device kernels."""
    if g.device.type != "cuda":
        raise ValueError(f"embedding backward kernel: g on {g.device}, "
                         "expected a CUDA tensor")
    lib = native.lib()
    tables = len(ids)
    if not 1 <= tables <= lib.carel_emb_max_tables() or len(rows) != tables:
        raise ValueError(f"embedding backward kernel: {tables} id tensors "
                         f"and {len(rows)} tables; it takes 1 to "
                         f"{lib.carel_emb_max_tables()}")
    n, D = g.shape
    native.check_input(g, "g", (n, D), g.device)
    for t, table_ids in enumerate(ids):
        native.check_input(table_ids, f"ids[{t}]", (n,), g.device,
                           torch.int64)
    scratch = torch.empty(lib.carel_emb_bwd_scratch(n, D, tables),
                          dtype=torch.uint8, device=g.device)
    dWs = [torch.empty(V, D, dtype=torch.float32, device=g.device)
           for V in rows]
    unused = 3 - tables
    native.check(lib.carel_emb_bwd(
        *[t.data_ptr() for t in ids], *[None] * unused,
        *rows, *[1] * unused, tables, g.data_ptr(), n, D,
        scratch.data_ptr(), *[w.data_ptr() for w in dWs], *[None] * unused,
        native.stream(g.device)), "embedding backward kernel")
    launches["emb_bwd"] += 1
    return dWs


def embeddings_backward_plain(ids: Sequence[torch.Tensor], g: torch.Tensor,
                              rows: Sequence[int]) -> list:
    """The plain version of ``embeddings_backward_kernel``: one
    ``index_add_`` a table, in no fixed order on CUDA."""
    return [torch.zeros(V, g.shape[1], dtype=torch.float32,
                        device=g.device).index_add_(0, t, g)
            for t, V in zip(ids, rows)]


def _lookups(ids, weights) -> torch.Tensor:
    out = F.embedding(ids[0], weights[0])
    for i, w in zip(ids[1:], weights[1:]):
        out = out + F.embedding(i, w)
    return out


class _Embeddings(torch.autograd.Function):
    @staticmethod
    def forward(ctx, tables, *args):
        ids, weights = args[:tables], args[tables:]
        ctx.tables = tables
        ctx.shapes = [(w.shape[0], w.dtype) for w in weights]
        ctx.save_for_backward(*[i.reshape(-1).long().contiguous()
                                for i in ids])
        return _lookups(ids, weights)

    @staticmethod
    def backward(ctx, g):
        tables = ctx.tables
        wanted = [t for t in range(tables)
                  if ctx.needs_input_grad[1 + tables + t]]
        grads = [None] * tables
        if wanted:
            ids = ctx.saved_tensors
            dWs = embeddings_backward_kernel(
                [ids[t] for t in wanted],
                g.reshape(-1, g.shape[-1]).float().contiguous(),
                [ctx.shapes[t][0] for t in wanted])
            for t, dW in zip(wanted, dWs):
                grads[t] = dW.to(ctx.shapes[t][1])
        return (None, *[None] * tables, *grads)


def embeddings(ids: Sequence[torch.Tensor],
               weights: Sequence[torch.Tensor]) -> torch.Tensor:
    """``weights[0][ids[0]] + weights[1][ids[1]] + ...``, added left to
    right: the plain ``F.embedding`` lookups on the CPU; on CUDA the same
    lookups with one call of K10 as the backward of them all."""
    if len(ids) != len(weights):
        raise ValueError(f"{len(ids)} id tensors for {len(weights)} tables")
    if weights[0].device.type == "cpu":
        return _lookups(ids, weights)
    return _Embeddings.apply(len(ids), *ids, *weights)
