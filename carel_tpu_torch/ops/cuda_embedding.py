"""Embedding lookups whose backward adds in a fixed order: CUDA kernel K10.

The encoder's word, position and token-type lookups are gathers, whose
gradient adds the output gradients of every entry with the same index.
torch's CUDA embedding backward fixes no order for that sum (over the
token types' table of two rows it did not repeat its bits on the card), and
bf16 would carry any difference on through training. ``embedding`` keeps the gather and gives it
the backward ``embedding_backward_kernel``
(``carel_tpu_torch/csrc/embedding.cu``): every index's entries sorted by
position and added in that order, with no float atomics, so the same inputs
give the same bits on every run and every replay of a captured step. The
JAX package's gather transposes into XLA's scatter-add.

A CPU weight takes ``torch.nn.functional.embedding`` and its own backward,
the plain version; a CUDA weight runs the kernel or raises. There is no
fallback.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from carel_tpu_torch.ops import native

# kernel launches since the last reset, counted where the C entry point runs
launches = {"emb_bwd": 0}


def embedding_backward_kernel(ids: torch.Tensor, g: torch.Tensor,
                              V: int) -> torch.Tensor:
    """K10: dW [V, D] with dW[v] = the sum of the rows of g [n, D] whose id
    [n] (int64, in [0, V)) is v, in ascending row order. Five launches of
    the kernel (count, rank, place, chunk sums, combine), an integer cumsum,
    and dW's zeros."""
    if g.device.type != "cuda":
        raise ValueError(f"embedding backward kernel: g on {g.device}, "
                         "expected a CUDA tensor")
    n, D = g.shape
    lib = native.lib()
    if D > lib.carel_emb_max_dim():
        raise ValueError(f"embedding backward kernel: D = {D} exceeds "
                         f"{lib.carel_emb_max_dim()}")
    native.check_input(ids, "ids", (n,), g.device, torch.int64)
    native.check_input(g, "g", (n, D), g.device)
    stream = native.stream(g.device)
    counts = torch.zeros(V + n, dtype=torch.int32, device=g.device)
    count, rank = counts[:V], counts[V:]
    native.check(lib.carel_emb_count(ids.data_ptr(), n, V, count.data_ptr(),
                                     rank.data_ptr(), stream),
                 "embedding backward kernel")
    start = torch.cumsum(count, 0, dtype=torch.int32) - count
    scratch = torch.empty(lib.carel_emb_bwd_scratch(n, D), dtype=torch.uint8,
                          device=g.device)
    dW = torch.zeros(V, D, dtype=torch.float32, device=g.device)
    native.check(lib.carel_emb_bwd(ids.data_ptr(), g.data_ptr(), n, D, V,
                                   count.data_ptr(), start.data_ptr(),
                                   rank.data_ptr(), scratch.data_ptr(),
                                   dW.data_ptr(), stream),
                 "embedding backward kernel")
    launches["emb_bwd"] += 1
    return dW


class _Embedding(torch.autograd.Function):
    @staticmethod
    def forward(ctx, ids, weight):
        ctx.save_for_backward(ids)
        ctx.num_rows = weight.shape[0]
        ctx.weight_dtype = weight.dtype
        return F.embedding(ids, weight)

    @staticmethod
    def backward(ctx, g):
        (ids,) = ctx.saved_tensors
        dW = embedding_backward_kernel(
            ids.reshape(-1).long().contiguous(),
            g.reshape(-1, g.shape[-1]).float().contiguous(), ctx.num_rows)
        return None, dW.to(ctx.weight_dtype)


def embedding(ids: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """``weight[ids]``: the plain ``F.embedding`` on the CPU; on CUDA the
    same gather with K10 as its backward."""
    if weight.device.type == "cpu":
        return F.embedding(ids, weight)
    return _Embedding.apply(ids, weight)
