"""K10, the backward of the word, position and token-type lookups, one call
for the three tables (csrc/embedding.cu: a sort, a chunk and a combine
launch).

Least work: each table's ids (int64) and the gradient g [B L, D] read once
and every row of each table's gradient written once, fp32. 0.02552 ms at
64 x 96 ids over 21,128 + 512 + 2 rows, D 768 (bytes)."""

from harness.work import bound_ms as _bound

PATTERNS = [r"emb_bwd_(sort|chunk|combine)_kernel"]
CALL = r"emb_bwd_sort_kernel"


def nbytes(n: int, D: int, rows) -> float:
    return 8 * n * len(rows) + 4 * n * D + 4 * D * sum(rows)


def bound_ms(s: dict):
    if "tables" not in s:
        return None
    return _bound(nbytes(s["B"] * s["L"], s["D"], s["tables"]), 0.0)
