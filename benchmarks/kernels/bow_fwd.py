"""K3, the fused BoW loss's forward (csrc/bow.cu: bow_fwd_kernel).

Least work: the logits z = h W^T + b once (2 B D V) and ~8 elementwise
operations a logit; W, b and h read once and four scalars a row written.
0.00237 ms at B 64, D 48, V 23,808 (ops, fp32 peak)."""

from harness.work import bound_ms as _bound

PATTERNS = [r"bow_fwd_kernel"]
CALL = r"bow_fwd_kernel"


def work(B: int, D: int, V: int):
    w_bytes = 4 * (V * D + V)
    return w_bytes + 4 * B * D + 4 * 4 * B, 2 * B * D * V + 8 * B * V


def bound_ms(s: dict):
    if "bow_vocab" not in s:
        return None
    return _bound(*work(s["B"], s["bow_hidden"], s["bow_vocab"]))
