"""K4, the fused BoW loss's backward (csrc/bow.cu: bow_bwd_kernel).

Least work: z, dW and dh products (3 x 2 B D V) and ~10 operations a
logit; W and b read and dW, db written once, h read and dh written, the
row scalars, and the T corrections with their indices read once.
0.00678 ms at B 64, D 48, V 23,808, T 128 (ops, fp32 peak)."""

from harness.work import bound_ms as _bound

PATTERNS = [r"bow_bwd_kernel"]
CALL = r"bow_bwd_kernel"


def work(B: int, D: int, V: int, T: int):
    w_bytes = 4 * (V * D + V)
    return (2 * w_bytes + 2 * 4 * B * D + 4 * 5 * B + 12 * B * T,
            3 * 2 * B * D * V + 10 * B * V)


def bound_ms(s: dict):
    if "bow_vocab" not in s:
        return None
    return _bound(*work(s["B"], s["bow_hidden"], s["bow_vocab"],
                        s["bow_slots"]))
