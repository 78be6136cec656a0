"""K1, the MMD statistic's forward (csrc/mmd.cu: mmd_fwd_kernel).

Least work for the function: each row's squared norm once (2 B rows of d
FMA); per distinct pair (B(B-1)/2 in each within-sample block, whose
diagonal drops out, B^2 across) the dot product and the scalar work of
|a|^2 + |b|^2 - 2 a.b, abs, eps and per alpha a scale and an exp; the
inputs read once. 0.00000689 ms at B 64, d 24, one alpha (ops)."""

from harness.work import bound_ms as _bound

PATTERNS = [r"mmd_fwd_kernel"]
CALL = r"mmd_fwd_kernel"


def work(B: int, d: int, alphas: int):
    pairs = B * (B - 1) + B * B
    in_bytes = 4 * (2 * B * d + B)
    norms = 2 * B * 2 * d
    pair_ops = 2 * d + 6 + 2 * alphas
    return in_bytes + 4, norms + pairs * pair_ops


def bound_ms(s: dict):
    if "latent" not in s:
        return None
    return _bound(*work(s["B"], s["latent"], s["mmd_alphas"]))
