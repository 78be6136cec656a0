"""K2, the MMD statistic's backward (csrc/mmd.cu: mmd_bwd_kernel).

Least work: the forward's per-pair Gram work rebuilt once, a coefficient,
and c (a - b) accumulated into both output rows the pair reaches; the
inputs and the two gradients once. 0.0000187 ms at B 64, d 24 (ops)."""

from harness.work import bound_ms as _bound

PATTERNS = [r"mmd_bwd_kernel"]
CALL = r"mmd_bwd_kernel"


def work(B: int, d: int, alphas: int):
    pairs = B * (B - 1) + B * B
    in_bytes = 4 * (2 * B * d + B)
    norms = 2 * B * 2 * d
    pair_ops = 2 * d + 6 + 2 * alphas
    return (in_bytes + 8 + 4 * 2 * B * d,
            norms + pairs * (pair_ops + 1 + 2 * 2 * d))


def bound_ms(s: dict):
    if "latent" not in s:
        return None
    return _bound(*work(s["B"], s["latent"], s["mmd_alphas"]))
