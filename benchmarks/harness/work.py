"""The yardstick's arithmetic: the card's peaks, the model FLOPs of a step
and the least-work bound of a kernel. Frozen here so that a change to the
program cannot move it.

Peaks: NVIDIA's data sheet for the H100 SXM at 700 W, dense rates.
"""

from __future__ import annotations

PEAK_BF16_FLOPS = 989e12
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES = 3.35e12


def encoder_fwd_flops(rows: int, L: int, d: int = 768, layers: int = 12,
                      ffn: int = 3072) -> float:
    """Matmul FLOPs of one encoder forward over ``rows`` sequences of
    ``L`` tokens: the q, k, v and output projections, the MLP, and the two
    attention products."""
    proj = 2 * 4 * d * d + 2 * 2 * d * ffn
    attn = 2 * 2 * L * d
    return float(rows * L * layers * (proj + attn))


def carel_heads_fwd_flops(rows: int, d: int = 768, ec_dim: int = 24,
                          classes: int = 6, bow_dim: int = 0) -> float:
    """The CAREL heads' forward: four latent projections, the three
    classifiers and, with ``bow_dim``, the BoW decoder over the pair
    embedding."""
    return float(rows * 2 * (4 * d * ec_dim + ec_dim * classes + ec_dim
                             + 2 * ec_dim + 2 * ec_dim * bow_dim))


def train_flops_per_step(B: int, L: int, d: int = 768, layers: int = 12,
                         ffn: int = 3072, bow_dim: int = 23808,
                         ec_dim: int = 24) -> float:
    """Model FLOPs of one CAREL training step (backward = 2 x forward),
    the formula of the JAX package's bench: 3.197e12 at b64 x s96."""
    return 3.0 * (encoder_fwd_flops(B, L, d, layers, ffn)
                  + carel_heads_fwd_flops(B, d, ec_dim, 6, bow_dim))


def score_flops_per_batch(B: int, L: int, d: int = 768, layers: int = 12,
                          ffn: int = 3072, ec_dim: int = 24) -> float:
    """Model FLOPs of one scoring forward: the encoder and the heads that
    evaluation runs (no BoW decoder)."""
    return (encoder_fwd_flops(B, L, d, layers, ffn)
            + carel_heads_fwd_flops(B, d, ec_dim, 6, 0))


def mlm_flops_per_step(B: int, L: int, masked_rows: float, d: int = 768,
                       layers: int = 12, ffn: int = 3072,
                       vocab: int = 21128) -> float:
    """Model FLOPs of one MLM step: the encoder's forward and backward over
    every position, and the head (transform d x d and output d x V) over
    the masked positions only, which is all that the loss reads."""
    head = masked_rows * 2 * (d * d + d * vocab)
    return 3.0 * (encoder_fwd_flops(B, L, d, layers, ffn) + head)


def bound_ms(nbytes: float, flops: float,
             peak_flops: float = PEAK_FP32_FLOPS) -> float:
    """The least time in ms of a kernel that moves ``nbytes`` and computes
    ``flops``: the larger of the two at the card's peaks."""
    return max(nbytes / PEAK_BYTES, flops / peak_flops) * 1e3
