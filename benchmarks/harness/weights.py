"""Random weights from the seed, made on the device in one draw.

``make_weights`` takes a list of (name, shape) and returns {name: fp32
tensor} from one ``torch.randn`` on a generator of the device: a matrix
[out, in] (a Linear's weight, an embedding table [rows, width]) scaled by
1/sqrt(its second dimension), a LayerNorm's weight 1 + 0.02 N, every other
vector (biases) 0.02 N. The program and the reference are handed the same
tensors, so both start from the same point.
"""

from __future__ import annotations

import math
from typing import Dict, Sequence, Tuple

import torch

# the seed's streams of weights, kept apart from the traffic's
WEIGHT_STREAM = 11


def weight_seed(seed: int, stream: int = WEIGHT_STREAM) -> int:
    """A 63-bit torch seed from any whole-number seed and a stream."""
    return (int(seed) * 1_000_003 + stream * 7919) % ((1 << 63) - 1)


def is_norm_weight(name: str) -> bool:
    return name.endswith("ln.weight")


@torch.no_grad()
def make_weights(spec: Sequence[Tuple[str, Tuple[int, ...]]], seed: int,
                 device, stream: int = WEIGHT_STREAM
                 ) -> Dict[str, torch.Tensor]:
    total = sum(math.prod(shape) for _, shape in spec)
    gen = torch.Generator(device=device).manual_seed(
        weight_seed(seed, stream))
    flat = torch.randn(total, generator=gen, device=device,
                       dtype=torch.float32)
    out, at = {}, 0
    for name, shape in spec:
        n = math.prod(shape)
        w = flat[at:at + n].view(shape)
        at += n
        if len(shape) >= 2:
            w.mul_(1.0 / math.sqrt(shape[1]))
        elif is_norm_weight(name):
            w.mul_(0.02).add_(1.0)
        else:
            w.mul_(0.02)
        out[name] = w
    return out
