"""The numbers that decide ``correct``, each held against its limit.

Training: each step's loss, the first gradient's norm and the norm of the
parameters' change after three steps, the last two taken leaf by leaf: the
gap between the program's norm of a leaf and the reference's, over the
reference's norm of that leaf or of the median leaf, whichever is larger,
the worst leaf counting. Leaves whose reference gradient is under a
thousandth of the median leaf's move by round-off alone and are left out
of the change. The worst leaf of the encoder's gradient is read apart:
the heads' small leaves (a 48-element classifier) carry the widest gaps
of bf16 rounding on some seeds, and the encoder's leaves are where a
lower precision of the encoder shows. Scoring: the widest gap between a served probability and
the reference's.
"""

from __future__ import annotations

import math
import statistics
from typing import Dict, Iterable, Optional, Tuple

# a leaf whose reference gradient norm is under this share of the median
# leaf's is left out of the change
STILL_LEAF = 1e-3

# the prefix of the encoder's leaves
ENCODER = "encoder."


def loss_gap(program: Iterable[float], reference: Iterable[float]) -> float:
    """The widest relative gap of the steps' losses."""
    return max(abs(p - r) / abs(r) for p, r in zip(program, reference))


def leaf_gaps(program: Dict[str, float], reference: Dict[str, float],
              keep: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """{leaf: gap of norms}; a leaf the program lacks reads inf."""
    names = list(keep if keep is not None else reference)
    med = statistics.median(reference[n] for n in names)
    return {n: (abs(program[n] - reference[n]) / max(reference[n], med)
                if n in program else math.inf) for n in names}


def leaf_gap(program: Dict[str, float], reference: Dict[str, float],
             keep: Optional[Iterable[str]] = None) -> Tuple[float, str]:
    """(the worst leaf's gap of norms, that leaf's name)."""
    gaps = leaf_gaps(program, reference, keep)
    which = max(gaps, key=lambda n: (not math.isfinite(gaps[n]), gaps[n]))
    return gaps[which], which


def moving_leaves(ref_grad: Dict[str, float]):
    """The leaves whose reference gradient is not nought to rounding."""
    med = statistics.median(ref_grad.values())
    return [n for n, v in ref_grad.items() if v >= STILL_LEAF * med]


def _median(gaps: Dict[str, float]) -> float:
    return statistics.median(gaps.values())


def training_numbers(program: dict, reference: dict) -> Dict[str, float]:
    """The numbers of a training comparison; ``program`` and ``reference``
    hold ``losses`` (three steps), ``grad`` and ``change`` ({leaf: norm}):
    ``loss`` the widest relative gap of the steps' losses, ``grad`` and
    ``change`` the worst leaf's gap, ``grad_encoder`` the worst encoder
    leaf's, ``grad_median`` and ``change_median`` the median leaf's
    (steadier from seed to seed than the worst)."""
    grad = leaf_gaps(program["grad"], reference["grad"])
    change = leaf_gaps(program["change"], reference["change"],
                       moving_leaves(reference["grad"]))
    encoder = [v for n, v in grad.items() if n.startswith(ENCODER)]
    return {"loss": loss_gap(program["losses"], reference["losses"]),
            "grad": max(grad.values()), "change": max(change.values()),
            "grad_encoder": max(encoder) if encoder else math.inf,
            "grad_median": _median(grad), "change_median": _median(change)}


def verdict(numbers: Dict[str, float], limits: Dict[str, float]):
    """(correct, {name: {"value", "limit"}}) for the numbers that have a
    limit; a number that is not finite fails."""
    compared = {k: {"value": float(numbers[k]), "limit": float(limits[k])}
                for k in limits}
    ok = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
             for c in compared.values())
    return ok, compared
