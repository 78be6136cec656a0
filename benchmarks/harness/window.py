"""The measured window: units run back to back, each ended by a value fetch,
until the first unit boundary at or after ``seconds``. Rates divide the
work the units completed by the time from the first unit's start to the
last one's end; latencies are the units' own durations."""

from __future__ import annotations

import time
import traceback
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Tuple


@dataclass
class Window:
    seconds: float = 0.0
    units: int = 0
    failed: int = 0
    work: Dict[str, float] = field(default_factory=dict)
    latencies: List[float] = field(default_factory=list)
    spans: List[Tuple[str, float, float]] = field(default_factory=list)
    start: float = 0.0
    error: str = ""

    def span_seconds(self, name: str) -> float:
        return sum(e - s for n, s, e in self.spans if n == name)


def run_window(unit: Callable[[list], Dict[str, float]],
               seconds: float) -> Window:
    """Run ``unit(spans)`` until ``seconds`` have passed at a unit's end.
    A unit that raises counts as failed, ends the window and keeps its
    traceback in ``error``."""
    w = Window()
    w.start = time.perf_counter()
    end = w.start
    while end - w.start < seconds:
        t0 = time.perf_counter()
        try:
            done = unit(w.spans)
        except Exception:
            w.failed += 1
            w.units += 1
            w.error = traceback.format_exc()
            end = time.perf_counter()
            break
        end = time.perf_counter()
        w.units += 1
        w.latencies.append(end - t0)
        for k, v in done.items():
            w.work[k] = w.work.get(k, 0.0) + v
    w.seconds = end - w.start
    return w
