"""The program's own spans in the traced window.

``carel_tpu_torch.utils.profiling.spans()`` holds the spans the program
recorded while a torch profiler ran, which here is the traced window
alone. They are stamped with ``time.time_ns()``, the Unix clock in ns of
the profiler's own records, so ``time_ns / 1e3`` puts them on
``Trace.kernels``' clock (us) with no anchor; the card's records reach
that clock with an offset of up to ~20 us, so a span's edge may misplace
that much idle. A program without the recorder, or a run without a
trace, gives no spans, and every reading is then None.

A profiler session on the card has been seen to place the device's
records ~185 us off that clock and to lose most of them. Such a window
reads None too, with a note: one that lost guard records, or in which a
span that copies to the card (``COPY_SPANS``) does not hold the start of
each of its host-to-card copies' records within ``SLACK_US`` of its
edges.
"""

from __future__ import annotations

import bisect
from typing import Iterable, List, Optional, Tuple

Interval = Tuple[float, float]
# the spans that copy host memory to the card, each with its ``copies``
# count (one when it has none), and what the copies' records are named
COPY_SPANS = ("epoch_step.copy", "score_pairs.to_device")
HTOD = "HtoD"
SLACK_US = 20.0


def window_spans(run) -> Optional[List[Tuple[str, float, float]]]:
    """(name, start us, end us) of each program span that overlaps the
    traced window; None without a trace or without the recorder."""
    tr = run.trace
    if tr is None:
        return None
    try:
        from carel_tpu_torch.utils import profiling
    except ImportError:
        return None
    read = getattr(profiling, "spans", None)
    if read is None:
        return None
    lo, hi = tr.window
    mine = [s for s in read() if s.end_ns / 1e3 > lo and s.start_ns / 1e3 < hi]
    fault = unsound(tr, mine)
    if fault:
        notes = getattr(run, "notes", None)
        note = f"program spans not read: {fault}"
        if notes is not None and note not in notes:
            notes.append(note)
        return None
    return [(s.name, s.start_ns / 1e3, s.end_ns / 1e3) for s in mine]


def unsound(tr, spans) -> str:
    """Why the window's device records cannot be placed against the
    program's ``spans``, or "" when they can."""
    if tr.guards_lost:
        return f"the window lost {tr.guards_lost} guard records"
    lo, hi = tr.window
    starts = sorted(s for name, s, _ in tr.kernels if HTOD in name)
    for sp in spans:
        start, end = sp.start_ns / 1e3, sp.end_ns / 1e3
        if sp.name not in COPY_SPANS or start < lo or end > hi:
            continue
        want = sp.counts.get("copies", 1)
        held = bisect.bisect_right(starts, end + SLACK_US) - \
            bisect.bisect_left(starts, start - SLACK_US)
        if held < want:
            return (f"{sp.name} at {start:.1f} us holds {held} of its "
                    f"{want} host-to-card records within {SLACK_US:g} us")
    return ""


def _union(intervals: Iterable[Interval]) -> List[Interval]:
    merged: List[List[float]] = []
    for s, e in sorted(intervals):
        if e <= s:
            continue
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


def _overlap(a: List[Interval], b: List[Interval]) -> float:
    """us covered by both of two sorted lists of disjoint intervals."""
    i = j = 0
    total = 0.0
    while i < len(a) and j < len(b):
        s, e = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if e > s:
            total += e - s
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_inside(run, names) -> Optional[Tuple[float, float]]:
    """(device-idle us, us) of the union of the program spans named
    ``names``, each clipped to the traced window: the part of those spans
    in which no device record ran, and their length. None when no such
    span lies in the window."""
    spans = window_spans(run)
    if not spans:
        return None
    lo, hi = run.trace.window
    inside = _union((max(s, lo), min(e, hi)) for n, s, e in spans
                    if n in names)
    length = sum(e - s for s, e in inside)
    if length <= 0:
        return None
    return length - _overlap(inside, run.trace.busy_intervals()), length


def idle_pct(run, names) -> Optional[float]:
    """100 x the device-idle share of the spans named ``names``."""
    got = idle_inside(run, names)
    return None if got is None else 100.0 * got[0] / got[1]


def idle_ms_per(run, names, unit: str) -> Optional[float]:
    """Device-idle ms inside the spans named ``names``, over the traced
    window's ``unit`` (a key of its work: steps, requests)."""
    got = idle_inside(run, names)
    count = run.trace.work.get(unit) if run.trace is not None else None
    if got is None or not count:
        return None
    return got[0] / 1e3 / count
