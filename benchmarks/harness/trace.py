"""The profiler's reading of a short traced window (``--trace 1``).

The window runs a few of the cell's units under ``torch.profiler`` with
the CUDA activity only, and keeps the device records in memory: no trace
file is written. It opens and closes with ``GUARD_KERNELS`` spin kernels
(``torch.cuda._sleep``), each side followed by a synchronize: the profiler
has been seen to lose the first records of a window, and a record lost at
an edge is then a guard's, not the work's. The traced window runs from the
end of the last opening guard to the start of the first closing guard;
the host's work before the first unit's first kernel is inside it.

The benchmark's host spans (perf_counter) are put on the device's clock by
the end of the opening guards, which the synchronize after them marks on
the host: close enough to name an idle gap of a millisecond by what the
host was doing.
"""

from __future__ import annotations

import re
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Tuple

GUARD_KERNELS = 200
GUARD_CYCLES = 100_000  # ~50 us each at 1.98 GHz
GUARD_NAME = "spin_kernel"
# kernel classes of the standard-error summary of a traced window
CLASSES = (("gemm", r"nvjet|gemm|xmma|cutlass|sm90_"),
           ("copy and cast", r"copy_kernel|CatArrayBatchedCopy"),
           ("adam", r"Adam"),
           ("layer norm", r"layer_norm|LayerNorm|GammaBeta"),
           ("softmax", r"softmax"),
           ("reduce", r"reduce_kernel"),
           ("hand-written (K1-K10)", r"mmd_|bow_|emb_bwd|hsic_|flash_"),
           ("memcpy", r"[Mm]emcpy|[Mm]emset"))


@dataclass
class Trace:
    """Device records of the traced window, times in us on the device's
    clock: ``kernels`` (name, start, end) of the work, ``window`` (start,
    end), the host ``spans`` (name, start, end) on the same clock, the
    units run and the work they did."""

    kernels: List[Tuple[str, float, float]]
    window: Tuple[float, float]
    spans: List[Tuple[str, float, float]]
    units: int
    work: Dict[str, float]
    guards_lost: int = 0
    notes: List[str] = field(default_factory=list)

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e6

    def busy_intervals(self) -> List[Tuple[float, float]]:
        lo, hi = self.window
        merged: List[List[float]] = []
        for _, s, e in sorted(self.kernels, key=lambda k: k[1]):
            s, e = max(s, lo), min(e, hi)
            if e <= s:
                continue
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return [(s, e) for s, e in merged]

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) / 1e6

    def kernel_us(self, patterns) -> Tuple[float, int]:
        """(device us, records) of the kernels whose name matches any of
        ``patterns`` (regular expressions)."""
        rx = [re.compile(p) for p in patterns]
        us, n = 0.0, 0
        for name, s, e in self.kernels:
            if any(r.search(name) for r in rx):
                us += e - s
                n += 1
        return us, n

    def top_ops(self, k: int = 10) -> List[list]:
        """The ``k`` device operations that took the most time: [label,
        seconds]."""
        by: Dict[str, float] = {}
        for name, s, e in self.kernels:
            label = kernel_label(name)
            by[label] = by.get(label, 0.0) + (e - s) / 1e6
        return [[n, t] for n, t in sorted(by.items(),
                                          key=lambda kv: -kv[1])[:k]]

    def idle_gaps(self, k: int = 10) -> List[list]:
        """The ``k`` longest idle stretches of the window: [what the host
        was doing, seconds]."""
        lo, hi = self.window
        busy = self.busy_intervals()
        edges = [lo] + [x for iv in busy for x in iv] + [hi]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        gaps.sort(key=lambda g: g[0] - g[1])
        return [[self.host_at((s + e) / 2), (e - s) / 1e6]
                for s, e in gaps[:k]]

    def by_class(self) -> Dict[str, float]:
        """Device seconds of the window by kernel class (``CLASSES``, the
        first that matches; the rest under "other")."""
        out: Dict[str, float] = {}
        for name, s, e in self.kernels:
            label = next((c for c, rx in CLASSES if re.search(rx, name)),
                         "other")
            out[label] = out.get(label, 0.0) + (e - s) / 1e6
        return dict(sorted(out.items(), key=lambda kv: -kv[1]))

    def host_at(self, t: float) -> str:
        for name, s, e in self.spans:
            if s <= t <= e:
                return name
        return "between units"


def kernel_label(name: str) -> str:
    """A device kernel's name without namespaces and return type, cut to
    90 characters."""
    for noise in ("void ", "(anonymous namespace)::", "at::native::",
                  "at_cuda_detail::cub::", "at_cuda_detail::"):
        name = name.replace(noise, "")
    return name[:90]


def _guard():
    import torch

    for _ in range(GUARD_KERNELS):
        torch.cuda._sleep(GUARD_CYCLES)
    torch.cuda.synchronize()


def traced_window(run_units: Callable[[list], Tuple[int, Dict[str, float]]]
                  ) -> Trace:
    """Profile ``run_units(spans)``, which runs the units, appends its
    host spans (name, perf_counter start, end) to ``spans`` and returns
    (units, work); it ends with the units' last value fetch."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    spans: list = []
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _guard()
        h0 = time.perf_counter()
        units, work = run_units(spans)
        torch.cuda.synchronize()
        _guard()
    records = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CUDA or (
                hasattr(e, "is_user_annotation") and e.is_user_annotation()):
            continue
        if hasattr(e, "start_ns"):
            start, dur = e.start_ns() / 1e3, e.duration_ns() / 1e3
        else:
            start, dur = e.start_us(), e.duration_us()
        records.append((e.name(), start, start + dur))
    work_recs = [r for r in records if GUARD_NAME not in r[0]]
    guards = [r for r in records if GUARD_NAME in r[0]]
    notes = []
    if not work_recs:
        raise RuntimeError("the profiler recorded no device work in the "
                           "traced window")
    first = min(r[1] for r in work_recs)
    last = max(r[2] for r in work_recs)
    opening = [r[2] for r in guards if r[1] < first]
    closing = [r[1] for r in guards if r[1] >= last]
    lo = max(opening) if opening else first
    hi = min(closing) if closing else last
    if not opening or not closing:
        notes.append("a side of the window lost all its guards' records; "
                     "that edge is the first or last work record")
    lost = 2 * GUARD_KERNELS - len(guards)
    host = [(name, lo + (s - h0) * 1e6, lo + (e - h0) * 1e6)
            for name, s, e in spans]
    return Trace(work_recs, (lo, hi), host, units, work, lost, notes)
