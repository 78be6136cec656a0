"""Profiling helpers, port of carel_tpu/utils/profiling.py: a torch.profiler
trace, the program's spans, and a step-time meter.

The reference's only instrumentation is wall-clock minutes and a running loss
print (flagship :846-851, :990); here a trace of the base training is one
flag away (``--profile_dir``), plus a cheap streaming step timer for
throughput accounting.

Spans (``span``) name the host work of the program's layers: the epoch
step's pack, copy, capture and replays, the scorer's batches, the MLM
dispatch's replays, the evaluation. They record only while a torch
profiler runs on the calling thread
(``torch.autograd._profiler_enabled()``), so the operator's
``--profile_dir`` trace and any other profiled window get them, and every
other run pays one check a span. They are stamped with
``time.time_ns()``, the Unix clock in ns that torch.profiler stamps its own
records with, so a span lines up with the kernels it launched with no
anchor. Spans wrap host code only, never code inside a graph capture.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import re
import threading
import time
from typing import List, NamedTuple, Optional

import numpy as np
import torch


class Span(NamedTuple):
    """One recorded span: its ``name``, ``start_ns`` and ``end_ns`` on the
    Unix clock, its ``id``, the ``parent`` span's id (the innermost span
    open on the same thread; None at top level, so the children of one
    call carry the id of its top-level span), the ``thread`` and the
    ``counts`` given to ``span``."""

    name: str
    start_ns: int
    end_ns: int
    id: int
    parent: Optional[int]
    thread: int
    counts: dict


_SPANS: List[Span] = []
_IDS = itertools.count(1)
_OPEN = threading.local()  # .stack: ids of the spans open on this thread
_OFF = contextlib.nullcontext()
# the Chrome trace row that ``trace`` writes the spans into
SPAN_ROW = "program spans"


class _Recording:
    __slots__ = ("name", "counts", "id", "parent", "start")

    def __init__(self, name: str, counts: dict):
        self.name, self.counts = name, counts

    def __enter__(self):
        stack = _OPEN.__dict__.setdefault("stack", [])
        self.parent = stack[-1] if stack else None
        self.id = next(_IDS)
        stack.append(self.id)
        self.start = time.time_ns()
        return self

    def __exit__(self, *exc):
        end = time.time_ns()
        _OPEN.stack.pop()
        _SPANS.append(Span(self.name, self.start, end, self.id, self.parent,
                           threading.get_ident(), self.counts))
        return False


def span(name: str, **counts):
    """A context manager that records the enclosed host work as a span
    named ``name`` with ``counts`` while a torch profiler runs on this
    thread, and does nothing otherwise."""
    if not torch.autograd._profiler_enabled():
        return _OFF
    return _Recording(name, counts)


def spans() -> List[Span]:
    """The spans recorded since the last ``reset_spans``, in the order they
    ended."""
    return list(_SPANS)


def reset_spans() -> None:
    _SPANS.clear()


# how much of a Chrome trace's head and tail ``_write_spans`` reads
_EDGE = 1 << 16


def _write_spans(path: str, records: List[Span]) -> None:
    """Add ``records`` to the Chrome trace at ``path`` as a row of their
    own, on the file's time base (us since ``baseTimeNanoseconds``). The
    file is not parsed, so a trace of any size costs the same: the events
    go in before the ``]`` that closes ``traceEvents``, the file's last
    list, which kineto follows with only its ``"traceName"`` and the
    closing brace. A tail of another form gets the row as a file of its
    own beside the trace, ``<path>.spans.json``."""
    with open(path, "rb") as f:
        head = f.read(_EDGE)
        size = f.seek(0, os.SEEK_END)
        at = max(0, size - _EDGE)
        f.seek(at)
        tail = f.read()
    found = re.search(rb'"baseTimeNanoseconds"\s*:\s*(\d+)', head)
    base = int(found.group(1)) if found else 0
    events = [{"ph": "M", "name": "process_name", "pid": SPAN_ROW,
               "tid": 0, "args": {"name": SPAN_ROW}}]
    for s in records:
        events.append({
            "ph": "X", "cat": "program_span", "name": s.name,
            "pid": SPAN_ROW, "tid": 0, "ts": (s.start_ns - base) / 1e3,
            "dur": (s.end_ns - s.start_ns) / 1e3,
            "args": {"id": s.id, "parent": s.parent, "thread": s.thread,
                     **s.counts}})
    text = ",\n".join(json.dumps(e) for e in events).encode()
    close = re.search(rb'\]\s*,\s*"traceName"\s*:\s*"[^"]*"\s*\}\s*$', tail)
    if close is None:
        with open(path + ".spans.json", "w") as f:
            json.dump({"traceEvents": events}, f)
        return
    end = at + close.start()
    opened = tail[:close.start()].rstrip().endswith(b"[")
    with open(path, "r+b") as f:
        f.seek(end)
        f.write((b"" if opened else b",\n") + text + tail[close.start():])


@contextlib.contextmanager
def trace(profile_dir: str):
    """torch.profiler trace of the enclosed work (host, and the card's
    kernels where there is one), written into ``profile_dir`` as a Chrome
    trace, ``trace_<time>_<pid>.json``, with the program's spans of the
    work in a row of their own (``SPAN_ROW``); a no-op when
    ``profile_dir`` is empty."""
    if not profile_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(profile_dir, exist_ok=True)
    reset_spans()
    with profile(activities=activities) as prof:
        yield
    name = f"trace_{time.strftime('%Y%m%d-%H%M%S')}_{os.getpid()}.json"
    path = os.path.join(profile_dir, name)
    prof.export_chrome_trace(path)
    _write_spans(path, spans())


class StepTimer:
    """Streaming step timer (keeps the last ``window`` steps); time only
    work that ends in a value fetch or a synchronize."""

    def __init__(self, window: int = 200):
        self.window = window
        self.times: list = []
        self._t0: Optional[float] = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.times.append(time.perf_counter() - self._t0)
        if len(self.times) > self.window:
            self.times.pop(0)

    def summary(self) -> dict:
        if not self.times:
            return {}
        arr = np.asarray(self.times)
        return {
            "steps": len(arr),
            "mean_ms": float(arr.mean() * 1e3),
            "p50_ms": float(np.percentile(arr, 50) * 1e3),
            "p95_ms": float(np.percentile(arr, 95) * 1e3),
        }
