"""One run of one cell: set-up, the measured window, the traced window
(``--trace 1``), the peak memory, the program freed, the reference, the
comparison, and the metrics read by name."""

from __future__ import annotations

import sys
import time
from dataclasses import dataclass, field
from typing import List, Optional

from harness.catalog import Catalog, cell_metrics
from harness.compare import verdict
from harness.trace import Trace, traced_window
from harness.window import Window, run_window

# top-level modules that must not be loaded in the process that prints a
# result: JAX, its libraries and the JAX package the port was made from
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "carel_tpu")


def forbidden_loaded(modules=None) -> List[str]:
    """The forbidden top-level names among ``modules`` (``sys.modules``),
    compared whole: carel_tpu_torch is not carel_tpu."""
    tops = {name.split(".")[0] for name in (modules or sys.modules)}
    return sorted(tops & set(FORBIDDEN))


@dataclass
class Run:
    """What the metric readers read: the cell, the catalog, the driver,
    the set-up time, the measured window and the traced one."""

    cell: str
    catalog: Catalog
    driver: object
    setup_s: float = 0.0
    window: Optional[Window] = None
    trace: Optional[Trace] = None
    notes: List[str] = field(default_factory=list)


def card_state() -> str:
    """The card's name, power limit, SM clock, temperature and power draw
    as nvidia-smi reads them (for the record beside the numbers)."""
    import subprocess

    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,"
             "temperature.gpu,power.draw", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e}"


def unit_summary(lat: list) -> str:
    """Min, median, max of the units' seconds, and the mean of the first
    and the last third, which shows a drift within the window."""
    if not lat:
        return "none"
    s = sorted(lat)
    third = max(1, len(lat) // 3)
    first, last = lat[:third], lat[-third:]
    return (f"n {len(lat)} min {s[0]:.4f} median {s[len(s) // 2]:.4f} "
            f"max {s[-1]:.4f}; first third {sum(first) / len(first):.4f} "
            f"last third {sum(last) / len(last):.4f}")


def span_summary(w: Window) -> str:
    """The median seconds a unit of each host span of the window."""
    by: dict = {}
    for name, s, e in w.spans:
        by.setdefault(name, []).append(e - s)
    return ", ".join(f"{n} {sorted(v)[len(v) // 2]:.4f}"
                     for n, v in by.items())


def read_metrics(run: Run, metrics: list) -> dict:
    out = {}
    for m in metrics:
        value = run.catalog.module("metrics", m["name"]).read(run)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def run_cell(cell: str, seed: int, seconds: float, trace: bool, device,
             catalog: Catalog, bench: dict, t_start: float):
    """(the result's object, the lines for standard error). ``t_start`` is
    the process's start on the perf_counter clock."""
    import torch

    wl = catalog.workload(cell)
    config = catalog.config(wl["config"])
    traffic = catalog.traffic(wl["traffic"])
    e2e, layer = cell_metrics(bench, cell)
    cuda = torch.device(device).type == "cuda"
    drv = catalog.module("drivers", wl["driver"]).Driver(config, traffic,
                                                        seed, device)
    run = Run(cell, catalog, drv)
    made = time.perf_counter()
    drv.setup()
    run.window = run_window(drv.unit, seconds)
    run.setup_s = run.window.start - t_start
    failed = run.window.failed
    attempted = run.window.units
    if trace and not failed:
        def traced(spans):
            work: dict = {}
            for _ in range(drv.trace_units):
                for k, v in drv.unit(spans).items():
                    work[k] = work.get(k, 0.0) + v
            return drv.trace_units, work

        if cuda:
            run.trace = traced_window(traced)
            attempted += run.trace.units
            run.notes += run.trace.notes
    card = card_state() if cuda else ""
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    counters = drv.counters()
    drv.release()

    marks = getattr(drv, "phases", [])
    lines = [f"counters {counters}", f"window {run.window.units} units in "
             f"{run.window.seconds:.3f} s, set-up {run.setup_s:.3f} s",
             "set-up phases (s since the process started): driver made "
             f"{made - t_start:.2f}, " + ", ".join(
                 f"{name} {t - t_start:.2f}" for name, t in marks),
             "unit seconds: " + unit_summary(run.window.latencies),
             "host spans, median s a unit: " + span_summary(run.window),
             f"card after the window: {card}"]
    if run.window.error:
        lines.append(run.window.error)
        compared = {}
        correct = False
    else:
        numbers = drv.numbers(drv.reference("fp32"))
        correct, compared = verdict(numbers, wl["limits"])
        lines += [f"read {k} {v:.6e} (no limit: not compared)"
                  for k, v in numbers.items() if k not in compared]
    metrics = read_metrics(run, layer if trace else e2e)
    lines += run.notes
    result = {"correct": bool(correct), "attempted": attempted,
              "failed": failed, "metrics": metrics}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name() if cuda else "cpu",
           "count": wl["chips"], "memory_peak_bytes": int(peak)}
    if run.trace is not None:
        dev["busy_s"] = run.trace.busy_s
        dev["window_s"] = run.trace.window_s
        result["breakdown"] = {"device_ops": run.trace.top_ops(),
                               "idle_gaps": run.trace.idle_gaps()}
        lines.append("device s of the traced window by class: " + ", ".join(
            f"{k} {v:.4f}" for k, v in run.trace.by_class().items()))
        lines.append(f"trace: {run.trace.units} units, "
                     f"{len(run.trace.kernels)} device records, "
                     f"{run.trace.guards_lost} guard records lost")
    result["device"] = dev
    result["compared"] = compared
    # the numbers compared come last, on standard error too
    lines += [f"compared {k} {c['value']:.6e} limit {c['limit']:.6e}"
              for k, c in compared.items()]
    lines.append(f"correct {correct}")
    return result, lines
