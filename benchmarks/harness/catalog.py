"""Where the benchmark finds its pieces, by the names in ``BENCHMARK.json``.

Each piece is a file of its own under one of the search roots (the
``benchmarks/`` directory, after any extra roots a caller gives):

- ``configs/<name>.json``: a model configuration;
- ``workloads/<cell>.json``: a cell's configuration, traffic, driver, chips,
  why and the limits of its comparison;
- ``traffic/<name>.json``: the parameters of a traffic mix, read by the one
  generator in ``harness/traffic.py``;
- ``drivers/<kind>.py``: the code that drives one kind of program entry;
- ``metrics/<metric>.py``: the reader of one metric;
- ``kernels/<op>.py``: an op's kernel-name patterns and least-work bound.

So a later change adds a cell, a configuration, a metric or an op as new
files and edits none.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import Iterable, List, Optional

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


class Catalog:
    """The search roots, extra ones first, then ``benchmarks/``."""

    def __init__(self, extra_roots: Iterable = ()):
        self.roots: List[Path] = [Path(r) for r in extra_roots] + [BENCH_DIR]
        self._modules: dict = {}

    def path(self, kind: str, name: str, suffix: str) -> Path:
        for root in self.roots:
            p = root / kind / f"{name}{suffix}"
            if p.is_file():
                return p
        raise FileNotFoundError(
            f"no {kind}/{name}{suffix} under {[str(r) for r in self.roots]}")

    def json(self, kind: str, name: str) -> dict:
        with open(self.path(kind, name, ".json")) as f:
            return json.load(f)

    def config(self, name: str) -> dict:
        return self.json("configs", name)

    def workload(self, name: str) -> dict:
        return self.json("workloads", name)

    def traffic(self, name: str) -> dict:
        return self.json("traffic", name)

    def module(self, kind: str, name: str):
        """The module of ``<kind>/<name>.py``, loaded once by its path (a
        metric's name holds dots, so it is not imported by name)."""
        path = self.path(kind, name, ".py")
        key = str(path)
        if key not in self._modules:
            spec = importlib.util.spec_from_file_location(
                f"bench_{kind}_{name.replace('.', '_').replace('-', '_')}",
                path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            self._modules[key] = mod
        return self._modules[key]

    def names(self, kind: str, suffix: str) -> List[str]:
        """Every name of ``kind`` over the roots, the first root's file
        winning."""
        seen: dict = {}
        for root in self.roots:
            d = root / kind
            if d.is_dir():
                for p in sorted(d.glob(f"*{suffix}")):
                    if not p.name.startswith("_"):
                        seen.setdefault(p.name[:-len(suffix)], p)
        return sorted(seen)


def load_benchmark(path: Optional[Path] = None) -> dict:
    """``BENCHMARK.json`` at the root of the checkout."""
    with open(path or ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def cell_metrics(bench: dict, cell: str):
    """(end-to-end metrics, per-layer metrics) that ``cell`` reports: an
    end-to-end metric with no ``workloads`` key belongs to every cell; a
    per-layer metric to the cells it lists, or without the key to every
    cell that reports the end-to-end metric it moves."""
    e2e = [m for m in bench["end_to_end"]
           if cell in m.get("workloads", [cell])]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if (cell in m["workloads"] if "workloads" in m
                 else m["moves"] in names)]
    return e2e, layer
