"""Tiny cells for the CPU tests: a configuration, traffic and workloads
written into a temporary root that the catalog searches before
``benchmarks/``, and the BENCHMARK.json entries that name them."""

from __future__ import annotations

import copy
import json
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
for p in (str(BENCH), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)


def _load(kind: str, name: str) -> dict:
    return json.loads((BENCH / kind / f"{name}.json").read_text())


def tiny_config() -> dict:
    c = _load("configs", "chinese-roberta-wwm-ext")
    c.update(vocab_size=300, hidden_size=32, num_hidden_layers=2,
             num_attention_heads=4, intermediate_size=64,
             max_position_embeddings=64)
    c["tokens"] = {"pad": 0, "cls": 2, "sep": 3, "first_content": 5}
    c["carel"] = dict(c["carel"], ec_dim=8, bow_vocab=200)
    c["precision"] = {"encoder": "float32", "heads": "float32"}
    return c


def tiny_traffic() -> dict:
    return {
        "tiny_pairs": dict(_load("traffic", "flagship_b64_s96"), batch=8,
                           max_len=16, epoch_rows=32, len_min=6, len_max=16,
                           bow_slots=8, bow_terms_min=2, bow_terms_max=6),
        "tiny_score": dict(_load("traffic", "score_b512_s96"), batch=8,
                           max_len=16, file_requests=4, warmup_requests=1,
                           trace_requests=1, check_requests=2, len_min=6,
                           len_max=16, bow_slots=8, bow_terms_min=2,
                           bow_terms_max=6),
        "tiny_mlm": dict(_load("traffic", "mlm_b256_s64"), batch=8,
                         seq_len=16, corpus_rows=64, len_min=4, len_max=14,
                         scan_size=2, warmup_steps=2),
    }


CELLS = {"tiny_train": ("tiny_pairs", "train",
                        {"loss": 1e-4, "grad": 1e-4, "change": 1e-4}),
         "tiny_score": ("tiny_score", "score", {"prob": 1e-5}),
         "tiny_pretrain": ("tiny_mlm", "pretrain",
                           {"loss": 1e-4, "grad": 1e-4, "change": 1e-4})}


def write_root(tmp: Path, limits: dict = None) -> Path:
    """A root with the tiny configuration, traffic and cells; ``limits``
    replaces a cell's limits ({cell: {name: limit}})."""
    for kind in ("configs", "traffic", "workloads"):
        (tmp / kind).mkdir(parents=True, exist_ok=True)
    (tmp / "configs" / "tiny.json").write_text(json.dumps(tiny_config()))
    for name, t in tiny_traffic().items():
        (tmp / "traffic" / f"{name}.json").write_text(json.dumps(t))
    for cell, (traffic, driver, lim) in CELLS.items():
        wl = {"config": "tiny", "traffic": traffic, "driver": driver,
              "chips": 1, "why": "a CPU test",
              "limits": (limits or {}).get(cell, lim)}
        (tmp / "workloads" / f"{cell}.json").write_text(json.dumps(wl))
    return tmp


def tiny_bench() -> dict:
    """BENCHMARK.json with the tiny cells added to the metrics' lists."""
    bench = copy.deepcopy(json.loads((ROOT / "BENCHMARK.json").read_text()))
    adds = {"train": "tiny_train", "score": "tiny_score",
            "pretrain": "tiny_pretrain"}
    for m in bench["end_to_end"] + bench["per_layer"]:
        for kind, cell in adds.items():
            if "workloads" in m and any(
                    w.endswith(f"_{kind}") for w in m["workloads"]):
                m["workloads"].append(cell)
    return bench
