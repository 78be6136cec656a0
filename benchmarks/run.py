"""The benchmark of carel_tpu_torch on one H100: one run of one cell.

    python benchmarks/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Prints, as the last line of standard output, one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device``, with ``--trace 1``
``breakdown``, and last ``compared``: each number that decided
``correct`` beside its limit, which also end standard error. Exits with 2
and prints no result without a card (or with fewer than the cell asks
for), and with 3 if JAX or the JAX package is loaded in this process.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent

# every cache the card's libraries could write lives at a fixed path inside
# the checkout (the port's own nvcc build is build/carel_tpu_torch/)
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton"),
                 ("CUDA_CACHE_PATH", "cuda_cache")):
    os.environ[var] = str(ROOT / "build" / "bench_cache" / sub)
os.environ["USE_FLAX"] = "0"
# one process with few threads: the host's share of the run stays steady
# when the machine's other tenants load its cores
for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS"):
    os.environ[var] = "1"
sys.path[:0] = [str(HERE), str(ROOT)]


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    from harness.catalog import Catalog, load_benchmark
    from harness.runner import forbidden_loaded, run_cell

    catalog = Catalog()
    bench = load_benchmark(ROOT / "BENCHMARK.json")
    chips = catalog.workload(args.workload)["chips"]
    import torch

    t_torch = time.perf_counter() - T_START
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        seen = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"needs {chips} CUDA device(s); torch sees {seen}",
              file=sys.stderr)
        return 2
    result, lines = run_cell(args.workload, args.seed, args.seconds,
                             bool(args.trace), "cuda", catalog, bench,
                             T_START)
    loaded = forbidden_loaded()
    if loaded:
        print(f"loaded in this process: {loaded}", file=sys.stderr)
        return 3
    print(f"torch imported at {t_torch:.2f} s", file=sys.stderr)
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
