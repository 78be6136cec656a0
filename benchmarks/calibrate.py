"""The readings that a cell's limits are set from, in one process on the
card: for each seed the program's first steps (and for a scoring cell a
short window) against the fp32 reference; for the control seeds also the
control (the reference with float8 encoder products in the program's
place), the reference with bf16 encoder products, the reference with the
products that run in fp32 (heads, MMD, BoW decoder, MLM head) at TF32 and
at bf16, and for a training cell the fault of half a batch left out. A
training cell's record also holds the worst gap over those fp32 parts'
own leaves, and every leaf's norms (the reference's, the program's and
each reading's). One JSON line a seed. The benchmark's own runs never run
this.

    python benchmarks/calibrate.py --workload zh_train --seeds 1 2 3 \
        --control 1 2 3 [--seconds 2] [--out FILE]
"""

import argparse
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent)]


# the leaves of the parts that the configuration runs in fp32
HEAD_LEAVES = ("heads.", "mlm_")

# (record, encoder numerics, half the batch, head numerics)
READINGS = (("control_fp8", "fp8", False, "fp32"),
            ("bf16_products", "bf16", False, "fp32"),
            ("head_tf32", "fp32", False, "tf32"),
            ("head_bf16", "fp32", False, "bf16"),
            ("half_batch", "fp32", True, "fp32"))


def leaf_detail(program: dict, reference: dict) -> dict:
    """The worst leaf of each leaf-wise number, and the worst gap over
    the fp32 parts' leaves, for the record."""
    from harness import compare

    if "grad" not in reference:
        return {}
    out = {}
    moving = compare.moving_leaves(reference["grad"])
    for name, keep in (("grad", list(reference["grad"])),
                       ("change", moving)):
        gap, leaf = compare.leaf_gap(program[name], reference[name], keep)
        gaps = compare.leaf_gaps(program[name], reference[name], keep)
        head = {n: v for n, v in gaps.items() if n.startswith(HEAD_LEAVES)}
        out[name + "_leaf"] = leaf
        if head:
            worst = max(head, key=head.get)
            out[name + "_head"] = head[worst]
            out[name + "_head_leaf"] = worst
    return out


def calibrate(cell: str, seeds, control, seconds: float, device,
              catalog=None, out=None):
    import torch

    from harness.catalog import Catalog
    from harness.window import run_window

    catalog = catalog or Catalog()
    wl = catalog.workload(cell)
    c, t = catalog.config(wl["config"]), catalog.traffic(wl["traffic"])
    Driver = catalog.module("drivers", wl["driver"]).Driver
    records = []
    for seed in seeds:
        t0 = time.perf_counter()
        drv = Driver(c, t, seed, device)
        drv.setup()
        if seconds:
            run_window(drv.unit, seconds)
        t1 = time.perf_counter()
        drv.release()
        ref = drv.reference("fp32")
        t2 = time.perf_counter()
        rec = {"cell": cell, "seed": seed, "setup_and_window_s": t1 - t0,
               "reference_s": t2 - t1,
               "program": drv.numbers(ref)}
        program = getattr(drv, "program", None)
        if program:
            rec["program_leaves"] = leaf_detail(program, ref)
            rec["norms"] = {"reference": ref, "program": program}
        if seed in control:
            for name, mode, half, head in READINGS:
                if half and wl["driver"] == "score":
                    continue
                other = drv.reference(mode, half, head)
                rec[name] = drv.numbers(ref, other)
                if isinstance(other, dict) and "grad" in other:
                    rec[name + "_leaves"] = leaf_detail(other, ref)
                    rec["norms"][name] = other
        if device != "cpu":
            rec["peak_bytes"] = torch.cuda.max_memory_allocated()
        records.append(rec)
        line = json.dumps(rec)
        print(line, flush=True)
        if out:
            with open(out, "a") as f:
                f.write(line + "\n")
    return records


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control", type=int, nargs="*", default=[])
    p.add_argument("--seconds", type=float, default=0.0)
    p.add_argument("--out", default="")
    args = p.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    calibrate(args.workload, args.seeds, set(args.control), args.seconds,
              "cuda", out=args.out or None)
    return 0


if __name__ == "__main__":
    sys.exit(main())
