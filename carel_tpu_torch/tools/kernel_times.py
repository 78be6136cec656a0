"""Time the wrappers of the small kernels K1-K6 of a checkout on the card.

    python3 <root>/carel_tpu_torch/tools/kernel_times.py --root <root>
        [--out FILE]

``--root`` names the checkout whose ``carel_tpu_torch`` package is built and
timed (default: the one this file lies in), so that two commits are compared
in one run on one card: unpack the other commit with ``git archive`` into a
directory that ``.gitignore`` lists, and run each checkout's own copy of
this file with its own root, in turns (other, this, this, other): the
wrappers' signatures differ between commits (K2 takes K1's residuals since
they were redesigned), and each copy calls its own. Run it as a file, not
with ``-m``, so that the package comes from ``--root``.

Per kernel, at the shapes of the training step (B = 64; d = 24 for MMD and
HSIC; D = 48 and V = 23,808 for the fused BoW loss): the median of 30 calls
by CUDA events around the wrapper's Python call, the profiler's device time
per call with the number of device kernels one call launches, and the host's
cost of one call that is not waited for. The timing functions and the inputs
are those of this checkout's ``chip_smoke.py``. The row ``floor`` is a
one-element ``fill_``: the least device time of any launch on this card, the
yardstick of the kernels that are bound by launch latency (K1, K2, K5, K6).
Needs a GPU and nvcc; prints the card's name and power limit, one line per
kernel and a JSON object last.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parents[2]


def load_chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  HERE / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def kernel_calls(cs) -> dict:
    """{kernel: a call of its wrapper at the training shape}."""
    from carel_tpu_torch.ops import cuda_bow as cb
    from carel_tpu_torch.ops import cuda_pairwise as cp

    alphas = (0.1,)
    one = torch.ones((), device="cuda")
    cell = torch.zeros(1, device="cuda")
    x, y, mask = cs.mmd_inputs(64, 0)
    _, mres = cp.mmd_forward_kernel(x, y, mask, alphas)
    hx, hy, hmask = cs.hsic_inputs(64, 0, cs.HSIC_SPREAD)
    _, res = cp.hsic_forward_kernel(hx, hy, hmask, 1.0, 1.0)
    h, W, b, _, _, bmask = cs.bow_inputs()
    rowp = cs.bow_rowp(cb.bow_forward_kernel(h, W, b), bmask, W.shape[0])
    return {
        "floor": lambda: cell.fill_(1.0),
        "mmd_fwd": lambda: cp.mmd_forward_kernel(x, y, mask, alphas),
        "mmd_bwd": lambda: cp.mmd_backward_kernel(x, y, mask, mres, one,
                                                  alphas),
        "bow_fwd": lambda: cb.bow_forward_kernel(h, W, b),
        "bow_bwd": lambda: cb.bow_backward_kernel(h, W, b, rowp),
        "hsic_fwd": lambda: cp.hsic_forward_kernel(hx, hy, hmask, 1.0, 1.0),
        "hsic_bwd": lambda: cp.hsic_backward_kernel(hx, hy, hmask, 1.0, 1.0,
                                                    res, one),
    }


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--root", default=str(HERE),
                        help="checkout whose carel_tpu_torch is timed")
    parser.add_argument("--out", default=None, help="also write the JSON here")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("needs a GPU", file=sys.stderr)
        return 1
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    cs = load_chip_smoke()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)
    import carel_tpu_torch

    if Path(carel_tpu_torch.__file__).resolve().parents[1] != root:
        print(f"carel_tpu_torch came from {carel_tpu_torch.__file__}, not "
              f"from {root}", file=sys.stderr)
        return 1
    rows = {}
    for name, call in kernel_calls(cs).items():
        device_ms, kernels = cs.device_profile(call)
        rows[name] = {"ms": cs.median_ms(call), "device_ms": device_ms,
                      "kernels_per_call": kernels,
                      "host_launch_ms": cs.host_launch_ms(call)}
        print(f"{name}: by events {rows[name]['ms']:.4f} ms, device "
              f"{device_ms:.4f} ms in {kernels:g} kernels a call, host "
              f"{rows[name]['host_launch_ms']:.4f} ms a call", flush=True)
    result = {"card": smi, "root": str(root), "kernels": rows}
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(result, indent=1))
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
