"""Time the wrappers of the kernels K1-K6 and K10 of a checkout on the card.

    python3 <this file> --root <root> [--only NAME ...] [--out FILE]

``--root`` names the checkout whose ``carel_tpu_torch`` package is built and
timed (default: the one this file lies in), so that two commits are compared
in one run on one card: unpack the other commit with ``git archive`` into a
directory that ``.gitignore`` lists, and run the newer checkout's copy of
this file once with each root, in turns (other, this, this, other). The
rows call the wrappers of the checkout under ``--root``: K2 takes K1's
residuals since they were redesigned, and K10 is one call for the three
tables where the checkout has ``embeddings_backward_kernel``, else the
per-table ``embedding_backward_kernel`` three times. Run it as a file, not
with ``-m``, so that the package comes from ``--root``. ``--only`` keeps the
rows whose name starts with one of the names given.

Per kernel, at the shapes of the training step (B = 64; d = 24 for MMD and
HSIC; D = 48 and V = 23,808 for the fused BoW loss): the median of 30 calls
by CUDA events around the wrapper's Python call, the profiler's device time
per call with the number of device kernels one call launches, and the host's
cost of one call that is not waited for. The timing functions and the inputs
are those of this file's ``chip_smoke.py``. The row ``floor`` is a
one-element ``fill_``: the least device time of any launch on this card, the
yardstick of the kernels that are bound by launch latency (K1, K2, K5, K6).
K10 (rows ``emb_bwd ...``) runs the backward of the encoder's word,
position and token-type tables at four batches (``EMB_BATCHES``: the zh
step at 64 x 96, en over roberta-base's tables at 64 x 128, pretraining at
256 x 64, stage 1 at 300 x 60), on ``chip_smoke.emb_batch``'s ids and g
from one seed, and adds the device time of each device kernel a call (by name), the bound
(ids and g read once, every row of the three dWs written once, at 3.35
TB/s) and a sha256 of the three dWs' bytes, which two checkouts that add in
the same order share. Needs a GPU and nvcc; prints the card's name and power
limit, one line per row and a JSON object last.
"""

from __future__ import annotations

import argparse
import hashlib
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
    h, W, b, bidx, _, bmask = cs.bow_inputs()
    rowp = cs.bow_rowp(cb.bow_forward_kernel(h, W, b), bmask, W.shape[0])
    safe, corr = cs.bow_corrections(bidx)
    return {
        "floor": lambda: cell.fill_(1.0),
        "mmd_fwd": lambda: cp.mmd_forward_kernel(x, y, mask, alphas),
        "mmd_bwd": lambda: cp.mmd_backward_kernel(x, y, mask, mres, one,
                                                  alphas),
        "bow_fwd": lambda: cb.bow_forward_kernel(h, W, b),
        "bow_bwd": lambda: cb.bow_backward_kernel(h, W, b, rowp, safe,
                                                  corr),
        "hsic_fwd": lambda: cp.hsic_forward_kernel(hx, hy, hmask, 1.0, 1.0),
        "hsic_bwd": lambda: cp.hsic_backward_kernel(hx, hy, hmask, 1.0, 1.0,
                                                    res, one),
    }


# K10's batches: (B, L, position layout, tables) with the zh tables or
# roberta-base's (chip_smoke.py's)
EMB_BATCHES = {"zh 64x96": (64, 96, "bert", "ZH_EMB_ROWS"),
               "en 64x128": (64, 128, "roberta", "ROBERTA_ROWS"),
               "pretrain 256x64": (256, 64, "bert", "ZH_EMB_ROWS"),
               "stage1 300x60": (300, 60, "bert", "ZH_EMB_ROWS")}


def emb_calls(cs) -> dict:
    """{row name: (a call of the checkout's K10 over the three tables of
    chip_smoke.emb_batch's inputs, its bound ms)}."""
    from carel_tpu_torch.ops import cuda_embedding as ce

    out = {}
    for name, (B, L, layout, tables) in EMB_BATCHES.items():
        rows = getattr(cs, tables)
        ids, g = cs.emb_batch(B, L, rows, layout, seed=B * L)
        if hasattr(ce, "embeddings_backward_kernel"):
            def call(ids=ids, g=g, rows=rows):
                return ce.embeddings_backward_kernel(ids, g, rows)
        else:
            def call(ids=ids, g=g, rows=rows):
                return [ce.embedding_backward_kernel(i, g, V)
                        for i, V in zip(ids, rows)]
        n, D = g.shape
        nbytes = 8 * n * len(rows) + 4 * n * D + 4 * D * sum(rows)
        out[f"emb_bwd {name}"] = (call, cs.bound_ms(nbytes, 0)[0])
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--root", default=str(HERE),
                        help="checkout whose carel_tpu_torch is timed")
    parser.add_argument("--only", nargs="*", default=None,
                        help="rows whose name starts with one of these")
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
    calls = {name: (call, None) for name, call in kernel_calls(cs).items()}
    calls.update(emb_calls(cs))
    rows = {}
    for name, (call, bound) in calls.items():
        if args.only and not name.startswith(tuple(args.only)):
            continue
        device_ms, kernels = cs.device_profile(call)
        row = rows[name] = {"ms": cs.median_ms(call), "device_ms": device_ms,
                            "kernels_per_call": kernels,
                            "host_launch_ms": cs.host_launch_ms(call)}
        print(f"{name}: by events {row['ms']:.4f} ms, device "
              f"{device_ms:.4f} ms in {kernels:g} kernels a call, host "
              f"{row['host_launch_ms']:.4f} ms a call", flush=True)
        if bound is None:
            continue
        row["bound_ms"] = bound
        row["split"] = cs.device_split(call)
        row["sha256"] = hashlib.sha256(b"".join(
            dW.cpu().numpy().tobytes() for dW in call())).hexdigest()
        print(f"{name}: bound {bound:.5f} ms; sha256 {row['sha256']}; "
              "device ms a call by kernel: " + ", ".join(
                  f"{k} {v:.4f}" for k, v in row["split"].items()),
              flush=True)
    result = {"card": smi, "root": str(root), "kernels": rows}
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(result, indent=1))
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
