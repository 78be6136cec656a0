"""Time variants of the tensor-core flash kernels (csrc/flash_mma.cu) on the
card, to pick its constants by measurement.

    python -m carel_tpu_torch.tools.flash_variants [--out FILE]

A variant sets the constants at the head of the source: rows per ring stage
(kTile), ring depth (kStages for K7 and K8, kDqStages for K9), strips a
block owns at most (kMaxWarps), and the blocks per SM that __launch_bounds__
asks for at hd <= 64, which caps the registers (kFwdMinBlocks for K7,
kDkvMinBlocks for K8, kDqMinBlocks for K9). Each variant is written to a
copy of the source, compiled on its own (all nvcc processes started
together, with -Xptxas -v for registers and spills) and loaded with ctypes.
K7 is timed at bf16 [64, 12, 96, 64] and [512, 12, 96, 64], K8 and K9 at
[64, 12, 96, 64], on the packed layout, by CUDA events around 100 launches
started back to back (median of 7 such batches); K7's output and K8's and
K9's gradients are held against the first variant's. Needs a GPU and nvcc;
prints one line per variant and a JSON object last.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

from carel_tpu_torch.ops import native

SOURCE = native.CSRC / "flash_mma.cu"
CONSTANTS = ("kTile", "kStages", "kDqStages", "kMaxWarps", "kFwdMinBlocks",
             "kDkvMinBlocks", "kDqMinBlocks")
# the first is the source as it stands
VARIANTS = (
    None,
    (32, 4, 4, 8, 1, 1, 1), (32, 4, 4, 8, 2, 2, 2), (32, 4, 4, 6, 2, 2, 2),
    (32, 4, 4, 6, 3, 2, 3), (32, 4, 4, 6, 4, 2, 4), (32, 4, 4, 6, 3, 3, 1),
    (32, 3, 3, 6, 3, 2, 3), (32, 2, 2, 6, 3, 2, 3), (32, 4, 3, 6, 3, 2, 2),
    (32, 4, 2, 6, 3, 2, 2), (32, 4, 2, 6, 3, 2, 3), (32, 4, 2, 6, 3, 2, 4),
    (32, 4, 4, 3, 6, 4, 6), (32, 4, 2, 3, 6, 4, 6), (32, 4, 2, 2, 8, 6, 8),
    (16, 8, 8, 6, 3, 2, 3), (16, 8, 4, 6, 4, 3, 4),
)
_P, _I, _F, _LL = (ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                   ctypes.c_longlong)


def variant_source(values) -> str:
    text = SOURCE.read_text()
    if values is None:
        return text
    for name, value in zip(CONSTANTS, values):
        text, n = re.subn(rf"(constexpr int {name} = )\d+;",
                          rf"\g<1>{value};", text)
        if n != 1:
            raise RuntimeError(f"constant {name} not found once")
    return text


def current_values():
    text = SOURCE.read_text()
    return tuple(int(re.search(rf"constexpr int {n} = (\d+);", text).group(1))
                 for n in CONSTANTS)


def registers(log: str) -> dict:
    """{kernel<HD>: (registers, spill bytes)} from a ptxas -v log."""
    out = {}
    for name, (regs, _, spills) in native.ptxas_resources(log).items():
        m = re.search(r"\d(flash_(?:fwd|bwd_dkv|bwd_dq)_mma)_kernelILi(\d+)E",
                      name)
        if m:
            out[f"{m.group(1)}<{m.group(2)}>"] = (regs, spills)
    return out


def build_all(tmp: Path):
    nvcc = native._nvcc()
    procs = []
    for i, values in enumerate(VARIANTS):
        src = tmp / f"v{i}.cu"
        src.write_text(variant_source(values))
        lib = tmp / f"v{i}.so"
        procs.append((lib, subprocess.Popen(
            [nvcc, *native.ARCH_FLAGS, "-O3", "-std=c++17", "-Xptxas", "-v",
             "-Xcompiler", "-fPIC", "-shared", str(src), "-o", str(lib)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    built = []
    for lib, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {lib.name}:\n{log[-4000:]}")
        handle = ctypes.CDLL(str(lib))
        handle.carel_flash_fwd_bf16.argtypes = (
            [_P] * 6 + [_I] * 4 + [_LL] * 6 + [_F, _P])
        handle.carel_flash_bwd_dkv_bf16.argtypes = (
            [_P] * 9 + [_I] * 4 + [_LL] * 9 + [_F, _P])
        handle.carel_flash_bwd_dq_bf16.argtypes = (
            [_P] * 9 + [_I] * 4 + [_LL] * 12 + [_F, _P])
        built.append((handle, registers(log)))
    return built


def batch_ms(fn, launches: int = 100, batches: int = 7) -> float:
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(batches):
        start.record()
        for _ in range(launches):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / launches)
    return float(np.median(times))


def problem(B: int, h: int = 12, L: int = 96, hd: int = 64, seed: int = 0):
    """Packed qkv, dout, dqkv and out buffers, the segment ids, lse and
    delta (from the port's own K7 and K9) at one shape."""
    from carel_tpu_torch.ops import cuda_attention as ca

    gen = torch.Generator(device="cuda").manual_seed(seed)
    qkv = torch.randn(B, L, 3, h, hd, device="cuda",
                      generator=gen).to(torch.bfloat16)
    dout = torch.randn(B, L, h, hd, device="cuda",
                       generator=gen).to(torch.bfloat16).transpose(1, 2)
    lengths = torch.randint(1, L + 1, (B,), device="cuda", generator=gen)
    lengths[0], lengths[1] = L, 0
    seg = (torch.arange(L, device="cuda")[None, :]
           < lengths[:, None]).to(torch.int32).contiguous()
    q, k, v = (t.transpose(1, 2) for t in qkv.unbind(2))
    out = torch.empty(B, L, h, hd, dtype=qkv.dtype,
                      device="cuda").transpose(1, 2)
    dqkv = torch.empty_like(qkv)
    dq, dk, dv = (t.transpose(1, 2) for t in dqkv.unbind(2))
    scale = hd ** -0.5
    lse = ca.flash_forward_kernel(q, k, v, seg, scale, out)
    delta = ca.flash_backward_dq_kernel(q, k, v, seg, out, dout, lse, scale,
                                        dq)
    return dict(B=B, h=h, L=L, hd=hd, q=q, k=k, v=v, seg=seg, out=out,
                dout=dout, lse=lse, delta=delta, dq=dq, dk=dk, dv=dv,
                scale=scale)


def calls(handle, p):
    stream = native.stream(p["q"].device)
    st = lambda t: (t.stride(0), t.stride(1), t.stride(2))  # noqa: E731
    ptr = lambda *ts: [t.data_ptr() for t in ts]  # noqa: E731

    def fwd():
        err = handle.carel_flash_fwd_bf16(
            *ptr(p["q"], p["k"], p["v"], p["seg"], p["out"], p["lse"]),
            p["B"], p["h"], p["L"], p["hd"], *st(p["q"]), *st(p["out"]),
            p["scale"], stream)
        if err:
            raise RuntimeError(f"forward launch failed: CUDA error {err}")

    def dkv():
        err = handle.carel_flash_bwd_dkv_bf16(
            *ptr(p["q"], p["k"], p["v"], p["seg"], p["dout"], p["lse"],
                 p["delta"], p["dk"], p["dv"]),
            p["B"], p["h"], p["L"], p["hd"], *st(p["q"]), *st(p["dout"]),
            *st(p["dk"]), p["scale"], stream)
        if err:
            raise RuntimeError(f"dk/dv launch failed: CUDA error {err}")

    def dq():
        err = handle.carel_flash_bwd_dq_bf16(
            *ptr(p["q"], p["k"], p["v"], p["seg"], p["out"], p["dout"],
                 p["lse"], p["delta"], p["dq"]),
            p["B"], p["h"], p["L"], p["hd"], *st(p["q"]), *st(p["out"]),
            *st(p["dout"]), *st(p["dq"]), p["scale"], stream)
        if err:
            raise RuntimeError(f"dq launch failed: CUDA error {err}")

    return fwd, dkv, dq


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--out", default=None, help="also write the JSON here")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("needs a GPU", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)
    train, serve = problem(64), problem(512, seed=1)
    rows = []
    with tempfile.TemporaryDirectory() as tmp:
        built = build_all(Path(tmp))
        want = None
        for values, (handle, regs) in zip(VARIANTS, built):
            fwd, dkv, dq = calls(handle, train)
            fwd512, *_ = calls(handle, serve)
            row = {
                "constants": dict(zip(CONSTANTS, values or current_values())),
                "as_committed": values is None,
                "fwd_ms": batch_ms(fwd), "dkv_ms": batch_ms(dkv),
                "dq_ms": batch_ms(dq), "fwd_b512_ms": batch_ms(fwd512),
                "registers": {k: regs[k] for k in (
                    "flash_fwd_mma<64>", "flash_bwd_dkv_mma<64>",
                    "flash_bwd_dq_mma<64>")}}
            got = [t.clone() for t in (train["out"], train["dq"],
                                       train["dk"], train["dv"])]
            want = want or got
            # the tile width changes where the online softmax rounds
            row["max_abs_vs_first"] = max(
                float((a.float() - b.float()).abs().max())
                for a, b in zip(got, want))
            rows.append(row)
            print(json.dumps(row), flush=True)
    result = {"card": smi, "shape": "bf16 [64 | 512, 12, 96, 64], packed",
              "variants": rows}
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(result, indent=1))
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
