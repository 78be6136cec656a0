"""Drive the PyTorch/CUDA port (carel_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and no phase carries on after
an error:

1. device: require CUDA; print the nvidia-smi name and power limit line;
2. build: compile the hand-written kernels K1-K9 from carel_tpu_torch/csrc;
3. kernels: hold each kernel against its plain PyTorch version at the shapes
   of the training step (fp32; HSIC against the plain version evaluated in
   float64, at two input scales), print errors, median times by CUDA events
   and the plain version's time; hold the encoder's fp32 attention scores
   (bf16 tensor-core GEMM with an fp32 output) against the product of the
   upcast q and k; hold the fused BoW kernels also at ragged shapes (V =
   1,003 with B = 5 and 200, and B = 300 at the full V, where the forward
   evaluates its logits twice) and require two runs of each to give the
   same bits; hold HSIC also at B = 1,000 (where the forward evaluates its
   Gram entries again) and require two runs of its forward to give the same
   bits; hold MMD also at B = 1,000 with 7 masked rows, with one alpha and
   with four (the kernels' most), and at every shape require two runs of K1
   and of K2 to give the same bits, K1 + K2 captured in one CUDA graph to
   replay them, and (B = 64) one device kernel a call of each; hold the flash
   attention kernels K7-K9 against their plain version in fp32 (CUDA-core
   kernels) and bf16 (tensor-core
   kernels), at the training and the inference shape, at a ragged tiny
   one, at L over one block's rows (200, 513), at hd = 128 and with pad
   tails longer than one tile of keys, with an all-pad row and a row
   without pads, in the stock and the packed layout, and require two runs
   to give the same bits; time every kernel, its plain version and, for
   K7-K9, the library call by CUDA events and by the profiler's device time
   per call, and the host's cost of one launch;
4. reference: a tiny model takes one training step on the card (kernels) and
   on the CPU (plain versions) from the same weights and batch, under the
   flagship's MMD (with the default and the flash attention) and under
   ec_hsic; loss and updated weights must agree;
5. main paths, each at full width (12L/768H encoder, vocab 21,128, ec_dim
   24, BoW vocab 23,808, max_len 96, batch 64) on random weights from a
   seed, on a synthetic target domain (documents of 3-12 clauses with all
   their candidate pairs): init_state, one base epoch of train_epochs (the
   best checkpoint saved and reloaded), then self_train; every kernel launch
   of that run is counted, with the counts set to 0 just before it, and the
   path's kernels must launch on every training step, base and
   self-training alike; then steps are timed and profiled after warm-up and
   the best is reloaded from disk:
   - the flagship preset (MMD: K1-K4), one self-training iteration with
     temporal_order_modification;
   - ec_hsic (binary emotion, HSIC: K3-K6), two self-training iterations of
     one epoch each with the random strategy;
   - the flagship preset with attention_impl="flash" (K1-K4 and K7-K9),
     train then serve: one base epoch, evaluation and the best checkpoint
     saved; the checkpoint loaded into a fresh model; run_pair_inference
     over the test pairs at batch 512, whose probabilities and P/R/F1 must
     equal evaluate's on the same model and seed; PairScorer.score_texts and
     extract_document on synthetic zh strings. K7 must launch once per layer
     on every training step and every evaluation, inference and scoring
     batch, K8 and K9 once per layer on every training step, and no flash
     kernel on the two paths above.

The line before the last is a JSON object with one entry per kernel (its
``launches`` is the sum over the main paths, ``launches_by_path`` splits
it); the last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

# H100 SXM peaks (NVIDIA data sheet, dense, at a 700 W power limit)
PEAK_FP32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12

ROOT = os.path.dirname(os.path.abspath(__file__))
RUN_DIR = os.path.join(ROOT, "build", "chip_smoke")


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def relnorm(a: torch.Tensor, b: torch.Tensor) -> float:
    """Normwise relative error ||a - b|| / ||b||."""
    a, b = a.detach(), b.detach()
    return float(torch.linalg.vector_norm((a - b).double())
                 / torch.linalg.vector_norm(b.double()))


def median_ms(fn, iters: int = 30, warmup: int = 5) -> float:
    """Median time of one call of fn by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(iters):
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def device_profile(fn, iters: int = 30, warmup: int = 5):
    """(device ms, device kernels) of one call of fn: the summed duration
    and the number of the device kernels (and device copies) that
    torch.profiler records over iters calls, divided by iters. Unlike an
    event pair around a Python call the time holds nothing of the host's
    work between launches."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    spans = [e.time_range.elapsed_us() for e in prof.events()
             if e.device_type == DeviceType.CUDA
             and not getattr(e, "is_user_annotation", False)]
    if not spans or sum(spans) == 0:
        fail("device_profile: the profiler recorded no device time")
    return sum(spans) / 1e3 / iters, len(spans) / iters


def device_ms(fn, iters: int = 30, warmup: int = 5) -> float:
    """Device time of one call of fn (see device_profile)."""
    return device_profile(fn, iters, warmup)[0]


def host_launch_ms(fn, iters: int = 200, sync_every: int = 50) -> float:
    """Median host time of one call of fn that is not waited for (the
    wrapper's checks, allocations and the launch), with a synchronize every
    sync_every calls so that the launch queue never fills."""
    fn()
    torch.cuda.synchronize()
    times = []
    for i in range(iters):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
        if (i + 1) % sync_every == 0:
            torch.cuda.synchronize()
    torch.cuda.synchronize()
    return float(np.median(times)) * 1e3


def timed(kernel, plain, library=None) -> dict:
    """The times of one kernel record: by events (``ms``, ``plain_ms``,
    ``library_ms``), the profiler's device time per call of each, the
    device kernels one call of the wrapper launches, and the host's cost of
    one such call."""
    kernel_ms, kernels = device_profile(kernel)
    rec = {"ms": median_ms(kernel), "plain_ms": median_ms(plain),
           "library_ms": median_ms(library) if library else None,
           "device_ms": kernel_ms, "kernels_per_call": kernels,
           "plain_device_ms": device_ms(plain),
           "host_launch_ms": host_launch_ms(kernel)}
    if library:
        rec["library_device_ms"] = device_ms(library)
    return rec


def print_times(name: str, rec: dict) -> None:
    print(f"{name}: device {rec['device_ms']:.4f} ms in "
          f"{rec['kernels_per_call']:g} kernels a call (plain "
          f"{rec['plain_device_ms']:.4f}); by events {rec['ms']:.4f} ms "
          f"(plain {rec['plain_ms']:.4f}); bound {rec['bound_ms']:.6f} ms by "
          f"{rec['bound_by']}; one launch costs the host "
          f"{rec['host_launch_ms']:.4f} ms", flush=True)


def bound_ms(nbytes: float, flops: float, peak_flops: float = PEAK_FP32_FLOPS):
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = flops / peak_flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_device() -> str:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    line = smi.stdout.strip().splitlines()[0]
    print(line, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)
    return line


def phase_build() -> None:
    from carel_tpu_torch.ops import native

    t0 = time.perf_counter()
    path = native.build()
    native.lib()
    print(f"build: {path.name} in {time.perf_counter() - t0:.1f} s",
          flush=True)


def mmd_inputs(B: int, masked: int, d: int = 24, seed: int = 0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, d)).astype(np.float32)
    y = (rng.normal(size=(B, d)) * 1.3 + 0.4).astype(np.float32)
    mask = np.ones(B, np.float32)
    if masked:
        mask[-masked:] = 0.0
    dev = torch.device("cuda")
    return (torch.tensor(x, device=dev), torch.tensor(y, device=dev),
            torch.tensor(mask, device=dev))


MMD_FOUR_ALPHAS = (0.1, 0.5, 1.0, 2.0)  # as many as K1/K2 take


def mmd_graph_replay(x, y, mask, alphas) -> bool:
    """K1 and K2 captured together in one CUDA graph and replayed twice:
    True if each replay writes the bits of the eager calls."""
    from carel_tpu_torch.ops import cuda_pairwise as cp

    g = torch.full((), 0.5, device="cuda")

    def both():
        out, res = cp.mmd_forward_kernel(x, y, mask, alphas)
        grads = cp.mmd_backward_kernel(x, y, mask, res, g, alphas)
        return (out, res, *grads)

    want = [t.clone() for t in both()]
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = both()
    same = True
    for _ in range(2):
        for t in got:
            t.zero_()
        graph.replay()
        torch.cuda.synchronize()
        same = same and all(torch.equal(u, v) for u, v in zip(got, want))
    return same


def phase_mmd(records: dict) -> None:
    from carel_tpu_torch.ops import cuda_pairwise as cp

    alphas = (0.1,)
    worst = {"fwd": 0.0, "bwd": 0.0}
    # B = 1,000: K1 in 7,875 blocks whose last merges, K2 over 8 chunks;
    # four alphas are the kernels' most
    for B, masked, case_alphas in ((64, 0, alphas), (61, 3, alphas),
                                   (1000, 7, alphas),
                                   (1000, 7, MMD_FOUR_ALPHAS)):
        x, y, mask = mmd_inputs(B, masked)
        xk = x.clone().requires_grad_(True)
        yk = y.clone().requires_grad_(True)
        val_k = cp.mmd_statistic(xk, yk, case_alphas, mask)
        dxk, dyk = torch.autograd.grad(val_k, (xk, yk))
        xp = x.clone().requires_grad_(True)
        yp = y.clone().requires_grad_(True)
        val_p = cp.mmd_statistic_plain(xp, yp, case_alphas, mask)
        dxp, dyp = torch.autograd.grad(val_p, (xp, yp))
        vk, vp = float(val_k.detach()), float(val_p.detach())
        rel = abs(vk - vp) / abs(vp)
        gx, gy = relnorm(dxk, dxp), relnorm(dyk, dyp)
        err_v = abs(vk - vp)
        err_g = max(float((dxk - dxp).abs().max()),
                    float((dyk - dyp).abs().max()))
        if masked and (float(dxk[-masked:].abs().max()) != 0.0
                       or float(dyk[-masked:].abs().max()) != 0.0):
            fail("mmd kernel: masked rows got a gradient")
        one = torch.ones((), device="cuda")
        runs = [cp.mmd_forward_kernel(x, y, mask, case_alphas)
                for _ in range(2)]
        if not all(torch.equal(u, v) for u, v in zip(*runs)):
            fail(f"mmd B={B}: two runs of the forward kernel differ")
        grads = [cp.mmd_backward_kernel(x, y, mask, res, one, case_alphas)
                 for _, res in runs]
        if not all(torch.equal(u, v) for u, v in zip(*grads)):
            fail(f"mmd B={B}: two runs of the backward kernel differ")
        if not mmd_graph_replay(x, y, mask, case_alphas):
            fail(f"mmd B={B}: the CUDA-graph replay of K1 + K2 differs from "
                 "the eager calls")
        print(f"mmd B={B} masked={masked} alphas={len(case_alphas)}: value "
              f"{vk:.8e} vs plain {vp:.8e} rel {rel:.2e}; grads normwise "
              f"rel dx {gx:.2e} dy {gy:.2e}; two forward and two backward "
              "runs bit-equal; K1 + K2 replayed from a CUDA graph bit-equal",
              flush=True)
        if not rel <= 1e-5:
            fail(f"mmd forward value rel err {rel:.2e} > 1e-5")
        if not max(gx, gy) <= 1e-5:
            fail(f"mmd backward normwise rel err {max(gx, gy):.2e} > 1e-5")
        worst["fwd"] = max(worst["fwd"], err_v)
        worst["bwd"] = max(worst["bwd"], err_g)

    # times at the training shape, B = 64
    B, d = 64, 24
    x, y, mask = mmd_inputs(B, 0)
    _, res = cp.mmd_forward_kernel(x, y, mask, alphas)
    g = torch.ones((), device="cuda")
    xp = x.clone().requires_grad_(True)
    yp = y.clone().requires_grad_(True)
    val_p = cp.mmd_statistic_plain(xp, yp, alphas, mask)
    t = {
        "fwd": timed(lambda: cp.mmd_forward_kernel(x, y, mask, alphas),
                     lambda: cp.mmd_statistic_plain(x, y, alphas, mask)),
        "bwd": timed(lambda: cp.mmd_backward_kernel(x, y, mask, res, g,
                                                    alphas),
                     lambda: torch.autograd.grad(val_p, (xp, yp),
                                                 retain_graph=True)),
    }
    # the distinct pairs: the xx and yy blocks are symmetric and their
    # diagonals drop out of the estimator, so B(B-1)/2 pairs each; the xy
    # block has B^2
    pairs = B * (B - 1) + B * B
    in_bytes = 4 * (2 * B * d + B)
    # least work for the function: each row's squared norm once (2 B rows of
    # d FMA); per pair the dot product (d FMA) and the scalar work of
    # |a|^2 + |b|^2 - 2 a.b, abs, eps and, per alpha, scale and exp (forward),
    # or the coefficient (backward), then the mask and the sum
    norms = 2 * B * 2 * d
    pair_ops = 2 * d + 6 + 2 * len(alphas)
    # backward: one Gram rebuild per pair, and c * (a - b) accumulated into
    # both output rows the pair reaches (2 d each)
    work = {"fwd": (in_bytes + 4, norms + pairs * pair_ops),
            "bwd": (in_bytes + 8 + 4 * 2 * B * d,
                    norms + pairs * (pair_ops + 1 + 2 * 2 * d))}
    print("mmd least work: " + "; ".join(
        f"{k} {nb} bytes, {fl} FLOP" for k, (nb, fl) in work.items()),
        flush=True)
    for key in ("fwd", "bwd"):
        if round(t[key]["kernels_per_call"]) != 1:
            fail(f"mmd {key}: {t[key]['kernels_per_call']:g} device kernels "
                 "a call, want 1")
    fwd_b, bwd_b = bound_ms(*work["fwd"]), bound_ms(*work["bwd"])
    for name, route_line, b, key in (
            ("mmd_fwd", 62, fwd_b, "fwd"), ("mmd_bwd", 90, bwd_b, "bwd")):
        records[name] = {
            "name": name, "route": "cuda",
            "source": "carel_tpu_torch/csrc/mmd.cu",
            "replaces": f"carel_tpu/ops/pallas_pairwise.py:{route_line}",
            "launches": 0, "max_abs_err": worst[key], **t[key],
            "bound_ms": b[0], "bound_by": b[1]}
        print_times(name, records[name])


HSIC_SPREAD, HSIC_TIGHT = 0.2, 0.2e-2


def hsic_inputs(B: int, masked: int, scale: float, d: int = 24,
                seed: int = 0):
    """Latents N(0, scale^2) per coordinate: scale 0.2 gives squared
    distances ~2 (the row spread of the latents at init is ~0.2), scale
    0.002 makes K and L nearly all ones."""
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(B, d)) * scale).astype(np.float32)
    y = (rng.normal(size=(B, d)) * 1.3 * scale + 0.1 * scale).astype(
        np.float32)
    mask = np.ones(B, np.float32)
    if masked:
        mask[-masked:] = 0.0
    dev = torch.device("cuda")
    return (torch.tensor(x, device=dev), torch.tensor(y, device=dev),
            torch.tensor(mask, device=dev))


def phase_hsic(records: dict) -> None:
    """K5/K6 against the plain HSIC on the same inputs. The gate is the
    plain version evaluated in float64: with tight latents the plain fp32
    version is itself off by ~3e-4 (the cancellation the kernels avoid by
    working in double), and its error is printed beside."""
    from carel_tpu_torch.ops import cuda_pairwise as cp

    s_x = s_y = 1.0  # hsic_sigma of the ec_hsic preset
    worst = {"fwd": 0.0, "bwd": 0.0}
    for scale in (HSIC_SPREAD, HSIC_TIGHT):
        # B = 1,000: K5's multi-block path, entries evaluated again
        for B, masked in ((64, 0), (61, 3), (1000, 7)):
            x, y, mask = hsic_inputs(B, masked, scale)
            xk = x.clone().requires_grad_(True)
            yk = y.clone().requires_grad_(True)
            val_k = cp.hsic_statistic(xk, yk, s_x, s_y, mask)
            dxk, dyk = torch.autograd.grad(val_k, (xk, yk))
            ref = {}
            for dtype in (torch.float64, torch.float32):
                xp = x.to(dtype).requires_grad_(True)
                yp = y.to(dtype).requires_grad_(True)
                val_p = cp.hsic_plain(xp, yp, s_x, s_y, mask.to(dtype))
                ref[dtype] = (float(val_p.detach()),
                              *torch.autograd.grad(val_p, (xp, yp)))
            vk = float(val_k.detach())
            vp, dxp, dyp = ref[torch.float64]
            rel = abs(vk - vp) / abs(vp)
            gx, gy = relnorm(dxk, dxp), relnorm(dyk, dyp)
            v32, dx32, dy32 = ref[torch.float32]
            rel32 = abs(v32 - vp) / abs(vp)
            g32 = max(relnorm(dx32, dxp), relnorm(dy32, dyp))
            if masked and (float(dxk[-masked:].abs().max()) != 0.0
                           or float(dyk[-masked:].abs().max()) != 0.0):
                fail("hsic kernel: masked rows got a gradient")
            runs = [cp.hsic_forward_kernel(x, y, mask, s_x, s_y)
                    for _ in range(2)]
            if not (torch.equal(runs[0][0], runs[1][0])
                    and torch.equal(runs[0][1], runs[1][1])):
                fail(f"hsic B={B}: two runs of the forward kernel differ")
            print(f"hsic scale={scale} B={B} masked={masked}: value "
                  f"{vk:.8e} vs plain float64 {vp:.8e} rel {rel:.2e}; "
                  f"grads normwise rel dx {gx:.2e} dy {gy:.2e} (plain fp32 "
                  f"vs float64: value {rel32:.2e}, grads {g32:.2e}); two "
                  "forward runs bit-equal", flush=True)
            if not rel <= 1e-5:
                fail(f"hsic forward value rel err {rel:.2e} > 1e-5")
            if not max(gx, gy) <= 1e-4:
                fail(f"hsic backward normwise rel err {max(gx, gy):.2e} > "
                     "1e-4")
            worst["fwd"] = max(worst["fwd"], abs(vk - vp))
            worst["bwd"] = max(worst["bwd"],
                               float((dxk.double() - dxp).abs().max()),
                               float((dyk.double() - dyp).abs().max()))

    # times at the training shape, B = 64, spread latents
    B, d = 64, 24
    x, y, mask = hsic_inputs(B, 0, HSIC_SPREAD)
    _, res = cp.hsic_forward_kernel(x, y, mask, s_x, s_y)
    g = torch.ones((), device="cuda")
    xp = x.clone().requires_grad_(True)
    yp = y.clone().requires_grad_(True)
    val_p = cp.hsic_plain(xp, yp, s_x, s_y, mask)
    t = {
        "fwd": timed(lambda: cp.hsic_forward_kernel(x, y, mask, s_x, s_y),
                     lambda: cp.hsic_plain(x, y, s_x, s_y, mask)),
        "bwd": timed(lambda: cp.hsic_backward_kernel(x, y, mask, s_x, s_y,
                                                     res, g),
                     lambda: torch.autograd.grad(val_p, (xp, yp),
                                                 retain_graph=True)),
    }
    # least work for the function, counted as for MMD: each row's squared
    # norm once (2 B rows of d FMA). Each Gram is symmetric with a diagonal
    # of exactly 1, so only its B(B-1)/2 distinct pairs cost work: the dot
    # product (d FMA), |a|^2 + |b|^2 - 2 a.b, the scale and the exp.
    # Forward: tr(KHLH) = sum K.L - (2/n) sum rK rL + sum K sum L / n^2, so
    # per distinct pair one multiply-add for sum K.L and one add into each of
    # the two row sums of each Gram, then O(B) for the rest.
    # Backward: dz_i = sum_j W_ij (z_i - z_j) = z_i sum_j W_ij - (W z)_i,
    # W the other Gram centred times this Gram times a constant: both half
    # Grams and their row sums as above; per distinct pair and side W (3 for
    # the centred entry, 2 products) and its two row-sum adds; per ordered
    # pair and side one FMA per coordinate for W z; per row and side z_i
    # times its row sum
    norms = 2 * B * 2 * d
    half = B * (B - 1) // 2
    grams = 2 * half * (2 * d + 5) + half * 2 * 2
    in_bytes = 4 * (2 * B * d + B)
    work = {"fwd": (in_bytes + 4, norms + grams + half * 2 + 4 * B),
            "bwd": (in_bytes + 4 + 4 * 2 * B * d,
                    norms + grams + half * 2 * (5 + 2)
                    + 2 * B * (B - 1) * 2 * d + 2 * B * 2 * d)}
    print("hsic least work: " + "; ".join(
        f"{k} {nb} bytes, {fl} FLOP" for k, (nb, fl) in work.items()),
        flush=True)
    fwd_b, bwd_b = bound_ms(*work["fwd"]), bound_ms(*work["bwd"])
    for name, line, b, key in (("hsic_fwd", 204, fwd_b, "fwd"),
                               ("hsic_bwd", 227, bwd_b, "bwd")):
        records[name] = {
            "name": name, "route": "cuda",
            "source": "carel_tpu_torch/csrc/hsic.cu",
            "replaces": f"carel_tpu/ops/pallas_pairwise.py:{line}",
            "launches": 0, "max_abs_err": worst[key], **t[key],
            "bound_ms": b[0], "bound_by": b[1]}
        print_times(name, records[name])


def bow_inputs(B=64, D=48, V=23808, T=128, masked=4, seed=1):
    rng = np.random.default_rng(seed)
    dev = torch.device("cuda")
    h = rng.normal(size=(B, D)).astype(np.float32)
    W = (rng.normal(size=(V, D)) / math.sqrt(D)).astype(np.float32)
    b = (rng.normal(size=V) * 0.1).astype(np.float32)
    idx = np.full((B, T), -1, np.int64)
    wts = np.zeros((B, T), np.float32)
    for r in range(B):
        k = int(rng.integers(8, 48))
        idx[r, :k] = rng.choice(V, size=k, replace=False)
        cnt = rng.integers(1, 4, size=k).astype(np.float32)
        wts[r, :k] = cnt / cnt.sum()
    idx[0, 1] = idx[0, 0]  # one duplicate index
    mask = np.ones(B, np.float32)
    mask[B - masked:] = 0.0
    return tuple(torch.tensor(a, device=dev) for a in (h, W, b, idx, wts, mask))


def bow_rowp(stats: torch.Tensor, mask: torch.Tensor, V: int) -> torch.Tensor:
    """A rowp [5, B] for K4 from K3's row sums, with A = 0 and the weights
    of a mean over B x V."""
    B = stats.shape[1]
    return torch.stack([stats[0], torch.zeros_like(stats[0]),
                        mask * 0.9 / (B * V), mask * 0.1 / (V * B * V),
                        mask / (B * V)]).contiguous()


def bow_case(B: int, V: int, masked: int):
    """K3 and K4 through fused_bow_loss against the plain version at one
    shape: value rtol 1e-5, gradients normwise 1e-4; two runs of K3 and two
    of K4 must give the same bits. Returns the largest absolute errors
    (value, grads) and the plain version's graph for the timing."""
    from carel_tpu_torch.ops import cuda_bow as cb

    h, W, b, idx, wts, mask = bow_inputs(B=B, V=V, masked=masked)
    D = h.shape[1]
    leaves_k = [t.clone().requires_grad_(True) for t in (h, W, b)]
    val_k = cb.fused_bow_loss(*leaves_k, idx, wts, 0.1, mask)
    gk = torch.autograd.grad(val_k, leaves_k)
    leaves_p = [t.clone().requires_grad_(True) for t in (h, W, b)]
    val_p = cb.fused_bow_loss_plain(*leaves_p, idx, wts, 0.1, mask)
    gp = torch.autograd.grad(val_p, leaves_p, retain_graph=True)
    vk, vp = float(val_k.detach()), float(val_p.detach())
    rel = abs(vk - vp) / abs(vp)
    grel = {n: relnorm(a, c) for n, a, c in zip(("dh", "dW", "db"), gk, gp)}
    stats = cb.bow_forward_kernel(h, W, b)
    if not torch.equal(stats, cb.bow_forward_kernel(h, W, b)):
        fail(f"bow B={B} V={V}: two runs of the forward kernel differ")
    rowp = bow_rowp(stats, mask, V)
    if not all(torch.equal(u, v) for u, v in zip(
            cb.bow_backward_kernel(h, W, b, rowp),
            cb.bow_backward_kernel(h, W, b, rowp))):
        fail(f"bow B={B} V={V}: two runs of the backward kernel differ")
    print(f"bow B={B} D={D} V={V}: value {vk:.8e} vs plain "
          f"{vp:.8e} rel {rel:.2e}; grads normwise rel "
          + " ".join(f"{n} {v:.2e}" for n, v in grel.items())
          + "; two forward and two backward runs bit-equal", flush=True)
    if not rel <= 1e-5:
        fail(f"bow forward value rel err {rel:.2e} > 1e-5")
    if not max(grel.values()) <= 1e-4:
        fail(f"bow backward normwise rel err {max(grel.values()):.2e} > 1e-4")
    err_g = max(float((a - c).abs().max()) for a, c in zip(gk, gp))
    return abs(vk - vp), err_g, (val_p, leaves_p)


def phase_bow(records: dict) -> None:
    from carel_tpu_torch.ops import cuda_bow as cb

    # the training shape, then ragged ones: V no multiple of anything with a
    # few and with many rows, and more rows than the forward keeps on chip
    err_v, err_g, (val_p, leaves_p) = bow_case(64, 23808, 4)
    for B, V in ((5, 1003), (200, 1003), (300, 23808)):
        ev, eg, _ = bow_case(B, V, 1)
        err_v, err_g = max(err_v, ev), max(err_g, eg)

    h, W, b, idx, wts, mask = bow_inputs()
    B, D = h.shape
    V = W.shape[0]
    rowp = bow_rowp(cb.bow_forward_kernel(h, W, b), mask, V)
    t = {
        "fwd": timed(lambda: cb.bow_forward_kernel(h, W, b),
                     lambda: cb.fused_bow_loss_plain(h, W, b, idx, wts, 0.1,
                                                     mask)),
        "bwd": timed(lambda: cb.bow_backward_kernel(h, W, b, rowp),
                     lambda: torch.autograd.grad(val_p, leaves_p,
                                                 retain_graph=True)),
    }
    zflops = 2 * B * D * V
    w_bytes = 4 * (V * D + V)
    # least work for the function: one z evaluation and ~8 elementwise
    # operations per logit (forward); z, dW and dh products and ~10 per
    # logit (backward)
    fwd_b = bound_ms(w_bytes + 4 * B * D + 4 * 4 * B, zflops + 8 * B * V)
    bwd_b = bound_ms(2 * w_bytes + 2 * 4 * B * D + 4 * 5 * B,
                     3 * zflops + 10 * B * V)
    for name, line, bnd, key in (("bow_fwd", 52, fwd_b, "fwd"),
                                 ("bow_bwd", 119, bwd_b, "bwd")):
        records[name] = {
            "name": name, "route": "cuda",
            "source": "carel_tpu_torch/csrc/bow.cu",
            "replaces": f"carel_tpu/ops/pallas_bow.py:{line}",
            "launches": 0,
            "max_abs_err": err_v if key == "fwd" else err_g, **t[key],
            "bound_ms": bnd[0], "bound_by": bnd[1]}
        print_times(name, records[name])


def phase_scores() -> None:
    """The encoder's fp32 attention scores at the full-width shape: the bf16
    tensor-core GEMM with an fp32 output, which the model runs on CUDA,
    against the fp32 product of the upcast q and k, forward and backward,
    with the time of one forward and backward of each."""
    from carel_tpu_torch.models.encoder import attention_scores, scores_upcast

    B, h, L, hd = 64, 12, 96, 64
    gen = torch.Generator(device="cuda").manual_seed(5)
    q, k = (torch.randn(B, h, L, hd, device="cuda", generator=gen)
            .to(torch.bfloat16) for _ in range(2))
    g = torch.randn(B, h, L, L, device="cuda", generator=gen)
    got = {}
    for name, fn in (("tensor-core", attention_scores),
                     ("upcast", scores_upcast)):
        leaves = (q.clone().requires_grad_(True),
                  k.clone().requires_grad_(True))

        def fwd_bwd():
            s = fn(*leaves)
            return (s.detach(), *torch.autograd.grad(s, leaves, g))

        got[name] = fwd_bwd()
        ms = median_ms(fwd_bwd)
        print(f"scores {name}: {ms:.4f} ms forward + backward at "
              f"[{B}, {h}, {L}, {hd}]", flush=True)
    (s, dq, dk), (s_u, dq_u, dk_u) = got["tensor-core"], got["upcast"]
    errs = (relnorm(s, s_u), relnorm(dq, dq_u), relnorm(dk, dk_u))
    print("scores tensor-core vs upcast: normwise rel scores {:.2e}, dq "
          "{:.2e}, dk {:.2e}".format(*errs), flush=True)
    # both sum the exact bf16 products in fp32, in another order
    if s.dtype != torch.float32 or dq.dtype != torch.bfloat16:
        fail(f"scores: dtypes {s.dtype}, {dq.dtype}")
    if not max(errs) <= 1e-5:
        fail(f"scores: tensor-core path off the upcast by {max(errs):.2e}")


FLASH_KERNELS = ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq")
# Normwise gates on K7-K9 against the plain version evaluated in fp32 from
# the same inputs. fp32 inputs: only the order of the sums differs. bf16
# inputs: the kernels round exp(s - max) (K7), p and ds (K8, K9) and their
# results to bf16, each rounding 2^-9 relative at most; the gates are three
# times the errors measured on the card with the first, CUDA-core kernels
# (output 2.0e-3, gradients 2.6e-3); the tensor-core kernels are held to the
# same gates.
FLASH_GATES = {torch.float32: (1e-5, 1e-4), torch.bfloat16: (6e-3, 8e-3)}


def flash_inputs(B: int, h: int, L: int, hd: int, dtype, seed: int,
                 min_tail: int = 0):
    """q, k, v and a cotangent, N(0, 1) from a seed, and a mask with pad
    tails of varied length, each min_tail at least: row 0 has no pads, row 1
    is all pads."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v, g = (torch.randn(B, h, L, hd, device="cuda", generator=gen)
                  .to(dtype) for _ in range(4))
    lengths = torch.randint(1, L - min_tail + 1, (B,), device="cuda",
                            generator=gen)
    lengths[0], lengths[1] = L, 0
    mask = (torch.arange(L, device="cuda")[None, :]
            < lengths[:, None]).to(torch.int32)
    return q, k, v, g, mask


def pack_heads(q, k, v):
    """[B, h, L, hd] x 3 -> the encoder's packed projection [B, L, 3, h,
    hd]."""
    return torch.stack([t.transpose(1, 2) for t in (q, k, v)],
                       dim=2).contiguous()


def flash_case(B: int, h: int, L: int, hd: int, dtype, backward: bool,
               min_tail: int = 0):
    """K7 (and K8/K9) against the plain version at one shape; returns the
    largest absolute errors of the output and of the gradients."""
    from carel_tpu_torch.ops import cuda_attention as ca

    q, k, v, g, mask = flash_inputs(B, h, L, hd, dtype, seed=B + L,
                                    min_tail=min_tail)
    scale = 1.0 / math.sqrt(hd)
    name = f"flash {str(dtype).split('.')[-1]} [{B}, {h}, {L}, {hd}]" \
        + (f" pad tails >= {min_tail}" if min_tail else "")

    def run_kernels():
        leaves = [t.clone().requires_grad_(backward) for t in (q, k, v)]
        out = ca.flash_attention(*leaves, mask, scale)
        grads = torch.autograd.grad(out, leaves, g) if backward else ()
        return (out.detach(), *grads)

    got = run_kernels()
    if not all(torch.equal(a, b) for a, b in zip(got, run_kernels())):
        fail(f"{name}: two runs differ")
    if not all(bool(torch.isfinite(t).all()) for t in got):
        fail(f"{name}: non-finite values (row 1 is all pads)")

    # the packed layout reads the same values through other strides
    qkv = pack_heads(q, k, v).requires_grad_(backward)
    ctx = ca.flash_attention_packed(qkv, mask, scale)
    packed = [ctx.detach().view(B, L, h, hd).transpose(1, 2)]
    if backward:
        (dqkv,) = torch.autograd.grad(
            ctx, qkv, g.transpose(1, 2).reshape(B, L, h * hd))
        packed += [t.transpose(1, 2) for t in dqkv.unbind(2)]
    if not all(torch.equal(a, b) for a, b in zip(got, packed)):
        fail(f"{name}: the packed layout differs from the stock layout")

    leaves = [t.float().clone().requires_grad_(backward) for t in (q, k, v)]
    ref_out = ca.flash_attention_plain(*leaves, mask, scale)
    ref = (ref_out.detach(), *(torch.autograd.grad(ref_out, leaves, g.float())
                               if backward else ()))
    errs = [relnorm(a.float(), b) for a, b in zip(got, ref)]
    # the plain version on the inputs' own type rounds p where K7 does
    own = ca.flash_attention_plain(q, k, v, mask, scale,
                                   out_dtype=torch.float32)
    err_own = relnorm(got[0].float(), own)
    print(f"{name}: normwise rel vs plain in fp32: out {errs[0]:.2e}"
          + (" dq {:.2e} dk {:.2e} dv {:.2e}".format(*errs[1:])
             if backward else "")
          + f"; out vs plain in the inputs' type {err_own:.2e}; two runs and "
          "the packed layout bit-equal, all finite", flush=True)
    gate_out, gate_grad = FLASH_GATES[dtype]
    if not (errs[0] <= gate_out and err_own <= gate_out):
        fail(f"{name}: output off the plain version by "
             f"{max(errs[0], err_own):.2e} > {gate_out}")
    if backward and not max(errs[1:]) <= gate_grad:
        fail(f"{name}: gradients off the plain version by "
             f"{max(errs[1:]):.2e} > {gate_grad}")
    abs_out = float((got[0].float() - own).abs().max())
    abs_grad = max((float((a.float() - b).abs().max())
                    for a, b in zip(got[1:], ref[1:])), default=0.0)
    return abs_out, abs_grad


def flash_work(mask: torch.Tensor, h: int, hd: int, element_size: int):
    """The least (bytes, operations) of K7-K9 under this mask: every tensor
    moved once; of the L * L pairs of a row only those inside one segment
    (real with real, pad with pad) need their products, each 2 * hd
    operations per product and ~8 for the softmax."""
    B, L = mask.shape
    real = mask.sum(dim=1).double()
    pairs = float((real * real + (L - real) * (L - real)).sum()) * h
    tensor = B * h * L * hd * element_size
    rows = 4 * B * h * L  # one fp32 vector of row terms (lse or delta)
    return {
        # q, k, v, seg -> o, lse: the products s and p.v
        "flash_fwd": (4 * tensor + 4 * B * L + rows,
                      pairs * (4 * hd + 8)),
        # q, k, v, do, seg, lse, delta -> dk, dv: s, dp, dv and dk
        "flash_bwd_dkv": (6 * tensor + 4 * B * L + 2 * rows,
                          pairs * (8 * hd + 8)),
        # q, k, v, o, do, seg, lse -> dq, delta: s, dp and dq, and sum(o.do)
        "flash_bwd_dq": (6 * tensor + 4 * B * L + 2 * rows,
                         pairs * (6 * hd + 8) + 2 * B * h * L * hd),
    }


# (shape [B, h, L, hd], with backward, least pad tail): the training and the
# inference shape; ragged tiny ones (hd = 16 is one k16 step, L = 37 not a
# multiple of 16); L over one block's 128 rows, so that the tensor-core
# kernels' ring of 4 tiles of 32 rows wraps; hd = 128; pad tails longer than
# one tile, where every key of a tile is masked for a row
FLASH_CASES = (((64, 12, 96, 64), True, 0), ((512, 12, 96, 64), False, 0),
               ((5, 4, 37, 16), True, 0), ((3, 2, 200, 64), True, 0),
               ((2, 2, 513, 32), True, 0), ((2, 2, 96, 128), True, 0),
               ((4, 2, 160, 64), True, 48))


def phase_flash(records: dict) -> None:
    """K7-K9 against the plain flash attention, then their times at the
    shape and layout the training step gives them (bf16, packed)."""
    import torch.nn.functional as F

    from carel_tpu_torch.device import resolve_device
    from carel_tpu_torch.ops import cuda_attention as ca

    resolve_device("cuda")  # full-fp32 matmuls for the plain version
    worst = {"fwd": 0.0, "bwd": 0.0}
    for dtype in (torch.float32, torch.bfloat16):
        for shape, backward, min_tail in FLASH_CASES:
            abs_out, abs_grad = flash_case(*shape, dtype, backward, min_tail)
            if dtype == torch.bfloat16:
                worst["fwd"] = max(worst["fwd"], abs_out)
                worst["bwd"] = max(worst["bwd"], abs_grad)

    B, h, L, hd = 64, 12, 96, 64
    scale = 1.0 / math.sqrt(hd)
    q, k, v, g, mask = flash_inputs(B, h, L, hd, torch.bfloat16, seed=1)
    seg = ca.segment_ids(mask)
    qkv = pack_heads(q, k, v)
    qp, kp, vp = (t.transpose(1, 2) for t in qkv.unbind(2))
    out = torch.empty(B, L, h, hd, dtype=q.dtype, device="cuda").transpose(1, 2)
    dout = g.transpose(1, 2).contiguous().transpose(1, 2)
    dqp, dkp, dvp = (t.transpose(1, 2)
                     for t in torch.empty_like(qkv).unbind(2))
    lse = ca.flash_forward_kernel(qp, kp, vp, seg, scale, out)
    delta = ca.flash_backward_dq_kernel(qp, kp, vp, seg, out, dout, lse,
                                        scale, dqp)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    plain_out = ca.flash_attention_plain(*leaves, mask, scale)
    same = (seg[:, None, :, None] == seg[:, None, None, :])
    lib_leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    lib_out = F.scaled_dot_product_attention(*lib_leaves, attn_mask=same,
                                             scale=scale)
    lib_err = relnorm(lib_out.detach().float(), plain_out.detach().float())
    print(f"scaled_dot_product_attention with the segment mask vs plain: "
          f"normwise rel {lib_err:.2e}", flush=True)

    def grad_of(result, wrt):
        return lambda: torch.autograd.grad(result, wrt, g, retain_graph=True)

    # per kernel: the wrapper's call, the plain version, the library call
    calls = {
        "flash_fwd": (
            lambda: ca.flash_forward_kernel(qp, kp, vp, seg, scale, out),
            lambda: ca.flash_attention_plain(q, k, v, mask, scale),
            lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=same,
                                                   scale=scale)),
        "flash_bwd_dkv": (
            lambda: ca.flash_backward_dkv_kernel(qp, kp, vp, seg, dout, lse,
                                                 delta, scale, dkp, dvp),
            grad_of(plain_out, leaves[1:]), grad_of(lib_out, lib_leaves[1:])),
        "flash_bwd_dq": (
            lambda: ca.flash_backward_dq_kernel(qp, kp, vp, seg, out, dout,
                                                lse, scale, dqp),
            grad_of(plain_out, leaves[:1]), grad_of(lib_out, lib_leaves[:1])),
    }
    work = flash_work(mask, h, hd, q.element_size())
    print("flash least work: " + "; ".join(
        f"{n} {nb} bytes, {fl:.0f} FLOP" for n, (nb, fl) in work.items()),
        flush=True)
    stock = {"flash_fwd": 331, "flash_bwd_dkv": 796, "flash_bwd_dq": 1146}
    for name in FLASH_KERNELS:
        kernel, plain, library = calls[name]
        bnd = bound_ms(*work[name], PEAK_BF16_FLOPS)
        rec = records[name] = {
            "name": name, "route": "cuda",
            "source": "carel_tpu_torch/csrc/flash_mma.cu",
            "replaces": "carel_tpu/models/encoder.py:61 (jax/experimental/"
                        f"pallas/ops/tpu/flash_attention.py:{stock[name]})",
            "launches": 0,
            "max_abs_err": worst["fwd" if name == "flash_fwd" else "bwd"],
            **timed(kernel, plain, library),
            "bound_ms": bnd[0], "bound_by": bnd[1]}
        print(f"{name} at bf16 [{B}, {h}, {L}, {hd}], packed layout: device "
              f"{rec['device_ms']:.4f} ms (plain {rec['plain_device_ms']:.4f}"
              f", library {rec['library_device_ms']:.4f}); by events "
              f"{rec['ms']:.4f} ms (plain {rec['plain_ms']:.4f}, library "
              f"{rec['library_ms']:.4f}); bound {bnd[0]:.6f} ms by {bnd[1]}; "
              f"one launch costs the host {rec['host_launch_ms']:.4f} ms",
              flush=True)

    # the forward at the inference batch
    q, k, v, _, mask = flash_inputs(512, h, L, hd, torch.bfloat16, seed=2)
    seg = ca.segment_ids(mask)
    out = torch.empty_like(q)
    same = (seg[:, None, :, None] == seg[:, None, None, :])
    rec = records["flash_fwd"]
    rec["bound_ms_b512"] = bound_ms(
        *flash_work(mask, h, hd, q.element_size())["flash_fwd"],
        PEAK_BF16_FLOPS)[0]
    for key, fn in (
            ("", lambda: ca.flash_forward_kernel(q, k, v, seg, scale, out)),
            ("plain_", lambda: ca.flash_attention_plain(q, k, v, mask,
                                                        scale)),
            ("library_", lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=same, scale=scale))):
        rec[f"{key}ms_b512"] = median_ms(fn)
        rec[f"{key}device_ms_b512"] = device_ms(fn)
    print("flash_fwd at bf16 [512, 12, 96, 64]: device {:.4f} ms (plain "
          "{:.4f}, library {:.4f}); by events {:.4f} ms (plain {:.4f}, "
          "library {:.4f}); bound {:.6f} ms".format(
              *(rec[f"{key}{kind}_b512"] for kind in ("device_ms", "ms")
                for key in ("", "plain_", "library_")),
              rec["bound_ms_b512"]), flush=True)


def tiny_config(preset: str, attention_impl: str = "xla"):
    """The preset's loss and model options at tiny widths, dropout 0."""
    from carel_tpu_torch.config import PRESETS, DataConfig, TrainConfig
    from carel_tpu_torch.models.encoder import tiny_encoder_config

    base = PRESETS[preset]
    return dataclasses.replace(
        base,
        model=dataclasses.replace(
            base.model, encoder=tiny_encoder_config(
                vocab_size=256, dropout=0.0, attention_impl=attention_impl),
            ec_dim=24, bow_dim=3000, dropout=0.0),
        data=DataConfig(max_len=32),
        train=TrainConfig(batch_size=16, vae_lr=1e-3))


def phase_reference(preset: str, attention_impl: str = "xla") -> None:
    """A tiny fp32 model takes one training step on the card (kernels) and on
    the CPU (plain versions) from the same weights, batch and (zero) noise."""
    from carel_tpu_torch.data.batching import cut_batch
    from carel_tpu_torch.pipeline import init_state
    from carel_tpu_torch.train.state import MAIN
    from carel_tpu_torch.train.steps import batch_to_device, make_train_step

    cfg = tiny_config(preset, attention_impl)
    preset = f"{preset} ({attention_impl} attention)"
    arrays = synth_pair_arrays(np.random.default_rng(3), 16, 32, 256, 3000,
                               min_len=8)
    host = cut_batch(arrays, np.arange(14), 16).as_dict()  # 2 padded rows
    step = make_train_step(cfg)
    results = {}
    for dev in ("cpu", "cuda"):
        state = init_state(cfg, dev)
        zeros = torch.zeros(24, device=dev)
        metrics = step(state, batch_to_device(host, torch.device(dev)), 0,
                       eps=(zeros, zeros))
        results[dev] = (
            {k: float(v) for k, v in metrics.items()},
            {n: p.detach().cpu() for n, p in state.model.named_parameters()},
            {n: p.grad.cpu() for n, p in state.model.named_parameters()
             if state.labels[n] == MAIN})
    (m_c, p_c, g_c), (m_g, p_g, g_g) = results["cpu"], results["cuda"]
    worst_m = max(abs(m_g[k] - m_c[k]) / max(abs(m_c[k]), 1e-30) for k in m_c)
    worst_g = max(relnorm(g_g[n], g_c[n]) for n in g_c)
    worst_p = max(float((p_g[n] - p_c[n]).abs().max()) for n in p_c)
    # where |g| > 1e-3 max|g| of its tensor Adam's first step cannot flip
    # sign, so there the card's Adam must match the CPU's tightly
    safe = {n: g_c[n].abs() > 1e-3 * g_c[n].abs().max() for n in g_c}
    worst_safe = max(float((p_g[n] - p_c[n])[safe[n]].abs().max())
                     for n in g_c)
    print(f"reference step {preset} (tiny fp32, card vs CPU): loss "
          f"{m_g['loss']:.6f} "
          f"vs {m_c['loss']:.6f}; worst metric rel {worst_m:.2e}, grad "
          f"normwise rel {worst_g:.2e}, param abs {worst_p:.2e} "
          f"({worst_safe:.2e} where |g| > 1e-3 max|g|)", flush=True)
    # fp32 on both sides, sums in another order: metrics to 1e-4, grads to
    # 1e-3 normwise, params within Adam's sign-flip bound 2 * lr, and to
    # 1e-3 * lr where the sign is safe
    lr = cfg.train.vae_lr
    if not (worst_m <= 1e-4 and worst_g <= 1e-3 and worst_p <= 2 * lr
            and worst_safe <= 1e-3 * lr):
        fail(f"card and CPU disagree on the {preset} reference step")


def synth_pair_arrays(rng, n: int, L: int, vocab: int, bow_dim: int,
                      min_len: int = 16, terms: int = 128):
    """PairArrays of random tokens (the way bench.py builds its batch) with
    ragged lengths and a few dozen real BoW terms per row."""
    from carel_tpu_torch.data.batching import PairArrays

    lengths = rng.integers(min_len, L + 1, n)
    mask = (np.arange(L)[None, :] < lengths[:, None]).astype(np.int32)
    ids = rng.integers(5, vocab, (n, L)).astype(np.int32) * mask
    ids[:, 0] = 2  # [CLS]
    idx = np.full((n, terms), -1, np.int32)
    wts = np.zeros((n, terms), np.float32)
    for r in range(n):
        k = int(rng.integers(min(8, bow_dim), min(48, bow_dim) + 1))
        idx[r, :k] = rng.choice(bow_dim, size=k, replace=False)
        cnt = rng.integers(1, 4, size=k).astype(np.float32)
        wts[r, :k] = cnt / cnt.sum()
    return PairArrays(
        input_ids=ids, attention_mask=mask,
        token_type_ids=np.zeros((n, L), np.int32),
        pair_labels=rng.integers(0, 2, n).astype(np.float32),
        emotion_labels=rng.integers(0, 6, n).astype(np.int32),
        temporal_order=rng.random(n) < 0.5,
        bow_indices=idx, bow_weights=wts)


def synth_target_domain(rng, n_pairs: int, L: int, vocab: int,
                        bow_dim: int):
    """A target-domain test set as the pipeline gives it: a PairSet of
    documents of 3-12 clauses, each with one emotion clause paired with every
    clause (one of them the true cause) and its temporal order, the
    PairArrays of those pairs (random tokens and BoW terms from the seed, as
    synth_pair_arrays makes them), and ``encode``, which gives any subset of
    these pairs its rows of the arrays with the subset's labels."""
    from carel_tpu_torch.data.pairs import PairExample, PairSet

    pairs = PairSet()
    while len(pairs) < n_pairs:
        doc = len(pairs.docs_pair_size)
        n = int(rng.integers(3, 13))
        emo = int(rng.integers(1, n + 1))
        cause = int(np.clip(emo + rng.integers(-2, 2), 1, n))
        for c in range(1, n + 1):
            pairs.examples.append(PairExample(
                pair=f"doc{doc}-e{emo}-c{c}", label=int(c == cause),
                emotion=int(rng.integers(0, 6)), temporal_order=c <= emo,
                doc_index=doc, emo_sen_id=emo, cau_sen_id=c))
        pairs.docs_pair_size.append(n)
    arrays = synth_pair_arrays(rng, len(pairs), L, vocab, bow_dim)
    arrays.pair_labels = np.asarray(pairs.labels, np.float32)
    arrays.temporal_order = np.asarray(
        [e.temporal_order for e in pairs.examples], bool)
    row = {e.pair: i for i, e in enumerate(pairs.examples)}

    def encode(pair_set):
        sub = arrays.take(np.asarray([row[e.pair] for e in pair_set.examples]))
        sub.pair_labels = np.asarray(pair_set.labels, np.float32)
        return sub

    return pairs, arrays, encode


class _Records:
    """Logger for train_epochs and self_train that keeps its records."""

    def __init__(self):
        self.records = []

    def log(self, record: dict) -> None:
        self.records.append(record)


FLAGSHIP = "ec_mmd_final_mul_newsplit_emnlp"

# the kernels each main path must launch on every training step
PATH_KERNELS = {
    FLAGSHIP: ("mmd_fwd", "mmd_bwd", "bow_fwd", "bow_bwd"),
    "ec_hsic": ("hsic_fwd", "hsic_bwd", "bow_fwd", "bow_bwd"),
}


def full_width_config(preset: str, run: str, attention_impl: str = "xla",
                      **train):
    """The preset at full width (12L/768H encoder, vocab 21,128, BoW vocab
    23,808) at b64 x s96 for one base epoch, its checkpoints under the
    run's own directory; ``train`` overrides further TrainConfig fields."""
    from carel_tpu_torch.config import PRESETS, EncoderConfig

    base = PRESETS[preset]
    enc = EncoderConfig(arch="bert", dtype="bfloat16",
                        attention_impl=attention_impl)
    return dataclasses.replace(
        base,
        model=dataclasses.replace(base.model, encoder=enc, bow_dim=23808),
        data=dataclasses.replace(base.data, max_len=96),
        train=dataclasses.replace(
            base.train, batch_size=64, epochs=1,
            checkpoint_dir=os.path.join(RUN_DIR, "ckpt", run), **train))


def probabilities(p: np.ndarray, n: int) -> bool:
    """n finite values in [0, 1]."""
    return p.shape == (n,) and bool(np.all(np.isfinite(p))) \
        and bool(np.all((p >= 0) & (p <= 1)))


def phase_path(records: dict, preset: str, iterations: int,
               strategy: str):
    """The preset at full width: one base epoch, then ``iterations``
    self-training iterations of one epoch with ``strategy``. Returns the
    profiled device ms/step and the run's peak memory in GiB."""
    from carel_tpu_torch import ops
    from carel_tpu_torch.config import SelfStrategy
    from carel_tpu_torch.pipeline import init_state
    from carel_tpu_torch.selftrain import self_train
    from carel_tpu_torch.train import checkpoint as ckpt
    from carel_tpu_torch.train.loop import evaluate, train_epochs
    from carel_tpu_torch.train.steps import make_eval_step, make_train_step

    n_train, n_test, unpred = 1024, 512, 10
    cfg = full_width_config(preset, preset, self_iteration=iterations,
                            self_epochs=1,
                            self_strategy=SelfStrategy(strategy))
    enc, B, L = cfg.model.encoder, cfg.train.batch_size, cfg.data.max_len
    V = cfg.model.bow_dim
    tag = f"{preset} path"
    rng = np.random.default_rng(0)
    train = synth_pair_arrays(rng, n_train, L, enc.vocab_size, V)
    test_pairs, test, encode = synth_target_domain(rng, n_test, L,
                                                   enc.vocab_size, V)

    t0 = time.perf_counter()
    state = init_state(cfg, "cuda")
    n_params = sum(p.numel() for p in state.model.parameters())
    print(f"{tag}: init_state {time.perf_counter() - t0:.1f} s, "
          f"{n_params} params; {len(test_pairs)} test pairs in "
          f"{len(test_pairs.docs_pair_size)} documents", flush=True)
    train_step, eval_step = make_train_step(cfg), make_eval_step()

    # the run's own record of its steps, evaluations and pseudo sets
    losses, prob_ranges, pseudo_sizes = [], [], []

    def counted_step(state, batch, iteration):
        metrics = train_step(state, batch, iteration)
        losses.append(metrics["loss"])
        return metrics

    def checked_eval(model, batch, generator):
        probs = eval_step(model, batch, generator)
        prob_ranges.append(torch.stack([probs.min(), probs.max(),
                                        probs.isfinite().all().float()]))
        return probs

    def checked_encode(pair_set):
        pseudo_sizes.append(list(pair_set.docs_pair_size))
        return encode(pair_set)

    logger = _Records()
    torch.cuda.reset_peak_memory_stats()
    best_cache: dict = {}
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    # best_f1_so_far -1 makes the first evaluation a new best even at F1 = 0
    # (random weights), so the checkpoint save and the best reload both run;
    # initial_best does the same for the first self-training iteration
    state, best = train_epochs(cfg, state, counted_step, checked_eval, train,
                               test, unpred, preset, logger=logger,
                               best_f1_so_far=-1.0, best_cache=best_cache)
    torch.cuda.synchronize()
    t_base = time.perf_counter() - t0
    base_steps = len(losses)
    state, sbest = self_train(cfg, state, counted_step, checked_eval,
                              test_pairs, test, unpred, checked_encode,
                              preset, logger=logger, best_cache=best_cache,
                              initial_best=(0.0, 0.0, -1.0))
    res = evaluate(eval_step, state.model, test, unpred,
                   torch.Generator(device="cuda").manual_seed(0),
                   cfg.train.eval_batch_size)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    wall = time.perf_counter() - t0
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    steps = len(losses)
    losses = torch.stack(losses).tolist()
    ranges = torch.stack(prob_ranges).cpu().numpy()

    ev = {k: [r for r in logger.records if r["event"] == k]
          for k in ("selftrain_iter", "selftrain_best", "selftrain_empty")}
    split = {k: sum(r[k] for r in ev[src]) for k, src in (
        ("eval_seconds", "selftrain_iter"),
        ("pseudo_seconds", "selftrain_iter"),
        ("train_seconds", "selftrain_best"))}
    print(f"{tag}: {base_steps} base steps + eval in {t_base:.3f} s, then "
          f"{iterations} self-training iterations ({steps - base_steps} "
          f"steps) in {wall - t_base:.3f} s: evaluation "
          f"{split['eval_seconds']:.4f} s, pseudo-labelling + encoding "
          f"{split['pseudo_seconds']:.4f} s, fine-tuning (with its "
          f"evaluations) {split['train_seconds']:.4f} s; pseudo pairs "
          f"{[r['pseudo_pairs'] for r in ev['selftrain_iter']]}; best "
          f"{best}, self best {sbest}; evaluate P/R/F1 {res.precision:.4f} "
          f"{res.recall:.4f} {res.f1:.4f}; launches {counts}; peak memory "
          f"{peak_gib:.2f} GiB", flush=True)
    print(f"{tag}: losses (every step) {[round(x, 4) for x in losses]}",
          flush=True)
    if not losses or not all(math.isfinite(x) for x in losses):
        fail(f"{tag}: loss not finite")
    if not (np.all(ranges[:, 2] == 1.0) and ranges[:, 0].min() >= 0.0
            and ranges[:, 1].max() <= 1.0):
        fail(f"{tag}: eval probabilities are not finite values in [0, 1]")
    if not probabilities(res.probs, len(test)):
        fail(f"{tag}: eval probabilities are not finite values in [0, 1]")
    for p in (res.precision, res.recall, res.f1, *best, *sbest):
        if not 0.0 <= p <= 1.0:
            fail(f"{tag}: metric out of range: {p}")
    if ev["selftrain_empty"] or len(ev["selftrain_iter"]) != iterations:
        fail(f"{tag}: a self-training iteration had no pseudo pairs")
    if not all(sizes and set(sizes) == {2} for sizes in pseudo_sizes):
        fail(f"{tag}: pseudo sets are not 2 pairs per document")
    if steps <= base_steps:
        fail(f"{tag}: self-training took no training step")
    for name, n in counts.items():
        want = steps if name in PATH_KERNELS[preset] else 0
        if n != want:
            fail(f"{tag}: kernel {name} launched {n} times in {steps} "
                 f"training steps (want {want})")
        records[name].setdefault("launches_by_path", {})[preset] = n
        records[name]["launches"] = sum(
            records[name]["launches_by_path"].values())
    if not any(r["event"] == "best" for r in logger.records):
        fail(f"{tag}: no best checkpoint was saved")
    saved = ckpt.load_best(cfg.train.checkpoint_dir, preset,
                           torch.device("cuda"))
    if not (same_state(saved, best_cache["state_dict"])
            and same_state(state.model.state_dict(), saved)):
        fail(f"{tag}: the reloaded best differs from the saved checkpoint")

    device_ms = time_steps(tag, train_step, state, train, B, L)

    # the timed steps moved the params; a train_epochs call of no epochs and
    # no in-memory cache reloads the best from disk
    if same_state(state.model.state_dict(), saved):
        fail(f"{tag}: the timed steps left the params unchanged")
    state, _ = train_epochs(cfg, state, train_step, eval_step, train, test,
                            unpred, preset, epochs=0, logger=logger)
    if not same_state(state.model.state_dict(), saved):
        fail(f"{tag}: the reload from disk differs from the checkpoint")
    print(f"{tag}: best checkpoint saved, reloaded from memory and from "
          "disk, equal to the saved state_dict", flush=True)
    return device_ms, peak_gib


def time_steps(tag: str, train_step, state, train, B: int, L: int) -> float:
    """Steady-state step time after warm-up (host clock around synchronize),
    then the profile; returns the device ms/step."""
    from carel_tpu_torch.data.batching import cut_batch
    from carel_tpu_torch.train.steps import batch_to_device

    batches = [batch_to_device(cut_batch(train, np.arange(i * B, (i + 1) * B),
                                         B).as_dict(), torch.device("cuda"))
               for i in range(4)]
    for i in range(3):
        train_step(state, batches[i % 4], i)
    torch.cuda.synchronize()
    n = 20
    t0 = time.perf_counter()
    for i in range(n):
        metrics = train_step(state, batches[i % 4], i)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / n * 1e3
    if not math.isfinite(float(metrics["loss"])):
        fail(f"{tag}: timed steps gave a non-finite loss")
    print(f"{tag} step b{B}xs{L}: {ms:.2f} ms/step, "
          f"{B / ms * 1e3:.1f} pairs/s", flush=True)
    return profile_steps(train_step, state, batches, ms)


# synthetic zh clauses for the raw-text scorer (document 1: clause 3 holds
# the emotion)
ZH_CLAUSES = ["昨天下午下了很大的雨", "他没有带伞就出门了", "回到家里他非常难过",
              "因为新买的书全都湿了", "妈妈安慰他说没关系", "明天再去买一本新的"]


def phase_serve(records: dict):
    """Train, then serve, at full width with attention_impl="flash": the
    flagship takes one base epoch with its evaluation and saves the best;
    a fresh model loads that checkpoint and serves it through
    run_pair_inference and PairScorer. Returns the profiled device ms/step
    and the run's peak memory in GiB."""
    from carel_tpu_torch import ops
    from carel_tpu_torch.data.tokenizer import ZhCharTokenizer
    from carel_tpu_torch.infer import PairScorer, run_pair_inference
    from carel_tpu_torch.pipeline import init_state
    from carel_tpu_torch.train import checkpoint as ckpt
    from carel_tpu_torch.train.loop import evaluate, train_epochs
    from carel_tpu_torch.train.steps import make_eval_step, make_train_step

    n_train, n_test, unpred = 1024, 512, 10
    tag, model_id = "flash path", "flash"
    cfg = full_width_config(FLAGSHIP, model_id, attention_impl="flash",
                            self_iteration=0)
    enc, B, L = cfg.model.encoder, cfg.train.batch_size, cfg.data.max_len
    V, layers = cfg.model.bow_dim, enc.num_layers
    rng = np.random.default_rng(0)
    train = synth_pair_arrays(rng, n_train, L, enc.vocab_size, V)
    test_pairs, test, _ = synth_target_domain(rng, n_test, L, enc.vocab_size,
                                              V)
    test_pairs.num_unpred_emotions = unpred  # emotions stage 1 missed
    state = init_state(cfg, "cuda")
    train_step, eval_step = make_train_step(cfg), make_eval_step()
    losses, forwards = [], []

    def counted_step(state, batch, iteration):
        metrics = train_step(state, batch, iteration)
        losses.append(metrics["loss"])
        return metrics

    def counted_eval(model, batch, generator):
        forwards.append(1)
        return eval_step(model, batch, generator)

    logger = _Records()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    # best_f1_so_far -1 makes the evaluation a new best even at F1 = 0, and
    # without a cache of the best in memory the loop reloads it from disk
    state, best = train_epochs(cfg, state, counted_step, counted_eval, train,
                               test, unpred, model_id, logger=logger,
                               best_f1_so_far=-1.0)
    torch.cuda.synchronize()
    t_train = time.perf_counter() - t0
    steps = len(losses)

    # serve: a fresh model takes the checkpoint
    served = init_state(dataclasses.replace(
        cfg, train=dataclasses.replace(cfg.train, seed=cfg.train.seed + 1)),
        "cuda").model
    if same_state(served.state_dict(), state.model.state_dict()):
        fail(f"{tag}: the fresh model already equals the trained one")
    saved = ckpt.load_best(cfg.train.checkpoint_dir, model_id,
                           torch.device("cuda"))
    served.load_state_dict(saved)
    if not (same_state(served.state_dict(), saved)
            and same_state(state.model.state_dict(), saved)):
        fail(f"{tag}: the reloaded best differs from the saved checkpoint")
    res = run_pair_inference(
        counted_eval, served, test_pairs, test,
        torch.Generator(device="cuda").manual_seed(0),
        cfg.train.eval_batch_size)
    ev = evaluate(counted_eval, served, test, unpred,
                  torch.Generator(device="cuda").manual_seed(0),
                  cfg.train.eval_batch_size)

    tokenizer = ZhCharTokenizer.from_corpus(ZH_CLAUSES)
    scorer = PairScorer(cfg, served, tokenizer, batch_size=cfg.train.
                        eval_batch_size, device="cuda")
    raw = [(ZH_CLAUSES[2], c) for c in ZH_CLAUSES]
    probs = scorer.score_texts(raw)
    hits = scorer.extract_document(ZH_CLAUSES, [3], threshold=0.0)
    scored_batches = 2
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    losses = torch.stack(losses).tolist()

    print(f"{tag}: {steps} base steps + eval + best save and reload in "
          f"{t_train:.3f} s; best {best}; inference over {len(test)} pairs "
          f"at batch {cfg.train.eval_batch_size}: P/R/F1 {res.precision:.4f} "
          f"{res.recall:.4f} {res.f1:.4f}, p50 {res.p50_batch_ms:.2f} ms, "
          f"p95 {res.p95_batch_ms:.2f} ms per batch, "
          f"{res.pairs_per_sec:.1f} pairs/s (first batch excluded); scorer "
          f"probabilities {[round(float(p), 4) for p in probs]}, "
          f"{len(hits)} candidate pairs; launches {counts}; peak memory "
          f"{peak_gib:.2f} GiB", flush=True)
    print(f"{tag}: losses (every step) {[round(x, 4) for x in losses]}",
          flush=True)
    if steps != n_train // B or not all(math.isfinite(x) for x in losses):
        fail(f"{tag}: {steps} steps, or a loss not finite")
    if not probabilities(res.probs, len(test)):
        fail(f"{tag}: inference probabilities are not finite values in "
             "[0, 1]")
    if not (np.array_equal(res.probs, ev.probs)
            and (res.precision, res.recall, res.f1)
            == (ev.precision, ev.recall, ev.f1)):
        fail(f"{tag}: run_pair_inference and evaluate disagree on the same "
             "model and seed")
    if not np.array_equal(res.preds, np.round(res.probs).astype(np.int64)):
        fail(f"{tag}: predictions are not the rounded probabilities")
    if not probabilities(probs, len(raw)):
        fail(f"{tag}: scorer probabilities are not finite values in [0, 1]")
    # threshold 0 keeps every candidate: the sweep is the same six pairs
    if sorted(c for _, c, _ in hits) != list(range(1, len(ZH_CLAUSES) + 1)) \
            or not np.allclose(sorted(p for *_, p in hits), sorted(probs),
                               rtol=0, atol=1e-6):
        fail(f"{tag}: extract_document and score_texts disagree")
    want = {name: steps for name in PATH_KERNELS[FLAGSHIP]}
    want["flash_fwd"] = layers * (steps + len(forwards) + scored_batches)
    want["flash_bwd_dkv"] = want["flash_bwd_dq"] = layers * steps
    for name, n in counts.items():
        if n != want.get(name, 0):
            fail(f"{tag}: kernel {name} launched {n} times in {steps} "
                 f"training steps, {len(forwards)} evaluation and inference "
                 f"batches and {scored_batches} scoring batches (want "
                 f"{want.get(name, 0)})")
        records[name].setdefault("launches_by_path", {})["flash"] = n
        records[name]["launches"] = sum(
            records[name]["launches_by_path"].values())
    device_ms = time_steps(tag, train_step, state, train, B, L)
    return device_ms, peak_gib


def same_state(a: dict, b: dict) -> bool:
    """Two state_dicts with the same keys and bitwise equal tensors."""
    return a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)


def profile_steps(train_step, state, batches, step_ms: float,
                  n: int = 5) -> float:
    """Device time per step by kernel, from torch.profiler over n steps, and
    the device busy share against the unprofiled step time; returns the
    device ms/step (0.0 when the profiler saw no device time)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for i in range(n):
            train_step(state, batches[i % len(batches)], i)
        torch.cuda.synchronize()
    per_kernel: dict = {}
    for e in prof.events():
        # user annotations (e.g. the optimizer step's range) are mirrored on
        # the device timeline and span other kernels: count kernels only
        if (e.device_type == DeviceType.CUDA
                and not getattr(e, "is_user_annotation", False)):
            us, calls = per_kernel.get(e.name, (0.0, 0))
            per_kernel[e.name] = (us + e.time_range.elapsed_us(), calls + 1)
    device_ms = sum(us for us, _ in per_kernel.values()) / 1e3 / n
    if device_ms == 0.0:
        print("profile: the profiler recorded no device time (not measured)",
              flush=True)
        return 0.0
    print(f"profile ({n} steps): device kernels {device_ms:.2f} ms/step of "
          f"{step_ms:.2f} ms/step unprofiled, device busy "
          f"{device_ms / step_ms:.3f}, {sum(c for _, c in per_kernel.values()) // n} "
          "kernels/step", flush=True)
    top = sorted(per_kernel.items(), key=lambda kv: kv[1][0], reverse=True)
    # the twelve largest, and the flash kernels wherever they rank
    for rank, (name, (us, calls)) in enumerate(top):
        if rank < 12 or "flash_" in name:
            print(f"  {us / 1e3 / n:8.3f} ms/step {calls // n:5d} calls/step  "
                  f"{name[:90]}", flush=True)
    return device_ms


def main() -> int:
    phase_device()
    sys.path.insert(0, ROOT)
    phase_build()
    records: dict = {}
    phase_mmd(records)
    phase_hsic(records)
    phase_bow(records)
    phase_scores()
    phase_flash(records)
    for preset in PATH_KERNELS:
        phase_reference(preset)
    phase_reference(FLAGSHIP, "flash")
    default = phase_path(records, FLAGSHIP, 1, "temporal_order_modification")
    torch.cuda.empty_cache()
    phase_path(records, "ec_hsic", 2, "random")
    torch.cuda.empty_cache()
    flash = phase_serve(records)
    print("flagship step b64xs96, flash vs default attention: device "
          f"{flash[0]:.2f} vs {default[0]:.2f} ms/step, peak memory of the "
          f"path {flash[1]:.2f} vs {default[1]:.2f} GiB", flush=True)
    shutil.rmtree(RUN_DIR, ignore_errors=True)
    print(json.dumps({"kernels": list(records.values())}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
