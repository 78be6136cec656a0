"""Drive the PyTorch/CUDA port (carel_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and no phase carries on after
an error:

1. device: require CUDA; print the nvidia-smi name and power limit line;
2. build: compile the hand-written kernels K1-K4 from carel_tpu_torch/csrc;
3. kernels: hold each kernel against its plain PyTorch version at the shapes
   of the training step (fp32), print errors, median times by CUDA events
   and the plain version's time;
4. reference: a tiny model takes one training step on the card (kernels) and
   on the CPU (plain versions) from the same weights and batch; loss and
   updated weights must agree;
5. main path: the flagship preset at full width (12L/768H encoder, vocab
   21,128, ec_dim 24, BoW vocab 23,808, max_len 96, batch 64) on random
   weights from a seed: init_state, one epoch of train_epochs (the best
   checkpoint saved and reloaded), evaluate; counts every kernel launch of
   that run and requires each of K1-K4 on every training step; then times
   and profiles steps after warm-up, and reloads the best from disk.

The line before the last is a JSON object with one entry per kernel; the
last line is {"ok": true, "device": {...}}.
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
PEAK_BYTES = 3.35e12

ROOT = os.path.dirname(os.path.abspath(__file__))
RUN_DIR = os.path.join(ROOT, "build", "chip_smoke")


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def relnorm(a: torch.Tensor, b: torch.Tensor) -> float:
    """Normwise relative error ||a - b|| / ||b||."""
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


def bound_ms(nbytes: float, flops: float):
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = flops / PEAK_FP32_FLOPS * 1e3
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


def phase_mmd(records: dict) -> None:
    from carel_tpu_torch.ops import cuda_pairwise as cp

    alphas = (0.1,)
    worst = {"fwd": 0.0, "bwd": 0.0}
    for B, masked in ((64, 0), (61, 3)):
        x, y, mask = mmd_inputs(B, masked)
        xk = x.clone().requires_grad_(True)
        yk = y.clone().requires_grad_(True)
        val_k = cp.mmd_statistic(xk, yk, alphas, mask)
        dxk, dyk = torch.autograd.grad(val_k, (xk, yk))
        xp = x.clone().requires_grad_(True)
        yp = y.clone().requires_grad_(True)
        val_p = cp.mmd_statistic_plain(xp, yp, alphas, mask)
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
        print(f"mmd B={B} masked={masked}: value {vk:.8e} vs "
              f"plain {vp:.8e} rel {rel:.2e}; grads normwise rel "
              f"dx {gx:.2e} dy {gy:.2e}", flush=True)
        if not rel <= 1e-5:
            fail(f"mmd forward value rel err {rel:.2e} > 1e-5")
        if not max(gx, gy) <= 1e-5:
            fail(f"mmd backward normwise rel err {max(gx, gy):.2e} > 1e-5")
        worst["fwd"] = max(worst["fwd"], err_v)
        worst["bwd"] = max(worst["bwd"], err_g)

    # times at the training shape, B = 64
    B, d = 64, 24
    x, y, mask = mmd_inputs(B, 0)
    _, n = cp.mmd_forward_kernel(x, y, mask, alphas)
    g = torch.ones((), device="cuda")
    xp = x.clone().requires_grad_(True)
    yp = y.clone().requires_grad_(True)
    val_p = cp.mmd_statistic_plain(xp, yp, alphas, mask)
    t = {
        "fwd": median_ms(lambda: cp.mmd_forward_kernel(x, y, mask, alphas)),
        "fwd_plain": median_ms(
            lambda: cp.mmd_statistic_plain(x, y, alphas, mask)),
        "bwd": median_ms(
            lambda: cp.mmd_backward_kernel(x, y, mask, n, g, alphas)),
        "bwd_plain": median_ms(lambda: torch.autograd.grad(
            val_p, (xp, yp), retain_graph=True)),
    }
    pairs = 3 * B * B
    in_bytes = 4 * (2 * B * d + B)
    # least work for the function: each row's squared norm once (2 B rows of
    # d FMA); per pair the dot product (d FMA) and the scalar work of
    # |a|^2 + |b|^2 - 2 a.b, abs, eps and, per alpha, scale and exp (forward),
    # or the coefficient (backward), then the mask and the sum
    norms = 2 * B * 2 * d
    pair_ops = 2 * d + 6 + 2 * len(alphas)
    fwd_b = bound_ms(in_bytes + 4, norms + pairs * pair_ops)
    # backward: one Gram rebuild per pair, and c * (a - b) accumulated into
    # each output row the pair reaches (2 d per output side: the xy pair
    # feeds dx_i and dy_j, a within-sample pair its own row once)
    bwd_b = bound_ms(in_bytes + 8 + 4 * 2 * B * d,
                     norms + pairs * (pair_ops + 1) + B * B * 2 * d * 4)
    for name, route_line, b, key in (
            ("mmd_fwd", 62, fwd_b, "fwd"), ("mmd_bwd", 90, bwd_b, "bwd")):
        records[name] = {
            "name": name, "route": "cuda",
            "source": "carel_tpu_torch/csrc/mmd.cu",
            "replaces": f"carel_tpu/ops/pallas_pairwise.py:{route_line}",
            "launches": 0, "max_abs_err": worst[key],
            "ms": t[key], "plain_ms": t[key + "_plain"],
            "bound_ms": b[0], "bound_by": b[1], "library_ms": None}
        print(f"{name}: {t[key]:.4f} ms (plain {t[key + '_plain']:.4f} ms, "
              f"bound {b[0]:.6f} ms by {b[1]})", flush=True)


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


def phase_bow(records: dict) -> None:
    from carel_tpu_torch.ops import cuda_bow as cb

    h, W, b, idx, wts, mask = bow_inputs()
    B, D = h.shape
    V = W.shape[0]
    leaves_k = [t.clone().requires_grad_(True) for t in (h, W, b)]
    val_k = cb.fused_bow_loss(*leaves_k, idx, wts, 0.1, mask)
    gk = torch.autograd.grad(val_k, leaves_k)
    leaves_p = [t.clone().requires_grad_(True) for t in (h, W, b)]
    val_p = cb.fused_bow_loss_plain(*leaves_p, idx, wts, 0.1, mask)
    gp = torch.autograd.grad(val_p, leaves_p, retain_graph=True)
    vk, vp = float(val_k.detach()), float(val_p.detach())
    rel = abs(vk - vp) / abs(vp)
    grel = {n: relnorm(a, c) for n, a, c in zip(("dh", "dW", "db"), gk, gp)}
    print(f"bow B={B} D={D} V={V}: value {vk:.8e} vs plain "
          f"{vp:.8e} rel {rel:.2e}; grads normwise rel "
          + " ".join(f"{n} {v:.2e}" for n, v in grel.items()), flush=True)
    if not rel <= 1e-5:
        fail(f"bow forward value rel err {rel:.2e} > 1e-5")
    if not max(grel.values()) <= 1e-4:
        fail(f"bow backward normwise rel err {max(grel.values()):.2e} > 1e-4")
    err_v = abs(vk - vp)
    err_g = max(float((a - c).abs().max()) for a, c in zip(gk, gp))

    stats = cb.bow_forward_kernel(h, W, b)
    rowp = torch.stack([stats[0], torch.zeros_like(stats[0]),
                        mask * 0.9 / (B * V), mask * 0.1 / (V * B * V),
                        mask / (B * V)]).contiguous()
    t = {
        "fwd": median_ms(lambda: cb.bow_forward_kernel(h, W, b)),
        "fwd_plain": median_ms(lambda: cb.fused_bow_loss_plain(
            h, W, b, idx, wts, 0.1, mask)),
        "bwd": median_ms(lambda: cb.bow_backward_kernel(h, W, b, rowp)),
        "bwd_plain": median_ms(lambda: torch.autograd.grad(
            val_p, leaves_p, retain_graph=True)),
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
            "max_abs_err": err_v if key == "fwd" else err_g,
            "ms": t[key], "plain_ms": t[key + "_plain"],
            "bound_ms": bnd[0], "bound_by": bnd[1], "library_ms": None}
        print(f"{name}: {t[key]:.4f} ms (plain {t[key + '_plain']:.4f} ms, "
              f"bound {bnd[0]:.6f} ms by {bnd[1]})", flush=True)


def tiny_config():
    from carel_tpu_torch.config import CarelConfig, DataConfig, LossConfig
    from carel_tpu_torch.config import ModelConfig, TrainConfig
    from carel_tpu_torch.models.encoder import tiny_encoder_config

    return CarelConfig(
        model=ModelConfig(encoder=tiny_encoder_config(vocab_size=256,
                                                      dropout=0.0),
                          ec_dim=24, bow_dim=3000, dropout=0.0),
        loss=LossConfig(),
        data=DataConfig(max_len=32),
        train=TrainConfig(batch_size=16, vae_lr=1e-3))


def phase_reference() -> None:
    """A tiny fp32 model takes one training step on the card (kernels) and on
    the CPU (plain versions) from the same weights, batch and (zero) noise."""
    from carel_tpu_torch.data.batching import cut_batch
    from carel_tpu_torch.pipeline import init_state
    from carel_tpu_torch.train.state import MAIN
    from carel_tpu_torch.train.steps import batch_to_device, make_train_step

    cfg = tiny_config()
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
    print(f"reference step (tiny fp32, card vs CPU): loss {m_g['loss']:.6f} "
          f"vs {m_c['loss']:.6f}; worst metric rel {worst_m:.2e}, grad "
          f"normwise rel {worst_g:.2e}, param abs {worst_p:.2e} "
          f"({worst_safe:.2e} where |g| > 1e-3 max|g|)", flush=True)
    # fp32 on both sides, sums in another order: metrics to 1e-4, grads to
    # 1e-3 normwise, params within Adam's sign-flip bound 2 * lr, and to
    # 1e-3 * lr where the sign is safe
    lr = cfg.train.vae_lr
    if not (worst_m <= 1e-4 and worst_g <= 1e-3 and worst_p <= 2 * lr
            and worst_safe <= 1e-3 * lr):
        fail("card and CPU disagree on the reference step")


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


class _Records:
    """Logger for train_epochs that keeps its records."""

    def __init__(self):
        self.records = []

    def log(self, record: dict) -> None:
        self.records.append(record)


def phase_main_path(records: dict) -> None:
    from carel_tpu_torch import ops
    from carel_tpu_torch.config import PRESETS, EncoderConfig
    from carel_tpu_torch.data.batching import cut_batch
    from carel_tpu_torch.pipeline import init_state
    from carel_tpu_torch.train import checkpoint as ckpt
    from carel_tpu_torch.train.loop import evaluate, train_epochs
    from carel_tpu_torch.train.steps import (batch_to_device, make_eval_step,
                                             make_train_step)

    B, L, V, n_train, n_test, unpred = 64, 96, 23808, 1024, 512, 10
    base = PRESETS["ec_mmd_final_mul_newsplit_emnlp"]
    enc = EncoderConfig(arch="bert", dtype="bfloat16")  # 12L/768H, 21,128
    cfg = dataclasses.replace(
        base,
        model=dataclasses.replace(base.model, encoder=enc, bow_dim=V),
        data=dataclasses.replace(base.data, max_len=L),
        train=dataclasses.replace(
            base.train, batch_size=B, epochs=1, self_iteration=0,
            checkpoint_dir=os.path.join(RUN_DIR, "ckpt")))
    rng = np.random.default_rng(0)
    train = synth_pair_arrays(rng, n_train, L, enc.vocab_size, V)
    test = synth_pair_arrays(rng, n_test, L, enc.vocab_size, V)
    steps = -(-n_train // B)

    t0 = time.perf_counter()
    state = init_state(cfg, "cuda")
    n_params = sum(p.numel() for p in state.model.parameters())
    print(f"main path: init_state {time.perf_counter() - t0:.1f} s, "
          f"{n_params} params", flush=True)
    train_step, eval_step = make_train_step(cfg), make_eval_step()
    logger = _Records()
    torch.cuda.reset_peak_memory_stats()

    # best_f1_so_far -1 makes the first evaluation a new best even at F1 = 0
    # (random weights), so the checkpoint save and the best reload both run
    best_cache: dict = {}
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    state, best = train_epochs(cfg, state, train_step, eval_step, train, test,
                               unpred, "chip_smoke", logger=logger,
                               best_f1_so_far=-1.0, best_cache=best_cache)
    res = evaluate(eval_step, state.model, test, unpred,
                   torch.Generator(device="cuda").manual_seed(0),
                   cfg.train.eval_batch_size)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    wall = time.perf_counter() - t0

    losses = [r["loss"] for r in logger.records if r["event"] == "train"]
    print(f"main path: {steps} steps + eval in {wall:.1f} s; losses "
          f"{losses}; best {best}; evaluate P/R/F1 {res.precision:.4f} "
          f"{res.recall:.4f} {res.f1:.4f}; launches {counts}; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    if not losses or not all(math.isfinite(x) for x in losses):
        fail(f"main path: loss not finite: {losses}")
    if res.probs.shape != (n_test,) or not np.all(np.isfinite(res.probs)) \
            or not np.all((res.probs >= 0) & (res.probs <= 1)):
        fail("main path: eval probabilities are not finite values in [0, 1]")
    for p in (res.precision, res.recall, res.f1, *best):
        if not 0.0 <= p <= 1.0:
            fail(f"main path: metric out of range: {p}")
    for name, n in counts.items():
        if n < steps:
            fail(f"main path: kernel {name} launched {n} times in {steps} "
                 "training steps")
        records[name]["launches"] = n
    if not any(r["event"] == "best" for r in logger.records):
        fail("main path: no best checkpoint was saved")
    saved = ckpt.load_best(cfg.train.checkpoint_dir, "chip_smoke",
                           torch.device("cuda"))
    if not (same_state(saved, best_cache["state_dict"])
            and same_state(state.model.state_dict(), saved)):
        fail("main path: the reloaded best differs from the saved checkpoint")

    # steady-state step time after warm-up, host clock around synchronize
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
        fail("main path: timed steps gave a non-finite loss")
    print(f"main path step b{B}xs{L}: {ms:.2f} ms/step, "
          f"{B / ms * 1e3:.1f} pairs/s", flush=True)
    profile_steps(train_step, state, batches, ms)

    # the timed steps moved the params; a train_epochs call of no epochs and
    # no in-memory cache reloads the best from disk
    if same_state(state.model.state_dict(), saved):
        fail("main path: the timed steps left the params unchanged")
    state, _ = train_epochs(cfg, state, train_step, eval_step, train, test,
                            unpred, "chip_smoke", epochs=0, logger=logger)
    if not same_state(state.model.state_dict(), saved):
        fail("main path: the reload from disk differs from the checkpoint")
    print("main path: best checkpoint saved, reloaded from memory and from "
          "disk, equal to the saved state_dict", flush=True)


def same_state(a: dict, b: dict) -> bool:
    """Two state_dicts with the same keys and bitwise equal tensors."""
    return a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)


def profile_steps(train_step, state, batches, step_ms: float,
                  n: int = 5) -> None:
    """Device time per step by kernel, from torch.profiler over n steps, and
    the device busy share against the unprofiled step time."""
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
        return
    print(f"profile ({n} steps): device kernels {device_ms:.2f} ms/step of "
          f"{step_ms:.2f} ms/step unprofiled, device busy "
          f"{device_ms / step_ms:.3f}, {sum(c for _, c in per_kernel.values()) // n} "
          "kernels/step", flush=True)
    top = sorted(per_kernel.items(), key=lambda kv: kv[1][0], reverse=True)
    for name, (us, calls) in top[:12]:
        print(f"  {us / 1e3 / n:8.3f} ms/step {calls // n:5d} calls/step  "
              f"{name[:90]}", flush=True)


def main() -> int:
    phase_device()
    sys.path.insert(0, ROOT)
    phase_build()
    records: dict = {}
    phase_mmd(records)
    phase_bow(records)
    phase_reference()
    phase_main_path(records)
    shutil.rmtree(RUN_DIR, ignore_errors=True)
    print(json.dumps({"kernels": list(records.values())}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
