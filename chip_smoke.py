"""Drive the PyTorch/CUDA port (carel_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and no phase carries on after
an error:

1. device: require CUDA; print the nvidia-smi name and power limit line;
   host: print which of tokenizers, transformers, safetensors, sklearn,
   jieba and pandas import, and whether the C ingest extension (carel_tpu_torch/native)
   builds; time zh tokenization of 20,000 synthetic pair strings on the
   host through its C path and through the Python loop (arrays equal);
2. build: compile the hand-written kernels K1-K10 from carel_tpu_torch/csrc;
3. kernels: hold each kernel against its plain PyTorch version at the shapes
   of the training step (fp32; HSIC against the plain version evaluated in
   float64, at two input scales), print errors, median times by CUDA events
   and the plain version's time; hold the encoder's fp32 attention scores
   (bf16 tensor-core GEMM with an fp32 output) against the product of the
   upcast q and k; hold the fused BoW kernels also at ragged shapes (V = 1,003
   with B = 5 and 200, and B = 300 at the full V, where the forward evaluates
   its logits twice, and at the en path's V = 40,000 with B = 64 and V =
   40,009 with B = 200, where a block owns more than one chunk of V; K3 and K4
   also timed at both) and require two runs of each to give the same
   bits; hold HSIC also at B = 1,000 (where the forward evaluates its Gram
   entries again) and at every shape require two runs of K5 and of K6 to give
   the same bits, K5 + K6 captured in one CUDA graph to replay them, and (B =
   64) one device kernel a call of each, and print K6's registers a thread;
   hold MMD also at B = 1,000 with 7 masked rows, with one alpha and with four
   (the kernels' most), and at every shape require two runs of K1 and of K2 to
   give the same bits, K1 + K2 captured in one CUDA graph to replay them, and
   (B = 64) one device kernel a call of each; hold the flash attention kernels
   K7-K9 against their plain version in fp32 (CUDA-core kernels) and bf16
   (tensor-core kernels), at the training and the inference shape, at a ragged
   tiny one, at L over one block's rows (200, 513), at hd = 128 and with pad
   tails longer than one tile of keys, at the stage-1 clause batch [300, 12,
   60, 64] with most rows all pads, the DANN batch [32, 12, 128, 64], the
   embed path's [32, 12, 200, 64] (a partly empty last tile), MLM
   pretraining's [256, 12, 64, 64] (with its backward) and the MLM
   scorer's [32, 12, 64, 64] (rows of 20-40 real tokens), with
   an all-pad row and a row without pads, in the stock and the packed layout,
   and require two runs to give the same bits; hold the BoW backward with many
   duplicate indices (K4 adds the corrections at the indices to G in a fixed
   order): bit-equal over two runs and over two replays of a CUDA graph,
   within the BoW gate of the plain version, and time what the corrections
   cost K4; hold the embeddings' backward (K10, one call for the word,
   position and token-type tables, every index's entries added in position
   order) over the zh tables at the stage-2 (64 x 96 ids), stage-1 (300 x
   60) and MLM pretraining (256 x 64) batches and over roberta-base's (50,265
   words, 514 positions, one token type) at 64 x 128, with Zipf-like word
   ids and all-zero token types: bit-equal over two runs and two graph
   replays, each table within 1e-5 normwise of index_add_, each call timed
   with its device time split by device kernel, beside torch's embedding
   backward of the three tables (whether it repeats the token types' bits
   printed); time every kernel, its plain version and, for K7-K10, the library
   call by CUDA events and by the profiler's device time per call (every
   profiled window opens and closes with spin kernels that its counts leave
   out, so that a record lost at its edge is theirs), and the
   host's cost of one launch, K7-K9 also at the stage-1, DANN, embed,
   pretrain and scorer shapes (with the library's kernel names);
   hold the routed experts' Triton kernels (ops/moe.py: the grouped
   products and their weight gradient, the gather, SwiGLU and its
   derivative, the combine, the weights' gradient) through dispatch and
   routed_experts, forward and backward, against the plain functions
   composed alike (fp32 within 1e-5, bf16 within 1e-2 normwise, every
   gradient), at ragged small shapes and at the dsv2lite_train cell's
   (128 x 96 tokens, top-6 of 64, experts 0-7 held, D 2,048, I 1,408): the
   plan drops no held choice, two runs bit-equal, each kernel launched as
   one call should by this run's launch counts; time that call beside the
   plain functions with its device time by kernel and its bound, the
   dispatch, and the forward's products beside torch._grouped_mm; hold and
   time K10 over DeepSeek-V2-Lite's one 102,400 x 2,048 table at 128 x 96
   ids; hold the xla attention core's kernel pair (ops/xla_attention.py)
   at the shapes of zh_train, zh_score, en_train and zh_pretrain and at L
   37 and 200: the keep mask bit-equal to F.dropout's draw with the
   generator at the same offset after, the output and the packed gradient
   against the kernels' arithmetic in plain ops and against the plain
   ops, one launch of each kernel a call, two runs bit-equal; time each
   kernel beside its bound, the plain ops and the library's attention;
4. reference: a tiny model takes one training step on the card (kernels) and
   on the CPU (plain versions) from the same weights, batch and noise, under
   the flagship's MMD (with the default and the flash attention), ec_hsic,
   ec_gan and ec_vi_final (with the same batch permutation and vi_beta),
   and under the flagship with each attention adapter (raw, sparsemax,
   entmax15; the batch's padded rows are all-masked attention rows, the
   adapters' key biases, whose gradient is 0 in exact arithmetic, held to
   the 2 lr bound only); loss, gradients and updated weights of every group
   must agree; likewise
   a stage-1 step under each clause mixer (the BiLSTM on cuDNN) and a DANN
   step (params and the batch norm's running statistics); and a tiny
   original 3-latent DRL step (one backward, the main Adam and the
   adversaries' RMSprop; the latent heads unchanged, the adversaries
   moved); and a tiny MLM step with flash attention (pretrain/mlm.py's
   MlmTrainer, captured on the card, the same draws injected on both);
5. main paths, each at full width (12L/768H encoder, vocab 21,128, ec_dim
   24, BoW vocab 23,808, max_len 96, batch 64) on random weights from a
   seed, on a synthetic target domain (documents of 3-12 clauses with all
   their candidate pairs): init_state, one base epoch of train_epochs (the
   best checkpoint saved and reloaded), then self_train, all through the
   default epoch step (train/scan_epoch.py: one step captured in a CUDA
   graph, replayed once a batch); one capture must serve the whole run and
   every step must be a replay; every kernel launch of that run is
   counted, with the counts set to 0 just before it (a replay counts the
   captured step's launches; the capture's warm-up, rolled back, does not),
   and the path's kernels must launch on every training step, base and
   self-training alike; then one more epoch moves the params and the best
   is reloaded from disk:
   - the flagship preset (MMD: K1-K4 and K10), one self-training iteration
     with temporal_order_modification;
   - ec_hsic (binary emotion, HSIC: K3-K6 and K10), two self-training
     iterations of one epoch each with the random strategy;
   - ec_gan (binary emotion, the discriminators and their RMSprop: K3, K4,
     K10) and ec_vi_final (the CLUB net, its Adam and the two-phase step:
     K3, K4, K10),
     one self-training iteration each with the random strategy; the disc
     params must move under ec_gan only, the club params under ec_vi_final
     only, the frozen latent heads on no path;
   - the flagship preset with attention_impl="flash" (K1-K4, K7-K10),
     train then serve: one base epoch, evaluation and the best checkpoint
     saved; the checkpoint loaded into a fresh model; run_pair_inference
     over a larger synthetic target domain of 21 batches of 512 (p50 and
     p95 over the 20 after the first), whose probabilities and P/R/F1 must
     equal evaluate's on the same model and seed; PairScorer.score_texts
     (timed, a document's six pairs and a full batch) and extract_document
     on synthetic zh strings. K7 must launch once per layer on every
     training step and every evaluation, inference and scoring batch, K8
     and K9 once per layer on every training step, and no flash kernel on
     the four paths above;
   - stage 1 (the stage1 verb's trainer) at 4 documents x 75 clauses x 60
     tokens on synthetic documents (3-75 clauses, 3-20 to test): one base epoch
     and one self-training epoch that writes the pair file, once with the
     BiLSTM, the default attention and the fresh-Adam quirk, once with the
     clause transformer, flash attention (K7-K9 once a layer on every forward)
     and a carried Adam; K10 once a step; the pair file holds the best
     snapshot's predictions and reads back through build_pairs(test=True) with
     the forced misses they give and at least one predicted pair, the best
     snapshot is a copy of the params, and three steps from one state repeat
     their bits;
   - the clause-level DANN (the dann verb's driver) at 32 clauses x 128
     tokens: one base epoch and one self-training iteration, K10 three
     times a step; the running statistics move, the gradient reversal
     sends the domain head's gradient back to the features as -lambda
     times itself, and three steps from one state repeat their bits;
   - the flagship with each attention adapter (--adapter raw with 4 heads,
     sparsemax, entmax), as the flagship path above (K1-K4 and K10 on
     every step, one capture), then the captured step timed; each
     adapter's query and weights must move, the pooler (which no adapter
     path reads) and the sparse kinds' v_proj (whose output is never used)
     stay bit-unchanged, as do the frozen latent heads;
   - the flagship with --optim_mu_dtype bfloat16 (the main Adam's first
     moment in bf16, MuDtypeAdam) likewise, timed;
   - the embed verb's trainer (train_domain_embedder) at 12L/768H bf16
     with attention_impl="flash", b32 x s200, over synthetic documents of
     four domain labels read by load_domain_docs (16 steps), then
     EncoderEmbedder over the 512 texts at batch 256: K7 once a layer on
     every forward, K8/K9 once a layer and K10 once on every step;
     the encoder dir (save_encoder) read back by load_encoder_checkpoint
     bit-equal; a step timed and profiled;
   - the cit verb's pieces: the flash path's served model scores 64
     synthetic target documents through run_pair_inference (its pair
     bias centred on the median logit), build_cit_triples over 256 source
     documents with the embed path's encoder as the embedder (max_len 64),
     then run_cit at CitConfig's defaults (s128, b32, default attention;
     the encoder started from the embed path's) for a base epoch of 16
     steps and one self-training iteration, the predictions passed in
     memory: K7 once a layer on every inference and embedder batch, K10
     once a step; refined predictions in {0, 1}, P/R/F1 in [0, 1];
     a step timed and profiled;
   - the original verb's pieces (train_original) at b64 x s96, BoW V
     23,808: a base epoch of 16 eager steps, the evaluation of 514 pairs,
     the best saved and reloaded, one self-training iteration, then 4
     steps of the --bow_loss variant: K10 once a step and nothing
     else; the six latent heads bit-unchanged, the five adversaries moved;
     a step timed and profiled;
   - the clustering tool: 4,096 synthetic clauses embedded by the embed
     path's encoder, train_idec (5 pretraining epochs, 20 refinement
     steps), emotion_cluster_chi2; profiled once;
   - the pretrain verb's trainer (pretrain_mlm) at 12L/768H bf16, vocab
     21,128, attention_impl="flash", MlmConfig's b256 x s64 over the
     clauses of synthetic documents: 16 steps in two dispatches of 8
     steps, each drawn ahead and replayed from one captured step (the
     head over its capacity of masked rows), K7-K9 once a layer and K10
     once on every step; the MLM saved (--save_mlm) and the encoder dir
     (--out) loaded into the flagship's encoder bit-equal; a second
     captured and an eager run of the seed bit-equal to the first;
     dispatches timed and profiled, the head's capacity and fill, and the
     fp32 head's share of the step over its capacity;
   - the ordering verb's pieces: MlmScorer (flash, 32 x 64 a call) over
     the saved MLM on the gold pairs of 160 synthetic documents (64 scored
     pairs or more), the verb's JSON, ms a call, K7 once a layer a call;
     eight pairs against an fp32 scorer on the CPU with the same weights;
   - case_analysis: compare_checkpoints over the flagship's and the flash
     path's best checkpoints on the 514 test pairs (flash, K7 only);
   - hpo: search over the flagship at full width, two trials of one
     captured epoch each (K1-K4 and K10 on every step);
   - the plain pair classifier (the pair verb's train_pair_classifier) at
     12L/768H, vocab 21,128, bf16, attention_impl="flash", b64 x s96 on
     the zh paths' synthetic pairs: a base epoch of 16 eager steps, its
     evaluation of 514 pairs, one threshold self-training iteration; K7
     once a layer on every forward, K8/K9 once a layer and K10 once
     on every training step; finite probabilities in [0, 1]; 16 steps
     timed and profiled;
   - en_newsplit over a roberta-base-shaped encoder (12L/768H, vocab
     50,265, 514 positions, one token type, eps 1e-5, pad id 1) loaded
     through models/hf_port.py from a local HF checkpoint written here
     (config.json and a pytorch_model.bin of random weights from seed 0),
     at b64 x s128 with BoW V 40,000, as the flagship path above (K1-K4 and
     K10 on every step, one self-training iteration with the random
     strategy); init_state must load the checkpoint bit-equal, and the
     loaded encoder in fp32 on the card must give the CPU's pooled output
     for a fixed batch within 1e-4 normwise; then the captured step takes
     three timed epochs and one profiled;
6. capture: each of the five step variants at full width, from one initial
   state, as the paths run it: one epoch of the eager per-step loop
   (prefetched, as --no_scan_epoch runs it) and one through the captured
   epoch step: per-batch losses within rel 1e-5, params within 2 x their
   lr, the generators alike, the disc, club and frozen groups moving as on
   the paths; a second eager and a second captured run from the same state
   must repeat the first epoch's losses and params bit for bit, and a third
   eager run under torch's deterministic algorithms (warn_only) must too,
   with no warning of an op without a deterministic version; the second
   runs then take three more epochs timed (the median's wall ms/step) and
   one profiled (device ms/step, busy share, kernels/step; each path kernel
   once a step, K7-K9 once a layer), with each run's peak memory; and the
   sensitivity case: the tiny flagship and vi with kl_ann_iterations 4,
   vi_beta 0 then 0.5 and the lr halved between two epochs, captured
   against eager as above; the bit checks: for the entmax adapter and for
   bf16 mu, from one state (save_state, then load_state before each run),
   eager, captured, eager and captured epochs at full width give the same
   losses, params and main-Adam state bit for bit, the main Adam's first
   moments are in the configured dtype and the club Adam is torch's (fp32
   moments); for bf16 mu a snapshot saved and resumed gives the bits of the
   epoch it repeats.

7. verbs, after every profiled phase: the train verbs themselves, each in a
   process of its own (its kernel launches counted from 0 there and logged
   on its last event) with jieba blocked (a jieba.py that raises, first on
   its PYTHONPATH), at the preset's full width (12L/768H bf16), one base
   epoch and one self-training iteration of one epoch, a state snapshot each
   epoch: verb_zh, `train --preset ec_mmd_final_mul_newsplit_emnlp` over the
   synthetic zh corpus of carel_tpu_torch/data/synthetic.py and its
   committed segmentation cache (the words must come from the cache, K1-K4
   once and K10 once on every step, one capture, a pair-F1 in the
   last line); mesh, the same under --mesh_shape 1,1 (NCCL, a world of one,
   the gathers and the gradient sum inside the captured step): every batch's
   loss and the final params bit-equal to verb_zh's; verb_en, `train
   --preset en_newsplit` over the synthetic en corpus (a WordPiece trained
   into its cache dir); bench, `python -m carel_tpu_torch.cli bench` in a
   process of its own (its launches counted from 0 there): its JSON line's
   pairs/s must be finite and positive and agree with its captured ms/step
   at batch 64, its MFU lie in (0, 100], its captured ms/step within
   [0.67, 1.5] x the capture phase's wall ms/step of the flagship, one
   capture, and K1-K4 once and K10 once on every step of each arm.

Then one line a variant and kind compares its step with the captured
flagship's (the adapter and bf16-mu paths' captured steps too, and the
pair classifier's eager step): device ms/step, kernels/step, wall ms/step with the device's
busy share, peak memory; one line for the en path's captured step; one
line each for the embed, cit, original and clustering paths (with the
nvidia-smi name and power limit); and one line each for the stage-1 and
DANN paths:
wall and device ms/step, kernels/step, documents/s or clauses/s, peak
memory.

The line before the last is a JSON object with one entry per kernel (its
``launches`` is the sum over the main paths, ``launches_by_path`` splits
it); the last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import shutil
import subprocess
import sys
import time
from typing import Optional

import numpy as np
import torch

# H100 SXM peaks (NVIDIA data sheet, dense, at a 700 W power limit); fp64 at
# the tensor cores' rate, the card's fastest for double, for the kernels that
# work in double
PEAK_FP32_FLOPS = 67e12
PEAK_FP64_FLOPS = 67e12
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


# windows that device_profile and profile_epoch profiled, those without a
# device event, the epochs whose profile missed a path kernel's launch; the
# windows with work that device_events read, those of them that lost a
# guard's record, and the guards' records lost
PROFILE_WINDOWS = {"profiled": 0, "empty": 0, "short": 0, "guarded": 0,
                   "guard_lost": 0, "guards_lost": 0}

# every profiled window opens and closes with GUARD_KERNELS spin kernels of
# torch.cuda._sleep (GUARD_CYCLES each, ~50 us at 1.98 GHz), which its
# counts leave out: a record that the profiler loses at a window's edge is
# then a guard's, not the work's (without them one run lost the first
# flash_fwd of every window of the captured flash epoch, another none)
GUARD_KERNELS = 200
GUARD_CYCLES = 100_000
GUARD_NAME = "spin_kernel"


def guard() -> None:
    for _ in range(GUARD_KERNELS):
        torch.cuda._sleep(GUARD_CYCLES)


@contextlib.contextmanager
def guarded_profile():
    """torch.profiler over the CUDA activity, the body's work between two
    runs of guard(); the body ends with a synchronize. Read the kernels
    with device_events."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        guard()
        yield prof
        guard()
        torch.cuda.synchronize()


def device_events(prof) -> list:
    """The device kernels and copies of a guarded_profile, without the
    guards and the user annotations (mirrored on the device timeline, they
    span other kernels); the guards' records lost are counted (where in
    the window is not known: the records' times put some of the work among
    the first guards)."""
    from torch.autograd import DeviceType

    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA
              and not getattr(e, "is_user_annotation", False)]
    work = [e for e in events if GUARD_NAME not in e.name]
    if work:
        lost = 2 * GUARD_KERNELS - (len(events) - len(work))
        PROFILE_WINDOWS["guarded"] += 1
        PROFILE_WINDOWS["guard_lost"] += lost > 0
        PROFILE_WINDOWS["guards_lost"] += lost
    return work


def device_profile(fn, iters: int = 30, warmup: int = 5):
    """(device ms, device kernels) of one call of fn: the summed duration
    and the number of the device kernels (and device copies) that
    torch.profiler records over iters calls, divided by iters. Unlike an
    event pair around a Python call the time holds nothing of the host's
    work between launches. The profiler now and then records no device
    event at all over a window; such a window is profiled again, up to
    three windows in all, and counted in PROFILE_WINDOWS, which main
    prints, so that a rising rate shows."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for window in range(1, 4):
        with guarded_profile() as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        spans = [e.time_range.elapsed_us() for e in device_events(prof)]
        PROFILE_WINDOWS["profiled"] += 1
        if spans and sum(spans) > 0:
            return sum(spans) / 1e3 / iters, len(spans) / iters
        PROFILE_WINDOWS["empty"] += 1
        print(f"device_profile: the profiler recorded no device time in "
              f"window {window} of 3", flush=True)
    fail("device_profile: the profiler recorded no device time")


def device_kernel_names(fn) -> list:
    """The names, cut to 120 characters, of the device kernels one call of
    fn launches, as torch.profiler records them (which backend a library
    call picked); a window with no device event is profiled again, up to
    three in all, as in device_profile."""
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with guarded_profile() as prof:
            fn()
            torch.cuda.synchronize()
        names = sorted({e.name[:120] for e in device_events(prof)})
        if names:
            return names
    return ["(the profiler recorded no device event)"]


def device_ms(fn, iters: int = 30, warmup: int = 5) -> float:
    """Device time of one call of fn (see device_profile)."""
    return device_profile(fn, iters, warmup)[0]


def kernel_label(name: str) -> str:
    """A device kernel's name without its namespaces and return type, cut
    to 70 characters (enough to tell torch's fill from its subtraction)."""
    for noise in ("void ", "(anonymous namespace)::", "at::native::",
                  "at_cuda_detail::cub::", "at_cuda_detail::"):
        name = name.replace(noise, "")
    return name[:70]


def device_split(fn, iters: int = 30, warmup: int = 5) -> dict:
    """{kernel_label of a device kernel: device ms a call} of fn over iters
    calls, from the profiler, in the order of first launch."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with guarded_profile() as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    PROFILE_WINDOWS["profiled"] += 1
    split: dict = {}
    for e in device_events(prof):
        label = kernel_label(e.name)
        split[label] = (split.get(label, 0.0)
                        + e.time_range.elapsed_us() / 1e3 / iters)
    return split


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


HOST_LIBRARIES = ("tokenizers", "transformers", "safetensors", "sklearn",
                  "jieba", "pandas")


def phase_host() -> None:
    """Which optional host libraries import here and whether the C ingest
    extension builds; then zh tokenization of a synthetic corpus of pair
    strings through the C path and through the Python loop, timed on the
    host (the arrays must be equal)."""
    import importlib

    from carel_tpu_torch.data.tokenizer import BaseTokenizer, ZhCharTokenizer
    from carel_tpu_torch.native import build as native_build
    from carel_tpu_torch.native.fast_tokenizer import native_encode_batch

    found = {}
    for name in HOST_LIBRARIES:
        try:
            importlib.import_module(name)
            found[name] = True
        except ImportError:
            found[name] = False
    t0 = time.perf_counter()
    built = native_build.load_fastingest() is not None
    print(f"host libraries: {json.dumps(found)}; C ingest extension built: "
          f"{built} in {time.perf_counter() - t0:.2f} s"
          + ("" if built else f" ({native_build.last_error})"), flush=True)
    rng = np.random.default_rng(0)
    chars = np.asarray(ZH_CHARS[:3000])
    n, max_len = 20000, 96
    texts = ["".join(chars[rng.integers(0, len(chars), rng.integers(8, 40))])
             + "[SEP]"
             + "".join(chars[rng.integers(0, len(chars), rng.integers(8, 40))])
             for _ in range(n)]
    tok = ZhCharTokenizer.from_corpus(texts)
    times = {}
    for name, fn in (("python", lambda: BaseTokenizer.encode_batch(
            tok, texts, max_len)),
                     ("c", lambda: native_encode_batch(tok, texts, max_len))):
        if name == "c" and not built:
            continue
        runs = []
        for _ in range(3):
            t0 = time.perf_counter()
            out = fn()
            runs.append(time.perf_counter() - t0)
        times[name] = (min(runs), out)
    line = (f"ingest: {n} zh pair strings tokenized to {max_len} ids on the "
            f"host: Python loop {times['python'][0]:.4f} s")
    if "c" in times:
        want = times["python"][1]
        got = times["c"][1]
        if not (np.array_equal(got[0], want.input_ids)
                and np.array_equal(got[1], want.attention_mask)):
            fail("ingest: the C path's arrays differ from the Python loop's")
        line += (f", C path {times['c'][0]:.4f} s "
                 f"({times['python'][0] / times['c'][0]:.1f}x), arrays "
                 f"equal")
    print(line + " (best of 3)", flush=True)


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


def replays_bit_equal(launch, fill: float = 0.0) -> bool:
    """launch() captured in one CUDA graph and replayed twice: True if each
    replay writes the bits that the eager call returned (into outputs
    filled with ``fill`` first: NaN shows an element a replay leaves)."""
    want = [t.clone() for t in launch()]
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = launch()
    same = True
    for _ in range(2):
        for t in got:
            t.fill_(fill)
        graph.replay()
        torch.cuda.synchronize()
        same = same and all(torch.equal(u, v) for u, v in zip(got, want))
    return same


def mmd_graph_replay(x, y, mask, alphas) -> bool:
    """K1 and K2 captured together in one CUDA graph and replayed twice:
    True if each replay writes the bits of the eager calls."""
    from carel_tpu_torch.ops import cuda_pairwise as cp

    g = torch.full((), 0.5, device="cuda")

    def both():
        out, res = cp.mmd_forward_kernel(x, y, mask, alphas)
        grads = cp.mmd_backward_kernel(x, y, mask, res, g, alphas)
        return (out, res, *grads)

    return replays_bit_equal(both)


def hsic_graph_replay(x, y, mask, s_x, s_y) -> bool:
    """K5 and K6 captured together in one CUDA graph and replayed twice:
    True if each replay writes the bits of the eager calls."""
    from carel_tpu_torch.ops import cuda_pairwise as cp

    g = torch.full((), 0.5, device="cuda")

    def both():
        out, res = cp.hsic_forward_kernel(x, y, mask, s_x, s_y)
        grads = cp.hsic_backward_kernel(x, y, mask, s_x, s_y, res, g)
        return (out, res, *grads)

    return replays_bit_equal(both)


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
    from carel_tpu_torch.ops import cuda_pairwise as cp, native

    s_x = s_y = 1.0  # hsic_sigma of the ec_hsic preset
    worst = {"fwd": 0.0, "bwd": 0.0}
    # B = 1,000: K5's multi-block path, entries evaluated again; the widths
    # other than 24 reach K6's other instances (8, 16, 32 coordinates)
    cases = [(B, masked, 24) for B, masked in ((64, 0), (61, 3), (1000, 7))]
    cases += [(B, masked, d) for d in (1, 8, 13, 17, 32)
              for B, masked in ((64, 0), (61, 3))]
    for scale in (HSIC_SPREAD, HSIC_TIGHT):
        for B, masked, d in cases:
            x, y, mask = hsic_inputs(B, masked, scale, d)
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
                fail(f"hsic B={B} d={d}: two runs of the forward kernel "
                     "differ")
            g = torch.full((), 0.5, device="cuda")
            grads = [cp.hsic_backward_kernel(x, y, mask, s_x, s_y, res, g)
                     for _, res in runs]
            if not all(torch.equal(u, v) for u, v in zip(*grads)):
                fail(f"hsic B={B} d={d}: two runs of the backward kernel "
                     "differ")
            if not hsic_graph_replay(x, y, mask, s_x, s_y):
                fail(f"hsic B={B} d={d}: the CUDA-graph replay of K5 + K6 "
                     "differs from the eager calls")
            print(f"hsic scale={scale} B={B} masked={masked} d={d}: value "
                  f"{vk:.8e} vs plain float64 {vp:.8e} rel {rel:.2e}; "
                  f"grads normwise rel dx {gx:.2e} dy {gy:.2e} (plain fp32 "
                  f"vs float64: value {rel32:.2e}, grads {g32:.2e}); two "
                  "forward and two backward runs bit-equal; K5 + K6 "
                  "replayed from a CUDA graph bit-equal", flush=True)
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
    # times its row sum. Bytes: the inputs and outputs of the function; K5's
    # residuals are how the port splits it, not what it needs.
    norms = 2 * B * 2 * d
    half = B * (B - 1) // 2
    grams = 2 * half * (2 * d + 5) + half * 2 * 2
    in_bytes = 4 * (2 * B * d + B)
    work = {"fwd": (in_bytes + 4, norms + grams + half * 2 + 4 * B),
            "bwd": (in_bytes + 4 + 4 * 2 * B * d,
                    norms + grams + half * 2 * (5 + 2)
                    + 2 * B * (B - 1) * 2 * d + 2 * B * 2 * d)}
    print("hsic least work: " + "; ".join(
        f"{k} {nb} bytes, {fl} FLOP in double" for k, (nb, fl) in
        work.items()), flush=True)
    for key in ("fwd", "bwd"):
        if round(t[key]["kernels_per_call"]) != 1:
            fail(f"hsic {key}: {t[key]['kernels_per_call']:g} device kernels "
                 "a call, want 1")
    for name, (regs, stack, spills) in sorted(native.ptxas_resources(
            native.build_report("hsic")).items()):
        if "hsic_bwd_kernel" in name:
            print(f"ptxas: {name}: {regs} registers, {stack} bytes of stack, "
                  f"{spills} bytes spilled", flush=True)
    fwd_b, bwd_b = (bound_ms(*work[k], PEAK_FP64_FLOPS) for k in ("fwd",
                                                                  "bwd"))
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


def bow_corrections(idx: torch.Tensor):
    """(safe indices, corrections) [B, T] as the BoW backward hands them to
    K4: the indices with 0 where a slot is empty, and normal values of std
    1e-4 from a seed where it is not, 0 where it is."""
    valid = idx >= 0
    gen = torch.Generator(device="cuda").manual_seed(3)
    corr = torch.randn(idx.shape, device="cuda", generator=gen) * 1e-4
    return (torch.where(valid, idx, 0).long().contiguous(),
            torch.where(valid, corr, 0.0).contiguous())


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
    safe, corr = bow_corrections(idx)
    if not all(torch.equal(u, v) for u, v in zip(
            cb.bow_backward_kernel(h, W, b, rowp, safe, corr),
            cb.bow_backward_kernel(h, W, b, rowp, safe, corr))):
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


def bow_times(B: int, V: int, val_p=None, leaves_p=None) -> dict:
    """K3 and K4 timed at (B, V) beside the plain version, with their
    bounds."""
    from carel_tpu_torch.ops import cuda_bow as cb

    h, W, b, idx, wts, mask = bow_inputs(B=B, V=V)
    if val_p is None:
        leaves_p = [t.clone().requires_grad_(True) for t in (h, W, b)]
        val_p = cb.fused_bow_loss_plain(*leaves_p, idx, wts, 0.1, mask)
    D, T = h.shape[1], idx.shape[1]
    rowp = bow_rowp(cb.bow_forward_kernel(h, W, b), mask, V)
    safe, corr = bow_corrections(idx)
    t = {
        "fwd": timed(lambda: cb.bow_forward_kernel(h, W, b),
                     lambda: cb.fused_bow_loss_plain(h, W, b, idx, wts, 0.1,
                                                     mask)),
        # as the backward calls it: with the corrections at the indices
        "bwd": timed(lambda: cb.bow_backward_kernel(h, W, b, rowp, safe,
                                                    corr),
                     lambda: torch.autograd.grad(val_p, leaves_p,
                                                 retain_graph=True)),
    }
    zflops = 2 * B * D * V
    w_bytes = 4 * (V * D + V)
    # least work for the function: one z evaluation and ~8 elementwise
    # operations per logit (forward); z, dW and dh products and ~10 per
    # logit (backward)
    fwd_b = bound_ms(w_bytes + 4 * B * D + 4 * 4 * B, zflops + 8 * B * V)
    # the backward also reads the corrections and their indices once
    bwd_b = bound_ms(2 * w_bytes + 2 * 4 * B * D + 4 * 5 * B + 12 * B * T,
                     3 * zflops + 10 * B * V)
    for key, bnd in (("fwd", fwd_b), ("bwd", bwd_b)):
        t[key].update(B=B, V=V, bound_ms=bnd[0], bound_by=bnd[1])
    return t


# the en vocabulary of the roberta-base path: 40,000 columns are 157 chunks
# of 256 on 132 SMs, so a block owns more than one chunk
EN_BOW_V = 40000


def phase_bow(records: dict) -> None:
    # the training shape, then ragged ones: V no multiple of anything with a
    # few and with many rows, and more rows than the forward keeps on chip;
    # then the en path's vocabulary and a ragged V past it
    err_v, err_g, (val_p, leaves_p) = bow_case(64, 23808, 4)
    for B, V in ((5, 1003), (200, 1003), (300, 23808), (64, EN_BOW_V),
                 (200, EN_BOW_V + 9)):
        ev, eg, _ = bow_case(B, V, 1 if B != 64 else 4)
        err_v, err_g = max(err_v, ev), max(err_g, eg)

    t = bow_times(64, 23808, val_p, leaves_p)
    t_en = {(B, V): bow_times(B, V) for B, V in ((64, EN_BOW_V),
                                                 (200, EN_BOW_V + 9))}
    for name, line, key in (("bow_fwd", 52, "fwd"), ("bow_bwd", 119, "bwd")):
        records[name] = {
            "name": name, "route": "cuda",
            "source": "carel_tpu_torch/csrc/bow.cu",
            "replaces": f"carel_tpu/ops/pallas_bow.py:{line}",
            "launches": 0,
            "max_abs_err": err_v if key == "fwd" else err_g, **t[key],
            "en_vocab": [r[key] for r in t_en.values()]}
        print_times(name, records[name])
        for (B, V), r in t_en.items():
            print_times(f"{name} at B={B} V={V}", r[key])


def dup_bow_inputs(words: int, B=64, T=128, seed=9):
    """BoW indices and weights of rows of 8-48 terms drawn from only
    ``words`` words, with repeats inside a row: each index is shared by
    many rows (up to ~50 entries an index at words = 40)."""
    rng = np.random.default_rng(seed + words)
    idx = np.full((B, T), -1, np.int64)
    wts = np.zeros((B, T), np.float32)
    for r in range(B):
        k = int(rng.integers(8, 48))
        idx[r, :k] = rng.integers(0, words, k)
        cnt = rng.integers(1, 4, size=k).astype(np.float32)
        wts[r, :k] = cnt / cnt.sum()
    return (torch.tensor(idx, device="cuda"),
            torch.tensor(wts, device="cuda"))


def phase_bow_corrections(records: dict) -> None:
    """The backward's corrections at the BoW indices, which K4 adds to G
    in a fixed order (row by row, t ascending): with many duplicate indices
    (few words) and with the training vocabulary, the whole backward must
    give the same bits over two runs and over two replays of a CUDA graph
    of the forward and backward, and stay within the existing 1e-4 normwise
    gate of the plain version. Then what they cost K4 at the training
    shape, beside the index_add_ pair and product they replace."""
    from carel_tpu_torch.ops import cuda_bow as cb

    # the training batch, and 100 rows (two groups of K4's 64 rows)
    for B, words in ((64, 40), (64, 23808), (100, 40)):
        h, W, b, _, _, mask = bow_inputs(B=B)
        idx, wts = dup_bow_inputs(words, B=B)
        leaves = [t.clone().requires_grad_(True) for t in (h, W, b)]

        def grads():
            return torch.autograd.grad(
                cb.fused_bow_loss(*leaves, idx, wts, 0.1, mask), leaves)

        first = grads()
        if not all(torch.equal(u, v) for u, v in zip(first, grads())):
            fail(f"bow corrections (B={B}, {words} words): two backward "
                 "runs differ")
        if not replays_bit_equal(grads):
            fail(f"bow corrections (B={B}, {words} words): graph replays "
                 "differ from the eager backward")
        plain = [t.clone().requires_grad_(True) for t in (h, W, b)]
        gp = torch.autograd.grad(
            cb.fused_bow_loss_plain(*plain, idx, wts, 0.1, mask), plain)
        rel = {n: relnorm(a, c) for n, a, c in zip(("dh", "dW", "db"),
                                                   first, gp)}
        runs = torch.unique(idx[idx >= 0], return_counts=True)[1]
        print(f"bow corrections, B={B}, {words} words ({int(runs.max())} "
              f"entries at most an index): backward normwise rel "
              + " ".join(f"{n} {v:.2e}" for n, v in rel.items())
              + "; two runs and two graph replays bit-equal", flush=True)
        if not max(rel.values()) <= 1e-4:
            fail(f"bow corrections: normwise rel err {max(rel.values()):.2e}"
                 " > 1e-4")

    # what the corrections cost at the training shape: K4 with them against
    # K4 with the same slots all 0 (each passed over, so G stays the dense
    # part), and the index_add_ pair and product they replace
    h, W, b, idx, wts, mask = bow_inputs()
    B, D = h.shape
    V = W.shape[0]
    rowp = bow_rowp(cb.bow_forward_kernel(h, W, b), mask, V)
    safe, corr = bow_corrections(idx)
    zeros = torch.zeros_like(corr)
    with_corr = cb.bow_backward_kernel(h, W, b, rowp, safe, corr)
    dense = cb.bow_backward_kernel(h, W, b, rowp, safe, zeros)
    flat = safe.reshape(-1)

    def replaced():  # the backward's former corrections
        dW = dense[0].index_add_(0, flat, (corr[:, :, None] * h[:, None, :])
                                 .reshape(-1, D))
        db = dense[1].index_add_(0, flat, corr.reshape(-1))
        return dW, db, torch.einsum("bt,btd->bd", corr, W[safe])

    want = [t.clone() for t in dense]
    want[0].index_add_(0, flat, (corr[:, :, None] * h[:, None, :])
                       .reshape(-1, D))
    want[1].index_add_(0, flat, corr.reshape(-1))
    want[2] += torch.einsum("bt,btd->bd", corr, W[safe])
    fold_err = max(relnorm(a, c) for a, c in zip(with_corr, want))
    if not fold_err <= 1e-5:
        fail(f"K4's corrections off index_add_ by {fold_err:.2e} normwise")
    costs = {
        "with": device_profile(lambda: cb.bow_backward_kernel(
            h, W, b, rowp, safe, corr)),
        "without": device_profile(lambda: cb.bow_backward_kernel(
            h, W, b, rowp, safe, zeros)),
        "replaced": device_profile(replaced)}
    rec = records["bow_bwd"]
    rec.update(corrections_device_ms=costs["with"][0] - costs["without"][0],
               without_corrections_device_ms=costs["without"][0],
               replaced_corrections_device_ms=costs["replaced"][0],
               replaced_corrections_kernels=costs["replaced"][1])
    print(f"bow corrections at B={B} T={idx.shape[1]} "
          f"({int((idx >= 0).sum())} entries): K4 with them "
          f"{costs['with'][0]:.4f} ms, with them all 0 "
          f"{costs['without'][0]:.4f} ms "
          f"(device, {costs['with'][1]:g} and {costs['without'][1]:g} "
          f"kernels); the index_add_ pair and product they replace "
          f"{costs['replaced'][0]:.4f} ms in {costs['replaced'][1]:g} "
          f"kernels; K4's dW, db, dh vs dense + index_add_ normwise "
          f"{fold_err:.2e}", flush=True)


# the zh tables: 21,128 words, 512 positions, two token types; roberta-base's
# (config.json of the model card): 50,265 words, 514 positions, one type
ZH_EMB_ROWS = (21128, 512, 2)
ROBERTA_ROWS = (50265, 514, 1)
EMB_D = 768


def emb_batch(B: int, L: int, rows: tuple, layout: str, seed: int):
    """The three tables' ids [B * L] as the encoder hands them to K10, and g
    [B * L, 768]: Zipf-like word ids (a few in long runs), the positions
    (bert: 0..L-1 in every row; roberta: cumsum(mask) * mask + 1, the pad
    id 1, over rows of 16 to L tokens) and all-zero token types (one run
    across every chunk)."""
    rng = np.random.default_rng(seed)
    words = np.minimum(rng.zipf(1.3, (B, L)) - 1, rows[0] - 1)
    if layout == "roberta":
        mask = np.arange(L)[None, :] < rng.integers(16, L + 1, B)[:, None]
        pos = np.cumsum(mask, axis=1) * mask + 1
    else:
        pos = np.tile(np.arange(L), (B, 1))
    ids = [torch.tensor(a.reshape(-1), dtype=torch.long, device="cuda")
           for a in (words, pos, np.zeros((B, L), np.int64))]
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return ids, torch.randn(B * L, EMB_D, device="cuda", generator=gen)


def emb_case(tag: str, B: int, L: int, rows: tuple, layout: str):
    """K10, one call over the three tables of one batch: two runs and two
    graph replays (into NaN) bit-equal, each table within 1e-5 normwise of
    index_add_; whether three runs of torch's embedding backward repeat the
    token types' bits (printed); the call timed beside the plain version
    (three index_add_s) and torch's embedding backward of the three tables
    (what the parent's path would have without K10), its device time split
    by device kernel, its bound. Returns (times, the largest absolute
    error)."""
    import torch.nn.functional as F

    from carel_tpu_torch.ops import cuda_embedding as ce

    n = B * L
    ids, g = emb_batch(B, L, rows, layout, seed=n)

    def kernel():
        return ce.embeddings_backward_kernel(ids, g, rows)

    first = kernel()
    if not all(torch.equal(a, b) for a, b in zip(first, kernel())):
        fail(f"embedding backward ({tag}): two runs differ")
    if not replays_bit_equal(lambda: tuple(kernel()), fill=float("nan")):
        fail(f"embedding backward ({tag}): graph replays differ")
    want = ce.embeddings_backward_plain(ids, g, rows)
    rels = [relnorm(a, b) for a, b in zip(first, want)]
    err = max(float((a - b).abs().max()) for a, b in zip(first, want))
    if not max(rels) <= 1e-5:
        fail(f"embedding backward ({tag}) off index_add_ by {rels}")
    ws = [torch.randn(V, EMB_D, device="cuda", requires_grad=True)
          for V in rows]
    out = F.embedding(ids[0], ws[0]) + F.embedding(ids[1], ws[1])
    out = out + F.embedding(ids[2], ws[2])

    def library():
        return torch.autograd.grad(out, ws, g, retain_graph=True)

    types = [library()[2] for _ in range(3)]
    torch_same = all(torch.equal(types[0], t) for t in types[1:])
    t = timed(kernel, lambda: ce.embeddings_backward_plain(ids, g, rows),
              library)
    t["split"] = device_split(kernel)
    t["ids"], t["rows"] = n, list(rows)
    # the ids and g read once, every row of the three dWs written once; an
    # add per element of g and table
    t["bound_ms"], t["bound_by"] = bound_ms(
        8 * n * len(rows) + 4 * n * EMB_D + 4 * EMB_D * sum(rows),
        len(rows) * n * EMB_D)
    longest = int(torch.bincount(ids[0]).max())
    print(f"emb_bwd {tag} ({n} ids, tables of {rows} rows, {longest} "
          f"entries at most a word): two runs and two graph replays "
          f"bit-equal; vs index_add_ normwise {', '.join(f'{r:.2e}' for r in rels)}; "
          f"three runs of torch's embedding backward repeat the token "
          f"types' bits: {torch_same}", flush=True)
    print_times(f"emb_bwd ({tag})", t)
    print(f"emb_bwd ({tag}) device ms a call by kernel: " + ", ".join(
        f"{k} {v:.4f}" for k, v in t["split"].items())
          + f"; torch's embedding backward {t['library_device_ms']:.4f} "
          f"device ms", flush=True)
    return t, err


def phase_embedding(records: dict) -> None:
    """K10, the embeddings' backward in a fixed order, one call for the word,
    position and token-type tables, as emb_case holds it: over the zh tables
    at the stage-2 batch (64 x 96 ids), the stage-1 batch (300 x 60) and MLM
    pretraining's (256 x 64), and over roberta-base's at the en path's
    batch (64 x 128, roberta_tables)."""
    times, err = {}, 0.0
    for B, L in ((64, 96), (300, 60), (256, 64)):
        times[B * L], e = emb_case(f"zh {B}x{L}", B, L, ZH_EMB_ROWS, "bert")
        err = max(err, e)
    roberta, err_r = roberta_tables()
    records["emb_bwd"] = {
        "name": "emb_bwd", "route": "cuda",
        "source": "carel_tpu_torch/csrc/embedding.cu",
        "replaces": "carel_tpu/models/encoder.py:132, :134, :140 (nn.Embed; XLA's "
                    "scatter-add of its gather, no Pallas kernel)",
        "launches": 0, "max_abs_err": max(err, err_r), **times[64 * 96],
        "stage1_batch": times[300 * 60], "pretrain_batch": times[256 * 64],
        "roberta_tables": roberta}


def roberta_tables():
    """K10 at the en path's batch (64 x 128 ids) over roberta-base's three
    tables in one call, with the ids the encoder gives it (RoBERTa's
    positions, the one-row token-type table), held and timed as emb_case
    does. Returns (times, the largest absolute error)."""
    return emb_case("roberta-base 64x128", 64, 128, ROBERTA_ROWS, "roberta")


# the routed experts at DeepSeek-V2-Lite's widths as the dsv2lite_train cell
# runs them: 128 x 96 tokens, top-6 of 64 experts, experts 0-7 held
MOE_SHAPE = dict(T=128 * 96, k=6, E=64, first=0, held=8, D=2048, I=1408)
# ragged small shapes: a held range inside the router's, and a token count
# far below one tile
MOE_SMALL = dict(T=37, k=3, E=8, first=2, held=4, D=64, I=48)
MOE_TINY = dict(T=5, k=3, E=8, first=0, held=8, D=64, I=48)
MOE_NAMES = ("out", "dx", "dweights", "dgate_up", "ddown")
# normwise against the plain functions: fp32 reads ~3e-7 (the products in
# IEEE fp32); bf16 reads up to 4.2e-3 (dgate_up, ddown: the plain version's
# autograd rounds its fp32 sums at other points), while one wrong row of
# the cell's ~9,100 reads ~1e-2 and a wrong expert or tile O(1)
MOE_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
# launches of one forward + backward of routed_experts by kernel
MOE_LAUNCHES = {"expert_gemm": 4, "expert_gemm_wgrad": 2, "moe_gather": 3,
                "moe_swiglu": 2, "moe_swiglu_bwd": 1, "moe_combine": 2,
                "moe_row_dot": 1}
# DeepSeek-V2-Lite's one embedding table, for K10 over the cell's ids
DSV2_EMB_ROWS, DSV2_EMB_D = 102400, 2048


def moe_problem(T, k, E, first, held, D, I, dtype, seed=0):
    """Tokens, the gate's top-k (weights fp32, ids over all E experts), the
    held experts' fp32 weights and an output gradient, on the card."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(T, D, generator=g, device="cuda").to(dtype)
    gate = torch.randn(E, D, generator=g, device="cuda") / D ** 0.5
    w, ids = torch.topk(torch.softmax(x.float() @ gate.T, -1), k, dim=-1)
    wgu = torch.randn(held, 2 * I, D, generator=g, device="cuda") / D ** 0.5
    wd = torch.randn(held, D, I, generator=g, device="cuda") / I ** 0.5
    gy = torch.randn(T, D, generator=g, device="cuda").to(dtype)
    return x, w, ids, wgu, wd, gy


def moe_plain_routed(x, w, plan, wgu, wd):
    """The plain functions of ops/moe.py composed as routed_experts composes
    its kernels, with autograd for the backward."""
    from carel_tpu_torch.ops import moe

    k = plan.choice_rows.shape[1]
    xp = moe.gather_rows_plain(x, plan, k)
    h = moe.expert_gemm_plain(xp, wgu.to(x.dtype), plan)
    y = moe.expert_gemm_plain(moe.swiglu_plain(h), wd.to(x.dtype), plan)
    return moe.combine_plain(y, plan, w, x.dtype)


def moe_grads(fn, x, w, wgu, wd, gy) -> list:
    """[output, dx, dweights, dgate_up, ddown] of fn(x, w, wgu, wd)."""
    leaves = [t.detach().clone().requires_grad_(True)
              for t in (x, w, wgu, wd)]
    out = fn(*leaves)
    out.backward(gy)
    return [out.detach()] + [t.grad for t in leaves]


def moe_plan_exact(tag: str, plan, ids, first: int, held: int) -> int:
    """The dispatch drops no token: every choice of a held expert has a row
    of its own that points back at it, in a tile of its expert, no other
    row points at a choice, and the counts are the choices'. Returns the
    held rows."""
    from carel_tpu_torch.ops import moe

    flat = ids.reshape(-1).long() - first
    is_held = (flat >= 0) & (flat < held)
    rows = plan.choice_rows.reshape(-1)
    n = int(is_held.sum())
    held_rows = rows[is_held]
    choice = torch.arange(flat.numel(), device=flat.device)[is_held]
    ok = (bool(((rows >= 0) == is_held).all())
          and int(torch.unique(held_rows).numel()) == n
          and bool((plan.row_choice[held_rows] == choice).all())
          and int((plan.row_choice >= 0).sum()) == n
          and torch.equal(plan.counts,
                          torch.bincount(flat[is_held], minlength=held))
          and bool((plan.tile_expert.long()[held_rows // moe.BLOCK_M]
                    == flat[is_held]).all()))
    if not ok:
        fail(f"moe dispatch ({tag}): a held choice lost its row or the plan "
             "is inconsistent")
    return n


def moe_case(tag: str, shape: dict, dtype, seed: int = 0) -> dict:
    """dispatch and routed_experts, forward and backward, against the plain
    functions at shape: the plan exact, the output and every gradient
    within MOE_TOL normwise, two runs bit-equal, and each kernel launched
    as MOE_LAUNCHES says, by the launch counts of this run."""
    from carel_tpu_torch import ops
    from carel_tpu_torch.ops import moe

    x, w, ids, wgu, wd, gy = moe_problem(**shape, dtype=dtype, seed=seed)
    first, held = shape["first"], shape["held"]
    plan = moe.dispatch(ids, first, held)
    n = moe_plan_exact(tag, plan, ids, first, held)

    def kernels(x, w, wgu, wd):
        return moe.routed_experts(x, w, plan, wgu, wd)

    ops.reset_launch_counts()
    got = moe_grads(kernels, x, w, wgu, wd, gy)
    torch.cuda.synchronize()
    launched = {k: v for k, v in ops.launch_counts().items()
                if k in MOE_LAUNCHES}
    if launched != MOE_LAUNCHES:
        fail(f"moe ({tag}): launches {launched}, want {MOE_LAUNCHES}")
    again = moe_grads(kernels, x, w, wgu, wd, gy)
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        fail(f"moe ({tag}): two runs differ")
    want = moe_grads(lambda *a: moe_plain_routed(*a[:2], plan, *a[2:]),
                     x, w, wgu, wd, gy)
    rels = {name: relnorm(a.float(), b.float())
            for name, a, b in zip(MOE_NAMES, got, want)}
    if not max(rels.values()) <= MOE_TOL[dtype]:
        fail(f"moe ({tag}): off the plain functions by {rels} (limit "
             f"{MOE_TOL[dtype]})")
    counts = plan.counts.tolist()
    print(f"moe {tag} ({str(dtype)[6:]}, T {shape['T']}, top-{shape['k']} "
          f"of {shape['E']}, experts {first}-{first + held - 1}, D "
          f"{shape['D']}, I {shape['I']}): {n} held rows in a buffer of "
          f"{plan.rows} ({counts.count(0)} experts with none), none "
          f"dropped; two runs bit-equal; vs the plain functions normwise "
          + ", ".join(f"{k} {v:.2e}" for k, v in rels.items())
          + f"; kernels a call {launched}", flush=True)
    return {"rel": rels, "held_rows": n, "buffer_rows": plan.rows}


def moe_times() -> dict:
    """routed_experts' forward + backward at MOE_SHAPE in bf16, timed as
    ``timed`` times a kernel beside the plain functions, its device time
    split by kernel, its least work (the products' FLOPs at the bf16 peak;
    the held weights and the rows once a pass); the dispatch; and the
    forward's two products beside torch._grouped_mm over the same rows
    packed without padding where this torch has it (a yardstick only: the
    port never calls it)."""
    from carel_tpu_torch.ops import moe

    sh = MOE_SHAPE
    x, w, ids, wgu, wd, gy = moe_problem(**sh, dtype=torch.bfloat16)
    plan = moe.dispatch(ids, sh["first"], sh["held"])
    rows = int(plan.counts.sum())
    D, I, held = sh["D"], sh["I"], sh["held"]
    leaves = [t.detach().clone().requires_grad_(True)
              for t in (x, w, wgu, wd)]

    def kernel():
        moe.routed_experts(leaves[0], leaves[1], plan, leaves[2],
                           leaves[3]).backward(gy)

    def plain():
        moe_plain_routed(*leaves[:2], plan, *leaves[2:]).backward(gy)

    t = timed(kernel, plain)
    t["split"] = device_split(kernel)
    t["bound_ms"], t["bound_by"] = bound_ms(
        3 * (held * 3 * D * I * 2 + rows * D * 2 * 2),
        3 * 2 * rows * D * 3 * I, PEAK_BF16_FLOPS)
    t["held_rows"], t["buffer_rows"] = rows, plan.rows
    t["dispatch_ms"] = median_ms(
        lambda: moe.dispatch(ids, sh["first"], sh["held"]))
    wgu16, wd16 = wgu.to(torch.bfloat16), wd.to(torch.bfloat16)
    xp = moe.gather_rows(x, plan, sh["k"])
    ap = torch.randn(plan.rows, I, device="cuda").to(torch.bfloat16)
    t["products_fwd_ms"] = median_ms(lambda: (
        moe.expert_gemm(xp, wgu16, plan), moe.expert_gemm(ap, wd16, plan)))
    gm = getattr(torch, "_grouped_mm", None)
    t["library"] = "torch._grouped_mm not in this torch"
    if gm is not None:
        offs = torch.cumsum(plan.counts, 0).to(torch.int32)
        a = torch.randn(rows, D, device="cuda").to(torch.bfloat16)
        act = torch.randn(rows, I, device="cuda").to(torch.bfloat16)
        b1, b2 = wgu16.transpose(1, 2), wd16.transpose(1, 2)
        try:
            t["library_products_fwd_ms"] = median_ms(lambda: (
                gm(a, b1, offs=offs, out_dtype=torch.bfloat16),
                gm(act, b2, offs=offs, out_dtype=torch.bfloat16)))
            t["library"] = "torch._grouped_mm"
        except (RuntimeError, TypeError) as e:
            t["library"] = f"torch._grouped_mm failed: {str(e)[:160]}"
    print_times("routed experts fwd+bwd (cell's shape)", t)
    print("routed experts (cell's shape) device ms a call by kernel: "
          + ", ".join(f"{k} {v:.4f}" for k, v in t["split"].items())
          + f"; dispatch {t['dispatch_ms']:.4f} ms; the forward's two "
          f"products {t['products_fwd_ms']:.4f} ms, "
          + (f"torch._grouped_mm over the same {rows} rows "
             f"{t['library_products_fwd_ms']:.4f} ms"
             if "library_products_fwd_ms" in t else t["library"]),
          flush=True)
    return t


def k10_one_table() -> dict:
    """K10 over DeepSeek-V2-Lite's one table (102,400 x 2,048) at the cell's
    128 x 96 ids: two runs bit-equal, within 1e-5 normwise of index_add_,
    timed beside it with its bound (the ids and g read once, every row of
    dW written once)."""
    from carel_tpu_torch.ops import cuda_embedding as ce

    n, V, D = 128 * 96, DSV2_EMB_ROWS, DSV2_EMB_D
    g = torch.Generator(device="cuda").manual_seed(1)
    ids = [torch.randint(0, V, (n,), generator=g, device="cuda")]
    grad = torch.randn(n, D, generator=g, device="cuda")

    def kernel():
        return ce.embeddings_backward_kernel(ids, grad, [V])

    first = kernel()
    if not torch.equal(first[0], kernel()[0]):
        fail("emb_bwd (DeepSeek-V2-Lite table): two runs differ")
    rel = relnorm(first[0], ce.embeddings_backward_plain(ids, grad, [V])[0])
    if not rel <= 1e-5:
        fail(f"emb_bwd (DeepSeek-V2-Lite table) off index_add_ by {rel}")
    t = timed(kernel, lambda: ce.embeddings_backward_plain(ids, grad, [V]))
    t["bound_ms"], t["bound_by"] = bound_ms(8 * n + 4 * n * D + 4 * D * V,
                                            n * D)
    print(f"emb_bwd DeepSeek-V2-Lite ({n} ids, one table of {V} x {D}): two "
          f"runs bit-equal; vs index_add_ normwise {rel:.2e}", flush=True)
    print_times("emb_bwd (DeepSeek-V2-Lite table)", t)
    return t


def phase_moe(records: dict) -> None:
    """The routed experts' kernels (ops/moe.py, Triton) through dispatch and
    routed_experts, forward and backward, as moe_case holds them: at two
    small ragged shapes in fp32 and bf16 and at the dsv2lite_train cell's
    shape in bf16; then timed at the cell's shape (moe_times), and K10 over
    the cell's one table (k10_one_table)."""
    cases = [moe_case("small", MOE_SMALL, torch.float32),
             moe_case("small", MOE_SMALL, torch.bfloat16),
             moe_case("tiny", MOE_TINY, torch.bfloat16, 1),
             moe_case("cell", MOE_SHAPE, torch.bfloat16)]
    t = moe_times()
    worst = max(max(c["rel"].values()) for c in cases[1:])
    for name, n in MOE_LAUNCHES.items():
        records[name] = {
            "name": name, "route": "triton",
            "source": "carel_tpu_torch/ops/moe.py",
            "replaces": "none: the JAX package has no mixture of experts",
            "launches": 0, "launches_a_routed_call": n,
            "max_rel_err_bf16": worst,
            "device_ms_a_routed_call": sum(
                v for k, v in t["split"].items()
                if k.startswith(name + "_kernel"))}
    records["expert_gemm"]["routed_experts_times"] = t
    records["emb_bwd"]["dsv2_table"] = k10_one_table()


def phase_scores() -> None:
    """The encoder's fp32 attention scores at the full-width shape: the bf16
    tensor-core GEMM with an fp32 output, which the model runs on CUDA,
    against the fp32 product of the upcast q and k, forward and backward,
    with the time of one forward and backward of each."""
    from carel_tpu_torch.ops.xla_attention import attention_scores, scores_upcast

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
                 min_tail: int = 0, pad_rows: float = 0.0, min_len: int = 1):
    """q, k, v and a cotangent, N(0, 1) from a seed, and a mask with pad
    tails of varied length, each min_tail at least, over min_len real
    tokens at least: row 0 has no pads, row 1 is all pads, and each other
    row is all pads with probability pad_rows (the stage-1 clause batch:
    documents padded to 75 clauses)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v, g = (torch.randn(B, h, L, hd, device="cuda", generator=gen)
                  .to(dtype) for _ in range(4))
    lengths = torch.randint(min_len, L - min_tail + 1, (B,), device="cuda",
                            generator=gen)
    empty = torch.rand(B, device="cuda", generator=gen) < pad_rows
    lengths = torch.where(empty, 0, lengths)
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
               min_tail: int = 0, pad_rows: float = 0.0, min_len: int = 1):
    """K7 (and K8/K9) against the plain version at one shape; returns the
    largest absolute errors of the output and of the gradients."""
    from carel_tpu_torch.ops import cuda_attention as ca

    q, k, v, g, mask = flash_inputs(B, h, L, hd, dtype, seed=B + L,
                                    min_tail=min_tail, pad_rows=pad_rows,
                                    min_len=min_len)
    scale = 1.0 / math.sqrt(hd)
    name = f"flash {str(dtype).split('.')[-1]} [{B}, {h}, {L}, {hd}]" \
        + (f" pad tails >= {min_tail}" if min_tail else "") \
        + (f" rows of {min_len}-{L - min_tail} tokens" if min_len > 1
           else "") \
        + (f" {int((mask.sum(1) == 0).sum())} rows all pads" if pad_rows
           else "")

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


# (shape [B, h, L, hd], with backward, least pad tail, share of all-pad
# rows): the training and the inference shape; ragged tiny ones (hd = 16 is
# one k16 step, L = 37 not a multiple of 16); L over one block's 128 rows,
# so that the tensor-core kernels' ring of 4 tiles of 32 rows wraps;
# hd = 128; pad tails longer than one tile, where every key of a tile is
# masked for a row; the stage-1 clause batch (4 documents x 75 clauses of
# 60 tokens, L no multiple of 16, most rows padded clauses), the DANN
# batch (32 clauses of 128 tokens, L past the one-block regime of L <= 96),
# the embed path's batch (32 texts of 200 tokens: 200 is no multiple of
# the 64-row tile, so the last tile is partly empty) and EncoderEmbedder's
# forward-only batches: 256 texts of 200 tokens on the embed path, and one
# document's dozen clauses of 64 tokens, with long pad tails, on the cit
# path; MLM pretraining's batch (256 clauses of 64 tokens, also
# EncoderEmbedder's batch on the clustering path), with its backward, and
# the MLM scorer's batch (32 rows of 64, 20-40 real tokens); optional fifth
# field: the least real tokens of a row
FLASH_CASES = (((64, 12, 96, 64), True, 0, 0.0),
               ((512, 12, 96, 64), False, 0, 0.0),
               ((5, 4, 37, 16), True, 0, 0.0),
               ((3, 2, 200, 64), True, 0, 0.0),
               ((2, 2, 513, 32), True, 0, 0.0),
               ((2, 2, 96, 128), True, 0, 0.0),
               ((4, 2, 160, 64), True, 48, 0.0),
               ((300, 12, 60, 64), True, 0, 0.8),
               ((32, 12, 128, 64), True, 0, 0.0),
               ((32, 12, 200, 64), True, 0, 0.0),
               ((256, 12, 200, 64), False, 0, 0.0),
               ((256, 12, 64, 64), True, 0, 0.0),
               ((12, 12, 64, 64), True, 24, 0.0),
               ((32, 12, 64, 64), True, 24, 0.0, 20))
# the shapes of the stage-1, DANN, embed and pretrain paths, of
# EncoderEmbedder's batch at L = 200 and of the MLM scorer's, timed beside
# the training shape: (tag, shape, flash_inputs' mask options)
FLASH_PATH_SHAPES = (("stage1", (300, 12, 60, 64), {"pad_rows": 0.8}),
                     ("dann", (32, 12, 128, 64), {}),
                     ("embed", (32, 12, 200, 64), {}),
                     ("embedder s200", (256, 12, 200, 64), {}),
                     ("pretrain, embedder s64", (256, 12, 64, 64), {}),
                     ("scorer", (32, 12, 64, 64),
                      {"min_tail": 24, "min_len": 20}))


def flash_calls(B: int, h: int, L: int, hd: int, seed: int, **mask_kw):
    """At one bf16 shape in the packed layout the training step gives
    K7-K9: {kernel name: (the wrapper's call, the plain version, the
    library call)} and the least work of each (flash_work); ``mask_kw``
    goes to flash_inputs."""
    import torch.nn.functional as F

    from carel_tpu_torch.ops import cuda_attention as ca

    scale = 1.0 / math.sqrt(hd)
    q, k, v, g, mask = flash_inputs(B, h, L, hd, torch.bfloat16, seed=seed,
                                    **mask_kw)
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
    print(f"scaled_dot_product_attention with the segment mask vs plain at "
          f"[{B}, {h}, {L}, {hd}]: normwise rel {lib_err:.2e}", flush=True)

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
    return calls, flash_work(mask, h, hd, q.element_size())


def phase_flash(records: dict) -> None:
    """K7-K9 against the plain flash attention, then their times at the
    shape and layout the training step gives them (bf16, packed)."""
    import torch.nn.functional as F

    from carel_tpu_torch.device import resolve_device
    from carel_tpu_torch.ops import cuda_attention as ca

    resolve_device("cuda")  # full-fp32 matmuls for the plain version
    worst = {"fwd": 0.0, "bwd": 0.0}
    for dtype in (torch.float32, torch.bfloat16):
        for shape, backward, min_tail, pad_rows, *min_len in FLASH_CASES:
            abs_out, abs_grad = flash_case(*shape, dtype, backward, min_tail,
                                           pad_rows, *min_len)
            if dtype == torch.bfloat16:
                worst["fwd"] = max(worst["fwd"], abs_out)
                worst["bwd"] = max(worst["bwd"], abs_grad)

    B, h, L, hd = 64, 12, 96, 64
    calls, work = flash_calls(B, h, L, hd, seed=1)
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
    scale = 1.0 / math.sqrt(hd)
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

    # K7-K9 at the shapes of the other paths; which of its backends the
    # library's forward picked, by the names of the kernels it launched
    for tag, shape, mask_kw in FLASH_PATH_SHAPES:
        calls, work = flash_calls(*shape, seed=3, **mask_kw)
        sdpa = device_kernel_names(calls["flash_fwd"][2])
        records["flash_fwd"].setdefault("library_kernels", {})[tag] = sdpa
        print(f"scaled_dot_product_attention at bf16 {list(shape)} ({tag} "
              f"path) launched: {'; '.join(sdpa)}", flush=True)
        for name in FLASH_KERNELS:
            kernel, plain, library = calls[name]
            bnd = bound_ms(*work[name], PEAK_BF16_FLOPS)
            at = records[name].setdefault("at", {})[tag] = {
                "shape": list(shape), "device_ms": device_ms(kernel),
                "ms": median_ms(kernel), "plain_device_ms": device_ms(plain),
                "library_device_ms": device_ms(library),
                "bound_ms": bnd[0], "bound_by": bnd[1]}
            print(f"{name} at bf16 {list(shape)} ({tag} path, packed "
                  f"layout): device {at['device_ms']:.4f} ms (plain "
                  f"{at['plain_device_ms']:.4f}, library "
                  f"{at['library_device_ms']:.4f}); by events "
                  f"{at['ms']:.4f} ms; bound {bnd[0]:.6f} ms by {bnd[1]}",
                  flush=True)


XLA_ATTN_KERNELS = ("xla_attn_fwd", "xla_attn_bwd")
# (B, h, L, hd), training: zh_train, zh_score, en_train, zh_pretrain, and the
# odd and long lengths of the other paths; training drops with p 0.1
XLA_ATTN_CASES = (((64, 12, 96, 64), True), ((512, 12, 96, 64), False),
                  ((64, 12, 128, 64), True), ((256, 12, 64, 64), True),
                  ((8, 12, 37, 64), True), ((32, 12, 200, 64), True))
XLA_ATTN_DROPOUT = 0.1
# Normwise gate on the kernel pair's output and each part of its packed
# gradient, against kernel_arithmetic and against the plain ops: the three
# round at the same points, and fp32 sums in other orders flip a few bf16
# roundings (read on the card: 1.5e-5 to 1.6e-4 at the six shapes). Three
# times the largest reading; one bf16 ds in dq and dk, the precision JAX's
# transpose does not take, reads 1e-3 (tests/test_torch_xla_attention.py).
XLA_ATTN_GATE = 5e-4


def xla_attention_inputs(B: int, h: int, L: int, hd: int, seed: int):
    """qkv [B, L, 3, h, hd] and a context gradient, N(0, 1) in bf16, and the
    fp32 key bias [B, 1, 1, L] with pad tails of varied length (row 0 none,
    row 1 all but one token)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    qkv = torch.randn(B, L, 3, h, hd, device="cuda",
                      generator=gen).to(torch.bfloat16)
    dout = torch.randn(B, L, h * hd, device="cuda",
                       generator=gen).to(torch.bfloat16)
    lengths = torch.randint(1, L + 1, (B,), device="cuda", generator=gen)
    lengths[0], lengths[1] = L, 1
    mask = (torch.arange(L, device="cuda")[None, :]
            < lengths[:, None]).float()
    return qkv, ((1.0 - mask) * -1e9)[:, None, None, :], dout


def xla_attention_work(B: int, h: int, L: int, hd: int, training: bool):
    """{kernel: (bytes, FLOP)} of the least work: each input read and each
    output written once (the keep mask a byte an element when training);
    the forward's two products and the backward's five."""
    qkv, ctx, rows = 2 * B * L * 3 * h * hd, 2 * B * L * h * hd, 4 * B * h * L
    keep = B * h * L * L if training else 0
    prod = 2 * B * h * L * L * hd
    return {"xla_attn_fwd": (qkv + keep + 4 * B * L + ctx + 2 * rows,
                             2 * prod),
            "xla_attn_bwd": (2 * qkv + ctx + keep + 4 * B * L + 2 * rows,
                             5 * prod)}


def phase_xla_attention(records: dict) -> None:
    """The xla attention core's kernel pair against its arithmetic in plain
    ops and against the plain ops, from one generator state (so all three
    drop the same keys): the keep mask bit-equal to F.dropout's on bf16
    ones with the generator at the same offset after, the output and the
    packed gradient within the gate, one launch of each kernel a call, two
    runs bit-equal; then each kernel's time beside its bound, the plain
    ops' and the library's."""
    import torch.nn.functional as F

    from carel_tpu_torch import ops
    from carel_tpu_torch.device import resolve_device
    from carel_tpu_torch.ops import xla_attention as xa

    resolve_device("cuda")  # full-fp32 matmuls for kernel_arithmetic
    p = XLA_ATTN_DROPOUT
    for name in XLA_ATTN_KERNELS:
        records[name] = {
            "name": name, "route": "cuda",
            "source": "carel_tpu_torch/csrc/attn_xla_"
                      + ("fwd" if name.endswith("fwd") else "bwd") + ".cu",
            "replaces": "no TPU kernel: XLA's attention at "
                        "carel_tpu/models/encoder.py:70-81",
            "launches": 0, "max_abs_err": 0.0, "at": {}}
    for (B, h, L, hd), training in XLA_ATTN_CASES:
        tag = f"[{B}, {h}, {L}, {hd}]" + (" train" if training else "")
        qkv, bias, dout = xla_attention_inputs(B, h, L, hd, seed=B + L)
        state = torch.cuda.get_rng_state()
        keep = None
        if training:
            keep = xa.draw_keep((B, h, L, L), p, qkv.device)
            after = torch.cuda.get_rng_state()
            torch.cuda.set_rng_state(state)
            want = F.dropout(torch.ones((B, h, L, L), dtype=torch.bfloat16,
                                        device="cuda"), p) != 0
            if not torch.equal(keep, want):
                fail(f"xla attention {tag}: the keep mask is not "
                     "F.dropout's draw")
            if not torch.equal(after, torch.cuda.get_rng_state()):
                fail(f"xla attention {tag}: the generator's offset after "
                     "the draw differs from F.dropout's")

        def run(core):
            torch.cuda.set_rng_state(state)
            leaf = qkv.clone().requires_grad_(training)
            with torch.autocast("cuda", dtype=torch.bfloat16), \
                    torch.set_grad_enabled(training):
                out = core(leaf, bias)
            if training:
                out.backward(dout)
            end = torch.cuda.get_rng_state()
            return out.detach(), leaf.grad, end

        ops.reset_launch_counts()
        got = run(lambda t, b: xa.xla_attention(t, b, p, training))
        counts = ops.launch_counts()
        if (counts["xla_attn_fwd"], counts["xla_attn_bwd"]) != (1,
                                                                int(training)):
            fail(f"xla attention {tag}: launches {counts}")
        again = run(lambda t, b: xa.xla_attention(t, b, p, training))
        if not all(a is None or torch.equal(a, b)
                   for a, b in zip(got, again)):
            fail(f"xla attention {tag}: two runs differ")
        ops_ = run(lambda t, b: xa.attention_ops(t, b, p, training))
        if not torch.equal(got[2], ops_[2]):
            fail(f"xla attention {tag}: the generator ends elsewhere than "
                 "after the plain ops")
        arith = run(lambda t, b: xa.kernel_arithmetic(
            t, b.reshape(B, L), keep, p))
        gaps = {}
        for ref_name, ref in (("arithmetic", arith), ("ops", ops_)):
            gaps[f"out_vs_{ref_name}"] = relnorm(got[0], ref[0])
            if training:
                for i, part in enumerate("qkv"):
                    gaps[f"d{part}_vs_{ref_name}"] = relnorm(
                        got[1][:, :, i], ref[1][:, :, i])
        abs_out = float((got[0].float() - arith[0].float()).abs().max())
        abs_grad = float((got[1].float() - arith[1].float()).abs().max()) \
            if training else 0.0
        print(f"xla attention {tag}: normwise gaps "
              + ", ".join(f"{k} {v:.2e}" for k, v in gaps.items())
              + f"; largest |out - arithmetic| {abs_out:.3e}, |dqkv - "
              f"arithmetic| {abs_grad:.3e}", flush=True)
        if not max(gaps.values()) <= XLA_ATTN_GATE:
            fail(f"xla attention {tag}: a gap over {XLA_ATTN_GATE}: {gaps}")
        records["xla_attn_fwd"]["max_abs_err"] = max(
            records["xla_attn_fwd"]["max_abs_err"], abs_out)
        records["xla_attn_bwd"]["max_abs_err"] = max(
            records["xla_attn_bwd"]["max_abs_err"], abs_grad)

        # times: each kernel alone, the plain ops' forward (+ backward),
        # and the library's fused attention with the same mask and dropout
        b2 = bias.reshape(B, L)
        sc = xa.scales(hd, p)
        fkeep = keep if training else None
        fwd = lambda: xa.xla_attention_forward_kernel(qkv, b2, fkeep,
                                                      *sc[:2])
        _, m, l = fwd()
        bwd = lambda: xa.xla_attention_backward_kernel(qkv, b2, fkeep, dout,
                                                       m, l, *sc)
        q4, k4, v4 = (t.transpose(1, 2) for t in qkv.unbind(2))
        mask4 = bias.to(torch.bfloat16)
        leaf = qkv.clone().requires_grad_(training)

        def plain():
            with torch.autocast("cuda", dtype=torch.bfloat16), \
                    torch.set_grad_enabled(training):
                out = xa.attention_ops(leaf, bias, p, training)
            if training:
                torch.autograd.grad(out, leaf, dout)

        def library():
            with torch.set_grad_enabled(training):
                qs, ks, vs = (t.detach().requires_grad_(training)
                              for t in (q4, k4, v4))
                out = F.scaled_dot_product_attention(
                    qs, ks, vs, attn_mask=mask4,
                    dropout_p=p if training else 0.0)
            if training:
                torch.autograd.grad(out, (qs, ks, vs), out)

        work = xla_attention_work(B, h, L, hd, training)
        pair = {"xla_attn_fwd": fwd, "xla_attn_bwd": bwd}
        both = {"plain_ms": median_ms(plain), "library_ms": median_ms(library),
                "plain_device_ms": device_ms(plain),
                "library_device_ms": device_ms(library)}
        for name in XLA_ATTN_KERNELS[:1 + int(training)]:
            kernel_ms, kernels = device_profile(pair[name])
            bnd = bound_ms(*work[name], PEAK_BF16_FLOPS)
            at = records[name]["at"][tag] = {
                "ms": median_ms(pair[name]), "device_ms": kernel_ms,
                "kernels_per_call": kernels, "bound_ms": bnd[0],
                "bound_by": bnd[1],
                "host_launch_ms": host_launch_ms(pair[name]), **both}
            if kernels != 1:
                fail(f"{name} {tag}: {kernels} device kernels a call")
            print(f"{name} {tag}: device {kernel_ms:.4f} ms (bound "
                  f"{bnd[0]:.4f} by {bnd[1]}, {bnd[0] / kernel_ms:.1%}); by "
                  f"events {at['ms']:.4f} ms; one launch costs the host "
                  f"{at['host_launch_ms']:.4f} ms", flush=True)
        print(f"xla attention {tag}, forward{' + backward' if training else ''}"
              f": plain ops device {both['plain_device_ms']:.4f} ms (events "
              f"{both['plain_ms']:.4f}); library (SDPA) device "
              f"{both['library_device_ms']:.4f} ms (events "
              f"{both['library_ms']:.4f})", flush=True)


def tiny_config(preset: str, attention_impl: str = "xla",
                adapter: str = "none"):
    """The preset's loss and model options at tiny widths, dropout 0, with
    the attention adapter ``adapter`` (4 heads)."""
    from carel_tpu_torch.config import (PRESETS, AdapterKind, DataConfig,
                                        TrainConfig)
    from carel_tpu_torch.models.encoder import tiny_encoder_config

    base = PRESETS[preset]
    return dataclasses.replace(
        base,
        model=dataclasses.replace(
            base.model, encoder=tiny_encoder_config(
                vocab_size=256, dropout=0.0, attention_impl=attention_impl),
            ec_dim=24, bow_dim=3000, dropout=0.0,
            adapter=AdapterKind(adapter), head_number=4),
        data=DataConfig(max_len=32),
        train=TrainConfig(batch_size=16, vae_lr=1e-3))


# the attention adapters' key biases: the score of every key moves by the
# same q . b, which softmax, sparsemax and entmax15 ignore, so their
# gradient is 0 in exact arithmetic and rounding noise on either device
SHIFT_INVARIANT = ("mha.key.bias", "k_proj.bias")


def phase_reference(preset: str, attention_impl: str = "xla",
                    adapter: str = "none") -> None:
    """A tiny fp32 model takes one training step on the card (kernels) and on
    the CPU (plain versions) from the same weights, batch, (zero) noise and,
    under vi, batch permutation and vi_beta; with ``adapter``, each latent
    reads its attention adapter (the batch's two padded rows are all-masked
    attention rows). The adapters' key biases (SHIFT_INVARIANT) are held to
    the 2 lr bound only."""
    from carel_tpu_torch.config import Regularizer
    from carel_tpu_torch.data.batching import cut_batch
    from carel_tpu_torch.pipeline import init_state
    from carel_tpu_torch.train.state import CLUB, DISC, MAIN
    from carel_tpu_torch.train.steps import batch_to_device, make_train_step

    cfg = tiny_config(preset, attention_impl, adapter)
    preset = f"{preset} ({attention_impl} attention" + (
        f", {adapter} adapter)" if adapter != "none" else ")")
    arrays = synth_pair_arrays(np.random.default_rng(3), 16, 32, 256, 3000,
                               min_len=8)
    host = cut_batch(arrays, np.arange(14), 16).as_dict()  # 2 padded rows
    perm = torch.from_numpy(np.random.default_rng(4).permutation(16))
    step = make_train_step(cfg)
    results = {}
    for dev in ("cpu", "cuda"):
        state = init_state(cfg, dev)
        zeros = torch.zeros(24, device=dev)
        metrics = step(state, batch_to_device(host, torch.device(dev)), 0,
                       vi_beta=0.3, eps=(zeros, zeros), perm=perm.to(dev))
        # the gradients the main loss left (main; disc under gan); the vi
        # step clears the club's .grad, so its phase-1 gradient is read
        # from the club Adam's first moment, (1 - beta1) g after one step
        club = state.club_optimizer.state
        grads = {n: (club[p]["exp_avg"] / 0.1 if p in club else p.grad).cpu()
                 for n, p in state.model.named_parameters()
                 if p.grad is not None or p in club}
        results[dev] = (
            {k: float(v) for k, v in metrics.items()},
            {n: p.detach().cpu() for n, p in state.model.named_parameters()},
            grads)
    labels = state.labels
    (m_c, p_c, g_c), (m_g, p_g, g_g) = results["cpu"], results["cuda"]
    if g_c.keys() != g_g.keys() or not any(labels[n] == MAIN for n in g_c) \
            or (cfg.loss.regularizer == Regularizer.VI) != any(
                labels[n] == CLUB for n in g_c):
        fail(f"card and CPU leave gradients on other parameters ({preset})")
    worst_m = max(abs(m_g[k] - m_c[k]) / max(abs(m_c[k]), 1e-30) for k in m_c)
    g_c = {n: g for n, g in g_c.items() if not n.endswith(SHIFT_INVARIANT)}
    worst_g = max(relnorm(g_g[n], g_c[n]) for n in g_c)
    # each group's params within Adam's sign-flip bound 2 * its lr
    lrs = {MAIN: cfg.train.vae_lr, DISC: cfg.train.adv_lr,
           CLUB: cfg.train.aprx_lr}
    worst_p = max(float((p_g[n] - p_c[n]).abs().max())
                  / lrs.get(labels[n], cfg.train.vae_lr) for n in p_c)
    # where |g| > 1e-3 max|g| of its tensor Adam's first step cannot flip
    # sign, so there the card's step must match the CPU's tightly
    safe = {n: g_c[n].abs() > 1e-3 * g_c[n].abs().max() for n in g_c}
    worst_safe = max(float((p_g[n] - p_c[n])[safe[n]].abs().max())
                     / lrs[labels[n]] for n in g_c)
    print(f"reference step {preset} (tiny fp32, card vs CPU): loss "
          f"{m_g['loss']:.6f} "
          f"vs {m_c['loss']:.6f}; worst metric rel {worst_m:.2e}, grad "
          f"normwise rel {worst_g:.2e}, param abs {worst_p:.2e} lr "
          f"({worst_safe:.2e} lr where |g| > 1e-3 max|g|)", flush=True)
    # fp32 on both sides, sums in another order: metrics to 1e-4, grads to
    # 1e-3 normwise, params within 2 * lr, and to 1e-3 * lr where the sign
    # is safe
    if not (worst_m <= 1e-4 and worst_g <= 1e-3 and worst_p <= 2
            and worst_safe <= 1e-3):
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


class CountedEpochStep:
    """The default epoch step (train/scan_epoch.py) of a config, keeping the
    losses of every epoch it trains (fetched once, at the end)."""

    is_epoch_step = True

    def __init__(self, cfg):
        from carel_tpu_torch.train.scan_epoch import make_epoch_step

        self.step = make_epoch_step(cfg)
        self.losses = []

    def __call__(self, state, stacked, vi_beta):
        losses = self.step(state, stacked, vi_beta)
        self.losses.append(losses)
        return losses

    def fetch(self, losses):
        return self.step.fetch(losses)

    @property
    def moe_counts(self) -> dict:
        return self.step.moe_counts

    @property
    def steps(self) -> int:
        return sum(len(losses) for losses in self.losses)

    def all_losses(self) -> list:
        return torch.cat(self.losses).tolist()

    def describe(self) -> str:
        s = self.step
        return (f"{s.captures} capture(s), {s.replays} replays of a step "
                f"that launches {s.captured_launches}; the capture's "
                f"warm-up launched {s.warmup_launches} (rolled back, not "
                f"counted)")

    def check(self, tag: str, steps: int) -> None:
        """One capture served every epoch, and every step was a replay."""
        if self.step.captures != 1 or self.step.replays != steps:
            fail(f"{tag}: {self.step.captures} captures and "
                 f"{self.step.replays} replays for {steps} steps (want one "
                 "capture, a replay a step)")


FLAGSHIP = "ec_mmd_final_mul_newsplit_emnlp"

# the kernels every stage-2 training step launches: the fused BoW loss and
# the embeddings' backward
STEP_KERNELS = ("bow_fwd", "bow_bwd", "emb_bwd")
PATH_KERNELS = {
    FLAGSHIP: ("mmd_fwd", "mmd_bwd", *STEP_KERNELS),
    "ec_hsic": ("hsic_fwd", "hsic_bwd", *STEP_KERNELS),
    "ec_gan": STEP_KERNELS,
    "ec_vi_final": STEP_KERNELS,
}
ZH_PATHS = tuple(PATH_KERNELS)
# the en path: the MMD step of the flagship over a roberta-base encoder
EN_PRESET = "en_newsplit"
PATH_KERNELS[EN_PRESET] = PATH_KERNELS[FLAGSHIP]
# device kernels a wrapper call launches, where it is not one: K10 sorts
# (beside the zeros), sums chunks and combines them, one call a step for
# the word, position and token-type tables
KERNELS_A_CALL = {"emb_bwd": 3}


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
               strategy: str, cfg=None, on_init=None,
               timed_epochs: bool = False, name: str = "",
               still=(), moving=()) -> dict:
    """The preset at full width: one base epoch, then ``iterations``
    self-training iterations of one epoch with ``strategy``, all through the
    default, captured epoch step: one capture must serve them all, and every
    path kernel must launch on every step (a replay launches the captured
    step's kernels). The disc params must move under gan only, the club
    params under vi only, the frozen latent heads under neither. Returns the
    run's peak memory in GiB and the K3 launches a step. ``cfg`` replaces
    the preset's full-width zh config (its self-training fields are set
    here), ``on_init(state)`` looks at the state init_state made, and with
    ``timed_epochs`` the captured step then takes three more epochs timed
    and one profiled (time_epochs), whose numbers join the result.
    ``name`` (default the preset) names the path in the output and in the
    kernels' launches_by_path; every param whose name starts with one of
    ``still`` must end bit-unchanged, and every one in ``moving`` must
    move."""
    from carel_tpu_torch import ops
    from carel_tpu_torch.config import SelfStrategy
    from carel_tpu_torch.pipeline import init_state
    from carel_tpu_torch.selftrain import self_train
    from carel_tpu_torch.train import checkpoint as ckpt
    from carel_tpu_torch.train.scan_epoch import stack_epoch
    from carel_tpu_torch.train.state import CLUB, DISC, FROZEN
    from carel_tpu_torch.train.loop import evaluate, train_epochs
    from carel_tpu_torch.train.steps import make_eval_step

    n_train, n_test, unpred = 1024, 512, 10
    selftrain = dict(self_iteration=iterations, self_epochs=1,
                     self_strategy=SelfStrategy(strategy))
    cfg = (full_width_config(preset, preset, **selftrain) if cfg is None
           else dataclasses.replace(cfg, train=dataclasses.replace(
               cfg.train, **selftrain)))
    enc, B, L = cfg.model.encoder, cfg.train.batch_size, cfg.data.max_len
    V = cfg.model.bow_dim
    name = name or preset
    tag = f"{name} path"
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
    if on_init is not None:
        on_init(state)
    counted_step, eval_step = CountedEpochStep(cfg), make_eval_step()
    aux = {n: p.detach().clone() for n, p in state.model.named_parameters()
           if state.labels[n] in (DISC, CLUB, FROZEN)}
    watched = {n: p.detach().clone() for n, p in
               state.model.named_parameters()
               if n.startswith(tuple(still) + tuple(moving))}

    # the run's own record of its evaluations and pseudo sets
    prob_ranges, pseudo_sizes = [], []

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
    base_steps = counted_step.steps
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
    steps = counted_step.steps
    losses = counted_step.all_losses()
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
          f"{res.recall:.4f} {res.f1:.4f}; launches {counts}; "
          f"{counted_step.describe()}; peak memory {peak_gib:.2f} GiB",
          flush=True)
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
    counted_step.check(tag, steps)
    want_counts = {**dict.fromkeys(PATH_KERNELS[preset], steps),
                   **xla_attention_launches(tag, counts, enc.num_layers,
                                            steps)}
    for kernel, n in counts.items():
        want = want_counts.get(kernel, 0)
        if n != want:
            fail(f"{tag}: kernel {kernel} launched {n} times in {steps} "
                 f"training steps (want {want})")
        records[kernel].setdefault("launches_by_path", {})[name] = n
        records[kernel]["launches"] = sum(
            records[kernel]["launches_by_path"].values())
    if not any(r["event"] == "best" for r in logger.records):
        fail(f"{tag}: no best checkpoint was saved")
    moved = {DISC: False, CLUB: False, FROZEN: False}
    for n, p in state.model.named_parameters():
        if n in aux:
            moved[state.labels[n]] |= not torch.equal(p.detach(), aux[n])
    want_moved = {DISC: preset == "ec_gan", CLUB: preset == "ec_vi_final",
                  FROZEN: False}
    print(f"{tag}: params moved by group {moved}", flush=True)
    if moved != want_moved:
        fail(f"{tag}: the disc, club and frozen params moved as {moved} "
             f"(want {want_moved})")
    params = dict(state.model.named_parameters())
    moved_by_name = {n: not torch.equal(params[n].detach(), p)
                     for n, p in watched.items()}
    wrong = sorted(n for n, m in moved_by_name.items()
                   if m == n.startswith(tuple(still)))
    if watched:
        print(f"{tag}: {sum(moved_by_name.values())} of {len(watched)} "
              f"watched params moved; bit-unchanged: "
              f"{sorted(n for n, m in moved_by_name.items() if not m)}",
              flush=True)
    if wrong:
        fail(f"{tag}: {wrong} moved where they must stay, or stayed where "
             f"they must move (still {still}, moving {moving})")
    saved = ckpt.load_best(cfg.train.checkpoint_dir, preset,
                           torch.device("cuda"))
    if not (same_state(saved, best_cache["state_dict"])
            and same_state(state.model.state_dict(), saved)):
        fail(f"{tag}: the reloaded best differs from the saved checkpoint")

    # one more epoch moves the params; a train_epochs call of no epochs and
    # no in-memory cache reloads the best from disk
    counted_step(state, stack_epoch(train, B, np.random.default_rng(1)), 0.0)
    if same_state(state.model.state_dict(), saved):
        fail(f"{tag}: the last epoch left the params unchanged")
    state, _ = train_epochs(cfg, state, counted_step, eval_step, train, test,
                            unpred, preset, epochs=0, logger=logger)
    if not same_state(state.model.state_dict(), saved):
        fail(f"{tag}: the reload from disk differs from the checkpoint")
    print(f"{tag}: best checkpoint saved, reloaded from memory and from "
          "disk, equal to the saved state_dict", flush=True)
    out = dict(peak_gib=peak_gib, bow_per_step=counts["bow_fwd"] / steps)
    if timed_epochs:
        torch.cuda.reset_peak_memory_stats()
        nb = -(-len(train) // B)
        out["step"] = time_epochs(
            tag, "captured", captured_epoch, counted_step, state, train, B,
            nb, path_kernel_calls(preset, enc.attention_impl))
        out["step"]["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        counted_step.check(tag, counted_step.steps)
    return out


# roberta-base's published shape (the model card's config.json)
ADAPTER_KINDS = ("raw", "sparsemax", "entmax")


def adapter_config(kind: str):
    """The flagship at full width with the ``kind`` attention adapter over
    the last hidden state for each latent (4 heads for raw)."""
    from carel_tpu_torch.config import AdapterKind

    cfg = full_width_config(FLAGSHIP, f"adapter_{kind}")
    return dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, adapter=AdapterKind(kind), head_number=4))


def mu_bf16_config():
    """The flagship at full width with the main Adam's first moment in
    bf16 (--optim_mu_dtype bfloat16)."""
    return full_width_config(FLAGSHIP, "mu_bf16", optim_mu_dtype="bfloat16")


def phase_adapter(records: dict, kind: str) -> dict:
    """phase_path for the flagship with the ``kind`` adapter: one base
    epoch, evaluation, one temporal_order_modification self-training
    iteration, all captured (one capture; K1-K4 and K10 on every step), the
    best saved and reloaded, then the captured step timed. Each adapter's
    query and weights must move; the pooler, which no adapter path reads,
    and (sparse kinds) v_proj, whose output is never used, must stay
    bit-unchanged, as must the frozen latent heads."""
    sparse = kind != "raw"
    weights = (("q_proj", "k_proj") if sparse
               else ("mha.query", "mha.key", "mha.value", "mha.out"))
    moving = tuple(f"{a}_adapter.{w}" for a in ("emotion", "cause")
                   for w in ("query",) + tuple(f"{x}.weight"
                                               for x in weights))
    still = ("encoder.pooler.",) + (
        ("emotion_adapter.v_proj.", "cause_adapter.v_proj.") if sparse
        else ())
    return phase_path(records, FLAGSHIP, 1, "temporal_order_modification",
                      cfg=adapter_config(kind), timed_epochs=True,
                      name=f"adapter {kind}", still=still, moving=moving)


def phase_bits(name: str, cfg, resume: bool = False) -> None:
    """From one state (init_state, saved with save_state and restored with
    load_state before each run), one epoch of the eager per-step loop, one
    of the captured epoch step, then each again: losses, params and the
    main Adam's state must be bit-equal across all four. The main Adam's
    first moments must be in the config's optim_mu_dtype and the club Adam
    torch's (fp32 moments). With ``resume``: a snapshot saved after the
    runs, one more captured epoch, then the snapshot loaded and that epoch
    again: the same bits (a stale capture is captured again)."""
    from carel_tpu_torch.pipeline import init_state
    from carel_tpu_torch.train import checkpoint as ckpt
    from carel_tpu_torch.train.scan_epoch import make_epoch_step
    from carel_tpu_torch.train.steps import make_train_step

    tag = f"bits {name}"
    enc, B, L = cfg.model.encoder, cfg.train.batch_size, cfg.data.max_len
    train = synth_pair_arrays(np.random.default_rng(0), 1024, L,
                              enc.vocab_size, cfg.model.bow_dim)
    ckpt_dir = cfg.train.checkpoint_dir
    state = init_state(cfg, "cuda")
    ckpt.save_state(ckpt_dir, "start", state)
    mu_dtype = {"float32": torch.float32,
                "bfloat16": torch.bfloat16}[cfg.train.optim_mu_dtype]

    def record(losses):
        opt = state.optimizer
        moments = [t.detach().clone() for p in state.model.parameters()
                   for t in opt.state.get(p, {}).values()]
        return dict(losses=losses.cpu(), params=[
            p.detach().clone() for p in state.model.parameters()],
            moments=moments)

    def same(a, b) -> bool:
        return torch.equal(a["losses"], b["losses"]) and all(
            torch.equal(x, y) for k in ("params", "moments")
            for x, y in zip(a[k], b[k]))

    runs = []
    t0 = time.perf_counter()
    for kind in ("eager", "captured", "eager", "captured"):
        ckpt.load_state(ckpt_dir, "start", state)
        if kind == "eager":
            runs.append(record(eager_epoch(make_train_step(cfg), state,
                                           train, B, 1, 0.0)))
        else:
            step = make_epoch_step(cfg)
            runs.append(record(captured_epoch(step, state, train, B, 1,
                                              0.0)))
    mus = {state.optimizer.state[p]["exp_avg"].dtype
           for p in state.model.parameters() if p in state.optimizer.state}
    alike = [same(r, runs[0]) for r in runs[1:]]
    print(f"{tag}: eager, captured, eager, captured epochs from one state "
          f"({len(runs[0]['losses'])} steps each, {time.perf_counter() - t0:.1f} "
          f"s): bit-equal to the first {alike}; main Adam "
          f"{type(state.optimizer).__name__} with first moments in {mus}, "
          f"club Adam {type(state.club_optimizer).__name__}", flush=True)
    if not all(alike):
        fail(f"{tag}: eager and captured epochs from one state give other "
             f"bits ({alike})")
    if mus != {mu_dtype}:
        fail(f"{tag}: the main Adam's first moments are {mus} (want "
             f"{mu_dtype})")
    if type(state.club_optimizer) is not torch.optim.Adam:
        fail(f"{tag}: the club Adam is {type(state.club_optimizer)}")
    if not resume:
        return
    ckpt.save_state(ckpt_dir, "mid", state)
    again = []
    for _ in range(2):
        again.append(record(captured_epoch(step, state, train, B, 2, 0.0)))
        ckpt.load_state(ckpt_dir, "mid", state)
    print(f"{tag}: a snapshot saved and resumed gives the next epoch's bits: "
          f"{same(again[0], again[1])} ({step.captures} captures)",
          flush=True)
    if not same(again[0], again[1]) or step.captures != 2:
        fail(f"{tag}: the resumed epoch differs from the one it repeats, or "
             f"it did not capture again ({step.captures} captures)")


def phase_adam() -> None:
    """The main Adam's step alone at full width, on one flagship model's
    main params (~103 M) with gradients from a seed set once: torch's fused
    capturable fp32 Adam (the default) and MuDtypeAdam (--optim_mu_dtype
    bfloat16, foreach ops), each by CUDA events (median of 30 steps) and
    by the profiler (device ms and kernels a step), with its state's size
    and its bound: the bytes a step must move (params and both moments
    read and written, gradients read) over 3.35 TB/s. MuDtypeAdam writes
    its update into .grad, so its later steps read those; the time does not
    depend on the values."""
    from carel_tpu_torch.pipeline import init_state
    from carel_tpu_torch.train.state import create_train_state

    model = init_state(full_width_config(FLAGSHIP, "adam"), "cuda").model
    for name, cfg in (("fused fp32 Adam", full_width_config(
            FLAGSHIP, "adam")), ("MuDtypeAdam, bf16 mu", mu_bf16_config())):
        opt = create_train_state(cfg, model, torch.Generator()).optimizer
        params = [p for g in opt.param_groups for p in g["params"]]
        gen = torch.Generator(device="cuda").manual_seed(0)
        for p in params:
            p.grad = torch.randn(p.shape, generator=gen,
                                 device="cuda") * 1e-3
        # what the first step (its state and temporaries) adds to the
        # params and gradients already held
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        opt.step()
        torch.cuda.synchronize()
        step_gib = (torch.cuda.max_memory_allocated() - held) / 2**30
        n = sum(p.numel() for p in params)
        state_bytes = sum(t.nbytes for st in opt.state.values()
                          for t in st.values())
        mu_bytes = 2 if cfg.train.optim_mu_dtype == "bfloat16" else 4
        moved = n * (4 + 4 + 4 + 2 * mu_bytes + 4 + 4)
        ms = median_ms(opt.step)
        dev, kernels = device_profile(opt.step)
        print(f"adam step, {name}, {n} params: {ms:.4f} ms by events, "
              f"device {dev:.4f} ms in {kernels:.1f} kernels, bound "
              f"{bound_ms(moved, 0.0)[0]:.4f} ms ({moved} bytes), state "
              f"{state_bytes / 2**30:.3f} GiB, first step's peak over the "
              f"params and gradients {step_gib:.3f} GiB", flush=True)
        del opt, params
        torch.cuda.empty_cache()


def phase_pair(records: dict) -> dict:
    """The plain pair classifier (the pair verb's train_pair_classifier) at
    full width (12L/768H, vocab 21,128, bf16, attention_impl="flash") on
    the synthetic pairs of the zh paths at b64 x s96, the classifier's
    bias centred on the median logit of the test pairs (random weights put
    every pair on one side of 0.5): a base epoch of 16 steps, its
    evaluation of 514 test pairs, one threshold self-training
    iteration (prediction with the best params, fine-tune, evaluation).
    K7 must launch once a layer on every forward, K8/K9 once a layer and
    K10 once on every training step; the probabilities must be
    finite values in [0, 1]. Then 16 more eager steps timed and profiled.
    Returns wall and device ms/step, kernels/step and peak memory."""
    from carel_tpu_torch import ops
    from carel_tpu_torch.config import EncoderConfig
    from carel_tpu_torch.data.batching import iter_batches
    from carel_tpu_torch.train.pair_trainer import (PairTrainerConfig,
                                                    _predict,
                                                    build_pair_trainer,
                                                    train_pair_classifier)
    from carel_tpu_torch.train.steps import batch_to_device

    tag = "pair path"
    enc = EncoderConfig(arch="bert", dtype="bfloat16", attention_impl="flash")
    B, L, layers = 64, 96, enc.num_layers
    pcfg = PairTrainerConfig(max_len=L, batch_size=B, epochs=1,
                             self_epochs=1, self_iteration=1)
    # the zh paths' synthetic data (its BoW columns go unread): 1,024
    # train pairs, a target domain of 514 pairs from this seed
    rng = np.random.default_rng(0)
    train = synth_pair_arrays(rng, 1024, L, enc.vocab_size, 23808)
    test_pairs, test, encode = synth_target_domain(rng, 512, L,
                                                   enc.vocab_size, 23808)
    logger = _Records()
    # random weights give every pair nearly the same logit, all on one side
    # of 0.5, and then the threshold strategy finds no document with pairs
    # on both sides: the classifier's bias is centred on the median logit
    # of the test pairs, so that a random model's predictions split
    model, _, _, eval_step = build_pair_trainer(pcfg, enc, "cuda")
    p = torch.from_numpy(_predict(eval_step, test, pcfg.eval_batch_size,
                                  "cuda")).double()
    with torch.no_grad():
        model.classifier.bias -= float(torch.logit(p).median())
    init = {k: v.clone() for k, v in model.state_dict().items()}
    del model, eval_step
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    best_params, best = train_pair_classifier(
        pcfg, enc, train, test, 10, test_pairs, encode, logger,
        device="cuda", params=init)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    evals = [r for r in logger.records if r["event"] == "pair_eval"]
    forwards = (len(evals) + pcfg.self_iteration) * -(
        -len(test) // pcfg.eval_batch_size)
    n = sum(r["steps"] for r in evals)
    print(f"{tag}: {n} training steps ({len(train) // B} base), "
          f"{len(evals)} evaluations of {len(test)} pairs, best {best}, in "
          f"{wall:.2f} s; launches {counts}", flush=True)
    if n <= len(train) // B:
        fail(f"{tag}: self-training took no training step")
    want = {"flash_fwd": layers * (n + forwards), "flash_bwd_dkv": layers * n,
            "flash_bwd_dq": layers * n, "emb_bwd": n}
    for kernel, got in counts.items():
        if got != want.get(kernel, 0):
            fail(f"{tag}: kernel {kernel} launched {got} times in {n} "
                 f"training steps and {forwards} evaluation batches (want "
                 f"{want.get(kernel, 0)})")
        records[kernel].setdefault("launches_by_path", {})["pair"] = got
        records[kernel]["launches"] = sum(
            records[kernel]["launches_by_path"].values())
    for p in best:
        if not 0.0 <= p <= 1.0:
            fail(f"{tag}: metric out of range: {p}")

    # the best params again, then 16 eager steps timed and 16 profiled
    _, _, train_step, eval_step = build_pair_trainer(pcfg, enc, "cuda",
                                                     best_params)
    probs = _predict(eval_step, test, pcfg.eval_batch_size, "cuda")
    if not probabilities(probs, len(test)):
        fail(f"{tag}: probabilities are not finite values in [0, 1]")
    batches = [batch_to_device(b.as_dict(), torch.device("cuda"))
               for b in iter_batches(train, B, rng=np.random.default_rng(3))]

    def epoch():
        return torch.stack([train_step(b) for b in batches])

    epoch()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses = epoch().cpu()
    wall_ms = (time.perf_counter() - t0) / len(batches) * 1e3
    if not torch.isfinite(losses).all():
        fail(f"{tag}: a timed loss is not finite")
    device_ms, kernels, per_kernel = profile_epoch(epoch, len(batches))
    calls = kernel_calls_by_wrapper(per_kernel, len(batches))
    out = dict(wall_ms=wall_ms, device_ms=device_ms, kernels=kernels,
               peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    print(f"{tag} (eager) b{B}xs{L}: wall {wall_ms:.2f} ms/step "
          f"({B / wall_ms * 1e3:.1f} pairs/s), device {device_ms:.2f} "
          f"ms/step (busy {device_ms / wall_ms:.3f}), {kernels:.1f} "
          f"kernels/step, path kernels a step "
          f"{ {k: c for k, c in calls.items() if c} }, peak memory "
          f"{out['peak_gib']:.2f} GiB", flush=True)
    return out


ROBERTA_BASE = dict(
    model_type="roberta", architectures=["RobertaForMaskedLM"],
    vocab_size=50265, hidden_size=768, num_hidden_layers=12,
    num_attention_heads=12, intermediate_size=3072,
    max_position_embeddings=514, type_vocab_size=1, layer_norm_eps=1e-5,
    pad_token_id=1, bos_token_id=0, eos_token_id=2, hidden_act="gelu",
    hidden_dropout_prob=0.1, attention_probs_dropout_prob=0.1)


def write_roberta_checkpoint(path: str) -> None:
    """A local HF checkpoint dir of roberta-base's shape: its config.json
    and a pytorch_model.bin of random weights from seed 0 (normal, std
    0.02; LayerNorm scales 1) under HF's key names, written with
    torch.save, so that no transformers is needed."""
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(ROBERTA_BASE, f)
    gen = torch.Generator().manual_seed(0)
    c = ROBERTA_BASE
    H, inner = c["hidden_size"], c["intermediate_size"]

    def normal(*shape):
        return torch.randn(*shape, generator=gen) * 0.02

    sd = {}

    def dense(name, n_out, n_in):
        sd[f"{name}.weight"], sd[f"{name}.bias"] = (normal(n_out, n_in),
                                                    normal(n_out))

    def norm(name):
        sd[f"{name}.weight"], sd[f"{name}.bias"] = torch.ones(H), normal(H)

    e = "roberta.embeddings."
    sd[e + "word_embeddings.weight"] = normal(c["vocab_size"], H)
    sd[e + "position_embeddings.weight"] = normal(
        c["max_position_embeddings"], H)
    sd[e + "token_type_embeddings.weight"] = normal(c["type_vocab_size"], H)
    norm(e + "LayerNorm")
    for i in range(c["num_hidden_layers"]):
        p = f"roberta.encoder.layer.{i}."
        for n in ("query", "key", "value"):
            dense(p + f"attention.self.{n}", H, H)
        dense(p + "attention.output.dense", H, H)
        norm(p + "attention.output.LayerNorm")
        dense(p + "intermediate.dense", inner, H)
        dense(p + "output.dense", H, inner)
        norm(p + "output.LayerNorm")
    dense("roberta.pooler.dense", H, H)
    torch.save(sd, os.path.join(path, "pytorch_model.bin"))


def en_config(ckpt: str):
    """en_newsplit at full width over the HF checkpoint at ``ckpt``: the
    encoder's shape from its config.json in bf16 (as build_pipeline sets it
    for --hf_encoder), BoW V 40,000, b64 x s128 (the reference's fixed
    window, fit_max_len's cap), one base epoch."""
    from carel_tpu_torch.config import PRESETS
    from carel_tpu_torch.models.hf_port import encoder_config_from_hf

    base = PRESETS[EN_PRESET]
    return dataclasses.replace(
        base,
        model=dataclasses.replace(
            base.model, encoder=encoder_config_from_hf(ckpt, "bfloat16"),
            bow_dim=EN_BOW_V, pretrained_encoder=ckpt),
        data=dataclasses.replace(base.data, max_len=128, tokenizer=ckpt),
        train=dataclasses.replace(
            base.train, batch_size=64, epochs=1,
            checkpoint_dir=os.path.join(RUN_DIR, "ckpt", EN_PRESET)))


def en_encoder_check(ckpt: str):
    """A check for phase_path's on_init: init_state must have put the
    checkpoint's weights into the encoder (bit-equal to hf_port's own
    load), and the loaded encoder in fp32 on the card (TF32 off) must give
    the pooled output the same weights give on the CPU in fp32, for a
    fixed batch of 8 x 128 ids with ragged pads, within the 1e-4 the tiny
    card-vs-CPU step holds its metrics to (normwise)."""
    from carel_tpu_torch.models.encoder import TransformerEncoder
    from carel_tpu_torch.models.hf_port import load_pretrained_encoder

    def check(state):
        t0 = time.perf_counter()
        cfg, sd = load_pretrained_encoder(ckpt, dtype="float32")
        got = state.model.encoder.state_dict()
        if got.keys() != sd.keys() or not all(
                torch.equal(got[k].cpu(), sd[k]) for k in sd):
            fail("en path: init_state did not load the HF checkpoint's "
                 "weights into the encoder")
        rng = np.random.default_rng(5)
        B, L = 8, 128
        mask = (np.arange(L)[None, :]
                < rng.integers(16, L + 1, B)[:, None]).astype(np.int64)
        ids = np.where(mask == 1, rng.integers(3, cfg.vocab_size, (B, L)),
                       cfg.pad_token_id)
        ids[:, 0] = 0  # <s>
        pooled = {}
        for dev in ("cpu", "cuda"):
            enc = TransformerEncoder(cfg)
            enc.load_state_dict(sd)
            enc.to(dev).eval()
            with torch.no_grad():
                pooled[dev] = enc(torch.tensor(ids, device=dev),
                                  torch.tensor(mask, device=dev))[1].cpu()
            del enc
        rel = relnorm(pooled["cuda"], pooled["cpu"])
        print(f"en path: init_state loaded the roberta-base-shaped "
              f"checkpoint ({sum(v.numel() for v in sd.values())} encoder "
              f"params) bit-equal; fp32 pooled output {B}x{L}, card vs "
              f"CPU: normwise rel {rel:.2e}, max abs "
              f"{float((pooled['cuda'] - pooled['cpu']).abs().max()):.2e} "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
        if not (torch.isfinite(pooled["cuda"]).all() and rel <= 1e-4):
            fail(f"en path: the loaded encoder's pooled output on the card "
                 f"is off the CPU's by {rel:.2e} normwise (> 1e-4)")
    return check


def phase_en(records: dict) -> dict:
    """en_newsplit at full width with a roberta-base-shaped encoder loaded
    through hf_port from a checkpoint written here: phase_path (one base
    epoch, evaluation, one self-training iteration with the preset's random
    strategy, the best saved and reloaded; K1-K4 and K10 on every step),
    the encoder check of en_encoder_check, and the captured step timed."""
    ckpt = os.path.join(RUN_DIR, "roberta_base_random")
    t0 = time.perf_counter()
    write_roberta_checkpoint(ckpt)
    print(f"en path: wrote a roberta-base-shaped HF checkpoint "
          f"({os.path.getsize(os.path.join(ckpt, 'pytorch_model.bin'))} "
          f"bytes) in {time.perf_counter() - t0:.1f} s", flush=True)
    return phase_path(records, EN_PRESET, 1, "random", cfg=en_config(ckpt),
                      on_init=en_encoder_check(ckpt), timed_epochs=True)


# synthetic zh clauses for the raw-text scorer (document 1: clause 3 holds
# the emotion)
ZH_CLAUSES = ["昨天下午下了很大的雨", "他没有带伞就出门了", "回到家里他非常难过",
              "因为新买的书全都湿了", "妈妈安慰他说没关系", "明天再去买一本新的"]


# batches of 512 served (the first is not timed) and scorer calls timed
SERVE_BATCHES = 21
SCORER_CALLS = 5


def phase_serve(records: dict):
    """Train, then serve, at full width with attention_impl="flash": the
    flagship takes one base epoch (the captured epoch step) with its
    evaluation and saves the best; a fresh model loads that checkpoint and
    serves a larger synthetic target domain of SERVE_BATCHES batches of 512
    through run_pair_inference (p50/p95 over the batches after the first)
    and raw zh pairs through PairScorer (timed: a document's six pairs and a
    full batch). Returns the run's peak memory in GiB."""
    from carel_tpu_torch import ops
    from carel_tpu_torch.data.tokenizer import ZhCharTokenizer
    from carel_tpu_torch.infer import PairScorer, run_pair_inference
    from carel_tpu_torch.pipeline import init_state
    from carel_tpu_torch.train import checkpoint as ckpt
    from carel_tpu_torch.train.loop import evaluate, train_epochs
    from carel_tpu_torch.train.steps import make_eval_step

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
    # serving only: a larger target domain, so that p50 and p95 come from
    # SERVE_BATCHES - 1 timed batches
    serve_pairs, serve, _ = synth_target_domain(
        np.random.default_rng(5), SERVE_BATCHES * cfg.train.eval_batch_size,
        L, enc.vocab_size, V)
    serve_pairs.num_unpred_emotions = unpred  # emotions stage 1 missed
    state = init_state(cfg, "cuda")
    counted_step, eval_step = CountedEpochStep(cfg), make_eval_step()
    forwards = []

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
    steps = counted_step.steps

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
        counted_eval, served, serve_pairs, serve,
        torch.Generator(device="cuda").manual_seed(0),
        cfg.train.eval_batch_size)
    ev = evaluate(counted_eval, served, serve, unpred,
                  torch.Generator(device="cuda").manual_seed(0),
                  cfg.train.eval_batch_size)

    tokenizer = ZhCharTokenizer.from_corpus(ZH_CLAUSES)
    scorer = PairScorer(cfg, served, tokenizer, batch_size=cfg.train.
                        eval_batch_size, device="cuda")
    raw = [(ZH_CLAUSES[2], c) for c in ZH_CLAUSES]
    probs = scorer.score_texts(raw)
    hits = scorer.extract_document(ZH_CLAUSES, [3], threshold=0.0)
    # every (emotion, cause) clause pair, repeated to one full batch
    full = [(e, c) for e in ZH_CLAUSES for c in ZH_CLAUSES]
    full = (full * -(-cfg.train.eval_batch_size // len(full)))[
        :cfg.train.eval_batch_size]
    scorer_ms = {}
    for name, pairs in (("document", raw), ("batch", full)):
        times = []
        for _ in range(SCORER_CALLS):
            t1 = time.perf_counter()
            scorer.score_texts(pairs)  # numpy out: the fetch is inside
            times.append(time.perf_counter() - t1)
        scorer_ms[name] = float(np.median(times)) * 1e3
    scored_batches = 2 + 2 * SCORER_CALLS
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    losses = counted_step.all_losses()

    n_batches = -(-len(serve) // cfg.train.eval_batch_size)
    print(f"{tag}: {steps} base steps + eval + best save and reload in "
          f"{t_train:.3f} s; best {best}; inference over {len(serve)} pairs "
          f"in {n_batches} batches of {cfg.train.eval_batch_size}: P/R/F1 "
          f"{res.precision:.4f} {res.recall:.4f} {res.f1:.4f}, p50 "
          f"{res.p50_batch_ms:.2f} ms, p95 {res.p95_batch_ms:.2f} ms per "
          f"batch over {n_batches - 1} timed batches, "
          f"{res.pairs_per_sec:.1f} pairs/s (first batch excluded); scorer "
          f"probabilities {[round(float(p), 4) for p in probs]}, "
          f"{len(hits)} candidate pairs; PairScorer.score_texts median of "
          f"{SCORER_CALLS}: {scorer_ms['document']:.2f} ms for "
          f"{len(raw)} pairs, {scorer_ms['batch']:.2f} ms for {len(full)} "
          f"pairs ({len(full) / scorer_ms['batch'] * 1e3:.1f} pairs/s); "
          f"launches {counts}; {counted_step.describe()}; peak memory "
          f"{peak_gib:.2f} GiB", flush=True)
    print(f"{tag}: losses (every step) {[round(x, 4) for x in losses]}",
          flush=True)
    if steps != n_train // B or not all(math.isfinite(x) for x in losses):
        fail(f"{tag}: {steps} steps, or a loss not finite")
    counted_step.check(tag, steps)
    if n_batches < SERVE_BATCHES:
        fail(f"{tag}: served {n_batches} batches, fewer than "
             f"{SERVE_BATCHES}")
    if not probabilities(res.probs, len(serve)):
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
    want = dict.fromkeys(PATH_KERNELS[FLAGSHIP], steps)
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
    return dict(peak_gib=peak_gib, served=served)


def same_state(a: dict, b: dict) -> bool:
    """Two state_dicts with the same keys and bitwise equal tensors."""
    return a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)


# (start us, kernel name) of every device kernel of the last profile_epoch
LAST_PROFILE: list = []


def largest_gap(name: str) -> str:
    """Where the last profile's launches of kernel ``name`` (a wrapper's
    name) lie furthest apart: the place of a launch it lacks."""
    starts = sorted(t for t, k in LAST_PROFILE if name in k)
    gaps = np.diff(starts)
    if not len(gaps):
        return f"{len(starts)} launches"
    i = int(np.argmax(gaps))
    return (f"{len(starts)} launches, the widest gap {gaps[i]:.1f} us after "
            f"launch {i} (median gap {float(np.median(gaps)):.1f} us)")


def profile_epoch(run, nb: int):
    """Device time per step by kernel, from torch.profiler over one epoch of
    nb steps (``run()``, ended by a synchronize): returns the device ms/step,
    the kernels/step and {name: calls} of every device kernel. A window
    without a device event is profiled again, as in device_profile."""
    for window in range(1, 4):
        with guarded_profile() as prof:
            run()
            torch.cuda.synchronize()
        per_kernel: dict = {}
        LAST_PROFILE.clear()
        for e in device_events(prof):
            us, calls = per_kernel.get(e.name, (0.0, 0))
            per_kernel[e.name] = (us + e.time_range.elapsed_us(), calls + 1)
            LAST_PROFILE.append((e.time_range.start, e.name))
        PROFILE_WINDOWS["profiled"] += 1
        device_ms = sum(us for us, _ in per_kernel.values()) / 1e3 / nb
        if device_ms > 0.0:
            kernels = sum(c for _, c in per_kernel.values()) / nb
            return device_ms, kernels, per_kernel
        PROFILE_WINDOWS["empty"] += 1
        print(f"profile_epoch: the profiler recorded no device time in "
              f"window {window} of 3", flush=True)
    fail("profile_epoch: the profiler recorded no device time")


def path_kernel_calls(preset: str, attention_impl: str) -> dict:
    """The kernels one training step of this variant launches: {wrapper
    name: launches}; the profiler names each device kernel after its
    wrapper (mmd_fwd_kernel, flash_fwd_mma_kernel, ...)."""
    want = {name: KERNELS_A_CALL.get(name, 1)
            for name in PATH_KERNELS[preset]}
    layers = 12
    if attention_impl == "flash":
        want.update(flash_fwd=layers, flash_bwd_dkv=layers,
                    flash_bwd_dq=layers)
    else:
        want.update(xla_attn_fwd=layers, xla_attn_bwd=layers)
    return want


def kernel_calls_by_wrapper(per_kernel: dict, nb: int) -> dict:
    """{wrapper name: device launches a step} of the profiled kernels whose
    names carry a wrapper's name (``flash_bwd_dq`` is not a prefix of
    ``flash_bwd_dkv``)."""
    from carel_tpu_torch import ops

    return {name: sum(c for k, (_, c) in per_kernel.items() if name in k) / nb
            for name in ops.launch_counts()}


def eager_epoch(step, state, arrays, B: int, seed: int, vi_beta: float):
    """One epoch of the per-step loop as train_epochs runs it under
    --no_scan_epoch (batches prefetched to the card two ahead): the losses
    of its batches, on the card."""
    from carel_tpu_torch.data.batching import iter_batches
    from carel_tpu_torch.data.prefetch import prefetch_to_device

    batches = prefetch_to_device(
        iter_batches(arrays, B, shuffle=True, rng=np.random.default_rng(seed)),
        size=2, transform=lambda b: b.as_dict(), device="cuda")
    return torch.stack([step(state, batch, it, vi_beta)["loss"]
                        for it, batch in enumerate(batches)])


def captured_epoch(step, state, arrays, B: int, seed: int, vi_beta: float):
    """One epoch of the default epoch step over the same batches."""
    from carel_tpu_torch.train.scan_epoch import stack_epoch

    return step(state, stack_epoch(arrays, B, np.random.default_rng(seed)),
                vi_beta)


def param_gaps(cfg, labels: dict, got: dict, want: dict) -> dict:
    """How far two runs' params lie apart, each group by its own lr: the
    worst entry (and its tensor), the entries past 2 lr, and the largest
    99th percentile over the tensors."""
    from carel_tpu_torch.train.state import CLUB, DISC

    lrs = {DISC: cfg.train.adv_lr, CLUB: cfg.train.aprx_lr}
    gaps = dict(worst=0.0, where="", past=0, bulk=0.0)
    for name, p in want.items():
        err = ((got[name] - p).abs().flatten()
               / lrs.get(labels[name], cfg.train.vae_lr)).double()
        if float(err.max()) > gaps["worst"]:
            gaps.update(worst=float(err.max()), where=name)
        gaps["past"] += int((err > 2.0).sum())
        gaps["bulk"] = max(gaps["bulk"], float(torch.quantile(err, 0.99)))
    return gaps


def describe_gaps(gaps: dict) -> str:
    return (f"worst {gaps['worst']:.3e} lr ({gaps['where']}), {gaps['past']} "
            f"entries past 2 lr, 99th percentile of every tensor <= "
            f"{gaps['bulk']:.3e} lr")


def loss_gap(got: torch.Tensor, want: torch.Tensor) -> float:
    """The largest relative difference of two runs' per-batch losses."""
    return float(((got - want).abs() / want.abs()).max())


@contextlib.contextmanager
def deterministic_audit():
    """torch's deterministic algorithms, warn_only, for the enclosed work.
    Yields a list that is filled when the block ends: the ops torch warned
    have no deterministic version, the gate's business, then (prefixed
    "note:") its other determinism warnings, which the caller prints; the
    cuBLAS workspace warning is one of those (it is about cuBLAS's
    configuration, and the repeats the caller holds bit-equal show it
    changes nothing on one stream). The port never turns the switch on."""
    import warnings

    warned: list = []
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            yield warned
            torch.cuda.synchronize()
        msgs = sorted({str(w.message) for w in caught
                       if "determinis" in str(w.message)})
        warned += [m.split(" does not have")[0] for m in msgs
                   if "does not have a deterministic" in m]
        warned += [f"note: {m[:160]}" for m in msgs
                   if "does not have a deterministic" not in m]
    finally:
        torch.use_deterministic_algorithms(False)


def hold_captured(tag: str, cfg, labels: dict, eager: dict, cap: dict,
                  steps: int) -> None:
    """Hold a captured run against an eager one of the same steps from the
    same state: per-batch losses within rel 1e-5 and every group's params
    within 2 x its lr."""
    gap = (loss_gap(cap["losses"], eager["losses"]),
           param_gaps(cfg, labels, cap["params"], eager["params"]))
    print(f"{tag}: {steps} steps from one state; "
          f"captured against eager: losses rel {gap[0]:.3e} (batch 0 "
          f"equal: {bool(cap['losses'][0] == eager['losses'][0])}), params "
          f"{describe_gaps(gap[1])}", flush=True)
    if gap[0] > 1e-5:
        fail(f"{tag}: eager and captured losses differ by rel {gap[0]:.3e}")
    if gap[1]["worst"] > 2.0:
        fail(f"{tag}: eager and captured params differ by "
             f"{gap[1]['worst']:.3e} lr")


CAPTURE_VARIANTS = ((FLAGSHIP, "xla"), ("ec_hsic", "xla"),
                    ("ec_gan", "xla"), ("ec_vi_final", "xla"),
                    (FLAGSHIP, "flash"))


def phase_capture(preset: str, attention_impl: str) -> dict:
    """One step variant at full width (b64 x s96, the paths' 1,024 random
    train pairs), from one initial state (init_state of one seed, which
    also seeds the dropout generator), every run as the paths run it (no
    deterministic algorithms):
    - correctness: one epoch of the eager per-step loop and one through the
      captured epoch step, held by hold_captured; the generators must end
      alike, and the disc, club and frozen groups move as on the paths;
    - repeatability: a second eager and a second captured run from the same
      state must give the bits of the first in their first epoch, losses
      and params (K4 adds the BoW backward's corrections in a fixed
      order);
    - the deterministic-algorithms audit: a third eager run under
      torch.use_deterministic_algorithms(True, warn_only=True) must give
      the same bits again, and torch must warn of no op without a
      deterministic version;
    - time: after their first epoch the second eager and captured runs take
      three timed epochs and one profiled (time_epochs), each run alone on
      the card so that its peak memory is its own."""
    from carel_tpu_torch.pipeline import init_state
    from carel_tpu_torch.train.scan_epoch import make_epoch_step
    from carel_tpu_torch.train.state import (CLUB, DISC, FROZEN,
                                             dropout_generator)
    from carel_tpu_torch.train.steps import make_train_step

    name = preset if attention_impl == "xla" else "flash"
    tag = f"capture {name}"
    cfg = full_width_config(preset, f"capture_{name}",
                            attention_impl=attention_impl)
    enc, B, L = cfg.model.encoder, cfg.train.batch_size, cfg.data.max_len
    train = synth_pair_arrays(np.random.default_rng(0), 1024, L,
                              enc.vocab_size, cfg.model.bow_dim)
    nb = -(-len(train) // B)
    want_calls = path_kernel_calls(preset, attention_impl)
    want_moved = {DISC: preset == "ec_gan", CLUB: preset == "ec_vi_final",
                  FROZEN: False}
    dropout = dropout_generator(torch.device("cuda"))
    runs = {}
    for kind, mode in (("eager", "check"), ("captured", "check"),
                       ("eager", "time"), ("eager", "audit"),
                       ("captured", "time")):
        if (kind, mode) == ("eager", "time"):
            # held now, so that the checked params leave the card before
            # the timed runs measure their peak memory
            hold_captured(tag, cfg, labels, runs["eager", "check"],
                          runs["captured", "check"], nb)
            for r in runs.values():
                r["params"] = {n: p.cpu() for n, p in r["params"].items()}
        make, run = ((make_train_step, eager_epoch) if kind == "eager"
                     else (make_epoch_step, captured_epoch))
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        state = init_state(cfg, "cuda")
        step = make(cfg)
        if mode == "check":
            first = {n: p.detach().clone() for n, p in
                     state.model.named_parameters()
                     if state.labels[n] in want_moved}
        with deterministic_audit() if mode == "audit" \
                else contextlib.nullcontext() as warned:
            losses = run(step, state, train, B, 1, 0.0).cpu()
        if not torch.isfinite(losses).all():
            fail(f"{tag} ({kind}): a loss is not finite")
        r = runs[kind, mode] = dict(
            losses=losses,
            gens=(state.generator.get_state(), dropout.get_state()),
            captures=getattr(step, "captures", None))
        if mode == "check":
            r["params"] = {n: p.detach().clone() for n, p in
                           state.model.named_parameters()}
            moved = {DISC: False, CLUB: False, FROZEN: False}
            for n, p in first.items():
                moved[state.labels[n]] |= not torch.equal(r["params"][n], p)
            if moved != want_moved:
                fail(f"{tag} ({kind}): the disc, club and frozen params "
                     f"moved as {moved} (want {want_moved})")
        else:
            # the first epoch again from the same state: the same bits
            want = runs[kind, "check"]
            same_params = all(torch.equal(p.detach().cpu(), want["params"][n])
                              for n, p in state.model.named_parameters())
            same = torch.equal(losses, want["losses"]) and same_params
            print(f"{tag} ({kind}, {mode}): one epoch from the same state "
                  f"again: losses and params bit-equal to the first run: "
                  f"{same}" + (f"; torch warned {warned}" if mode == "audit"
                               else ""), flush=True)
            if not same:
                fail(f"{tag}: a second {kind} epoch from one state gives "
                     f"other bits ({mode}; losses rel "
                     f"{loss_gap(losses, want['losses']):.3e})")
            ops_warned = [w for w in warned or ()
                          if not w.startswith("note:")]
            if mode == "audit" and ops_warned:
                fail(f"{tag}: deterministic algorithms warn of {ops_warned}")
        if mode == "time":
            r.update(time_epochs(tag, kind, run, step, state, train, B, nb,
                                 want_calls))
            r["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        labels = state.labels
        del state, step
    for mode in ("check", "time"):
        if not all(torch.equal(a, b) for a, b in zip(
                runs["captured", mode]["gens"], runs["eager", mode]["gens"])):
            fail(f"{tag}: the generators end in other states ({mode})")
    if runs["captured", "time"]["captures"] != 1:
        fail(f"{tag}: {runs['captured', 'time']['captures']} captures for "
             "its epochs (want one)")
    eager, cap = runs["eager", "time"], runs["captured", "time"]
    for kind, r in (("eager", eager), ("captured", cap)):
        print(f"{tag} ({kind}) b{B}xs{L}: wall {r['wall_ms']:.2f} ms/step "
              f"(median of {[round(w, 2) for w in r['walls']]}; "
              f"{B / r['wall_ms'] * 1e3:.1f} pairs/s), device "
              f"{r['device_ms']:.2f} ms/step (busy "
              f"{r['device_ms'] / r['wall_ms']:.3f}), {r['kernels']:.1f} "
              f"kernels/step, path kernels a step "
              f"{ {k: n for k, n in r['calls'].items() if n} }, peak memory "
              f"{r['peak_gib']:.2f} GiB", flush=True)
    return {kind: {k: r[k] for k in
                   ("wall_ms", "device_ms", "kernels", "peak_gib")}
            for kind, r in (("eager", eager), ("captured", cap))}


def time_epochs(tag: str, kind: str, run, step, state, train, B: int,
                nb: int, want_calls: dict, epochs: int = 3) -> dict:
    """``epochs`` more epochs, each timed (host clock around a value fetch
    after all its steps), and one profiled, in which each path kernel must
    launch as often a step as ``want_calls`` says (an epoch whose profile
    dropped a launch is profiled again, up to three in all): the median
    epoch's wall ms/step (and the range), device ms/step, kernels/step and
    the path kernels a step."""
    walls = []
    for epoch in range(epochs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses = run(step, state, train, B, 2 + epoch, 0.0).cpu()
        walls.append((time.perf_counter() - t0) / nb * 1e3)
        if not torch.isfinite(losses).all():
            fail(f"{tag} ({kind}): a timed loss is not finite")
    # the profiler now and then drops a device event (a fractional count
    # a step); such an epoch is profiled again, up to three in all, and
    # counted in PROFILE_WINDOWS, which main prints
    for window in range(1, 4):
        device_ms, kernels, per_kernel = profile_epoch(
            lambda: run(step, state, train, B, 2 + epochs + window, 0.0), nb)
        calls = kernel_calls_by_wrapper(per_kernel, nb)
        off = {k: n for k, n in calls.items() if n != want_calls.get(k, 0)}
        if not off:
            break
        PROFILE_WINDOWS["short"] += 1
        print(f"{tag} ({kind}): the profile shows {off} a step (want "
              f"{ {k: want_calls.get(k, 0) for k in off} }) in window "
              f"{window} of 3: "
              + "; ".join(f"{k}: {largest_gap(k)}" for k in off), flush=True)
    else:
        fail(f"{tag} ({kind}): three profiles show the path kernels {off} "
             f"times a step (want "
             f"{ {k: want_calls.get(k, 0) for k in off} })")
    return dict(wall_ms=float(np.median(walls)), walls=walls,
                device_ms=device_ms, kernels=kernels, calls=calls)


def phase_sensitivity(preset: str) -> None:
    """A constant baked into the graph would show here: the tiny fp32
    model with dropout, kl_ann_iterations 4 (the KL weight ramps over the
    first four batches of each epoch) and vi_beta_step 0.5 (vi_beta 0, then
    0.5), two epochs of six batches with the main lr halved between them,
    eager and captured from one state, held as hold_captured says."""
    from carel_tpu_torch.pipeline import init_state
    from carel_tpu_torch.train.scan_epoch import make_epoch_step
    from carel_tpu_torch.train.state import set_lr
    from carel_tpu_torch.train.steps import make_train_step

    tag = f"sensitivity {preset}"
    base = tiny_config(preset)
    cfg = dataclasses.replace(
        base,
        model=dataclasses.replace(base.model, dropout=0.1, encoder=(
            dataclasses.replace(base.model.encoder, dropout=0.1))),
        loss=dataclasses.replace(base.loss, kl_ann_iterations=4,
                                 vi_beta_step=0.5))
    train = synth_pair_arrays(np.random.default_rng(6), 90, 32, 256, 3000,
                              min_len=8)
    B = cfg.train.batch_size
    runs = {}
    for kind, make, run in (("eager", make_train_step, eager_epoch),
                            ("captured", make_epoch_step, captured_epoch)):
        state = init_state(cfg, "cuda")
        step = make(cfg)
        losses = []
        for epoch in range(2):
            losses.append(run(step, state, train, B, epoch,
                              epoch * cfg.loss.vi_beta_step))
            set_lr(state.optimizer, cfg.train.vae_lr / 2)
        runs[kind] = dict(losses=torch.cat(losses).cpu(), params={
            n: p.detach().clone() for n, p in state.model.named_parameters()})
        labels = state.labels
    hold_captured(f"{tag} (tiny, 2 epochs)", cfg, labels, runs["eager"],
                  runs["captured"], len(runs["eager"]["losses"]))


# the stage-1 and DANN paths' vocabulary: 21,000 CJK characters (a
# ZhCharTokenizer of 21,120 entries; the encoder keeps BERT-zh's 21,128)
ZH_CHARS = [chr(0x4E00 + i) for i in range(21000)]


def synth_docs(rng, n_docs: int, max_clauses: int):
    """Documents of 3..max_clauses clauses of 5-25 random characters, each
    with one gold pair; every clause has a random emotion code: 0 half the
    time, else 1-6 alike (the gold emotion clause's 1-5), so that a few
    steps teach a model to predict emotion clauses."""
    from carel_tpu_torch.data.ecpe_format import Clause, Document

    docs = []
    for d in range(n_docs):
        n = int(rng.integers(3, max_clauses + 1))
        emo = int(rng.integers(1, n + 1))
        cause = int(np.clip(emo + rng.integers(-2, 2), 1, n))
        clauses = []
        for c in range(1, n + 1):
            code = 0 if rng.random() < 0.5 else int(
                rng.integers(1, 6 if c == emo else 7))
            text = "".join(ZH_CHARS[i] for i in rng.integers(
                0, len(ZH_CHARS), int(rng.integers(5, 26))))
            clauses.append(Clause(sen_id=c, emotion=code, cause=6, text=text,
                                  emotion_raw=str(code), cause_raw="6",
                                  text_field3=text))
        docs.append(Document(doc_id=str(d + 1), pairs=[(emo, cause)],
                             clauses=clauses))
    return docs


def step_numbers(step, steps: int = 5) -> dict:
    """Wall ms/step (host clock over ``steps`` steps, ended by a
    synchronize) and the profiler's device ms/step and kernels/step of
    ``step()``."""
    step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        step()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / steps * 1e3
    dev, kernels = device_profile(step, iters=steps, warmup=1)
    return dict(wall_ms=wall, device_ms=dev, kernels=kernels)


def count_path_launches(records: dict, tag: str, counts: dict,
                        want: dict) -> None:
    """Every kernel launched as ``want`` says on this path (0 where it
    names none), recorded under the path's tag."""
    for name, n in counts.items():
        if n != want.get(name, 0):
            fail(f"{tag}: kernel {name} launched {n} times (want "
                 f"{want.get(name, 0)})")
        records[name].setdefault("launches_by_path", {})[tag] = n
        records[name]["launches"] = sum(
            records[name]["launches_by_path"].values())


def xla_attention_launches(tag: str, counts: dict, layers: int, steps: int,
                           forwards: Optional[int] = None) -> dict:
    """The xla attention pair's launches on a bf16 path of the default
    attention, as ``want`` entries: a backward a layer of each of ``steps``
    training steps, and a forward a layer of each step and of each
    forward-only batch, ``forwards`` of them where the phase counts them,
    else a whole number of encoder forwards besides the steps."""
    fwd, bwd = counts.get("xla_attn_fwd", 0), counts.get("xla_attn_bwd", 0)
    ok = bwd == layers * steps and fwd >= bwd and fwd % layers == 0
    if forwards is not None:
        ok = ok and fwd == layers * (steps + forwards)
    if not ok:
        fail(f"{tag}: the xla attention kernels launched {fwd} forwards and "
             f"{bwd} backwards for {layers} layers, {steps} steps and "
             f"{'some' if forwards is None else forwards} forward-only "
             "batches")
    return {"xla_attn_fwd": fwd, "xla_attn_bwd": bwd}


def phase_reference_stage1() -> None:
    """Tiny fp32 models take one step on the card and on the CPU from the
    same weights and batch: a stage-1 step (carried Adam) under each clause
    mixer, and a DANN step (Adam, the domain loss through the gradient
    reversal, the batch norm's running statistics). Losses rel 1e-5, the
    gradients normwise 1e-4 (all at once), the running statistics abs 1e-5,
    params within
    2 x lr, and within 1e-3 x lr where |g| is above both 1e-3 max|g| of its
    tensor and 100 x Adam's eps (there the first step is lr times the sign
    of g, whatever the rounding). On the card the LSTM runs on cuDNN in fp32
    (TF32 off)."""
    from carel_tpu_torch.data.tokenizer import ZhCharTokenizer
    from carel_tpu_torch.models.encoder import tiny_encoder_config
    from carel_tpu_torch.models import dann
    from carel_tpu_torch.stage1 import build_doc_arrays
    from carel_tpu_torch.stage1.dann_driver import (DannConfig,
                                                    build_dann_model,
                                                    encode_clauses)
    from carel_tpu_torch.stage1.trainer import (Stage1Config,
                                                build_stage1_model,
                                                make_stage1_step, to_device)

    rng = np.random.default_rng(8)
    tok = ZhCharTokenizer(ZH_CHARS[:250])
    enc = tiny_encoder_config(vocab_size=tok.vocab_size, dropout=0.0)
    docs = synth_docs(rng, 4, 20)
    for d in docs:
        for c in d.clauses:
            c.text = "".join(ZH_CHARS[ord(ch) % 250] for ch in c.text)
    arr = build_doc_arrays(docs, tok)
    lr = 1e-3

    def compare(tag, out, stats=()):
        (loss_g, p_g, g_g), (loss_c, p_c, g_c) = out["cuda"], out["cpu"]
        rel = abs(loss_g - loss_c) / abs(loss_c)
        # normwise over all the gradients at once: a gradient that is 0 in
        # exact arithmetic (the attention's key bias) is rounding on both
        # sides, and a tensor's own relative error is meaningless there
        grad = math.sqrt(sum(float(((g_g[n] - g_c[n]).double() ** 2).sum())
                             for n in g_c)
                         / sum(float((g.double() ** 2).sum())
                               for g in g_c.values()))
        worst = max(float((p_g[n] - p_c[n]).abs().max()) for n in p_c) / lr
        safe = max(float(torch.cat([
            (p_g[n] - p_c[n])[(g.abs() > 1e-3 * g.abs().max())
                              & (g.abs() > 1e-6)].abs(),
            torch.zeros(1)]).max()) for n, g in g_c.items()) / lr
        stat = max((float((p_g[n] - p_c[n]).abs().max()) for n in stats),
                   default=0.0)
        print(f"reference step {tag} (tiny fp32, card vs CPU): loss "
              f"{loss_g:.7f} vs {loss_c:.7f} rel {rel:.2e}; grads normwise "
              f"{grad:.2e}; params {worst:.2e} lr ({safe:.2e} lr where the "
              f"sign of g is safe)"
              + (f"; running statistics abs {stat:.2e}" if stats else ""),
              flush=True)
        if not (rel <= 1e-5 and grad <= 1e-4 and worst <= 2
                and safe <= 1e-3 and stat <= 1e-5):
            fail(f"card and CPU disagree on the {tag} reference step")

    def kept(model):
        return ({n: p.detach().cpu() for n, p in model.state_dict().items()},
                {n: p.grad.cpu() for n, p in model.named_parameters()
                 if p.grad is not None})

    for mixer in ("bilstm", "transformer"):
        cfg = Stage1Config(n_hidden=16, clause_mixer=mixer, fresh_adam=False,
                           learning_rate=lr)
        out = {}
        for dev in ("cpu", "cuda"):
            model = build_stage1_model(cfg, enc, dev)
            opt = torch.optim.Adam([p for p in model.parameters()
                                    if p.requires_grad], lr=lr, eps=1e-8)
            loss = make_stage1_step(cfg, model, opt)(
                to_device(arr, np.arange(4), torch.device(dev)))
            out[dev] = (float(loss), *kept(model))
        compare(f"stage1 {mixer}", out)

    sents = [c.text for d in docs for c in d.clauses]
    data = encode_clauses(tok, sents, [c.emotion for d in docs
                                       for c in d.clauses], 32)
    labeled = {k: v[:4] for k, v in data.items()}  # one step of 8
    cfg = DannConfig(learning_rate=lr)
    out = {}
    for dev in ("cpu", "cuda"):
        model = build_dann_model(cfg, enc, dev, dropout=0.0)
        losses = []
        dann.train_dann(model, labeled, data, epochs=1, batch_size=8,
                        learning_rate=lr, seed=1, losses=losses)
        out[dev] = (float(sum(losses[0])), *kept(model))
    compare("dann", out,
            stats=("batchnorm_l.running_mean", "batchnorm_l.running_var"))


STAGE1_RUNS = (("bilstm", "xla", False), ("transformer", "flash", True))


def phase_stage1(records: dict, mixer: str, impl: str, carried: bool
                 ) -> dict:
    """Stage 1 at full width (12L/768H bf16 encoder, vocab 21,128; batches
    of 4 documents x 75 clauses x 60 tokens, so the encoder sees 300 x 60; n
    hidden 100) on 16 train synthetic documents of 3-75 clauses and 8 test
    documents of 3-20:
    one base epoch and one self-training epoch (threshold 0, so the pseudo
    set grows), evaluations over all 8 documents (600 sequences) at once.
    The losses must be finite, the probabilities in [0, 1] and the pair
    file's predictions the argmax of the best snapshot's, read back by the
    port's build_pairs(test=True) with the forced misses those predictions
    give and at least one predicted pair; the best snapshot shares no
    storage with the live params and a later step leaves it as it was;
    three steps from one state repeat their bits; K7-K9 launch once a layer
    on every forward (and K8/K9 on every step) under flash, K10 once
    a step, and no other kernel of the port. Then it times the step and
    the evaluation."""
    from carel_tpu_torch import ops
    from carel_tpu_torch.config import EncoderConfig
    from carel_tpu_torch.data.ecpe_format import parse_ecpe_file
    from carel_tpu_torch.data.pairs import build_pairs
    from carel_tpu_torch.data.tokenizer import ZhCharTokenizer
    from carel_tpu_torch.stage1 import build_doc_arrays
    from carel_tpu_torch.stage1.trainer import (Stage1Config,
                                                build_stage1_model,
                                                fit_stage1,
                                                make_stage1_step,
                                                predict_docs, snapshot,
                                                to_device)

    run = f"stage1_{mixer}"
    tag = f"stage1 path ({mixer}, {impl} attention, " \
        + ("carried Adam)" if carried else "fresh Adam)")
    rng = np.random.default_rng(7)
    tok = ZhCharTokenizer(ZH_CHARS)
    train = build_doc_arrays(synth_docs(rng, 16, 75), tok)
    # test documents of 3-20 clauses, padded to 75 as every document: the
    # pseudo labels (one emotion clause a document, the rest class 6) do
    # not outnumber the training set's emotion clauses, so the self-trained
    # best still predicts some and the pair file holds pairs to read back
    test = build_doc_arrays(synth_docs(rng, 8, 20), tok)
    cfg = Stage1Config(training_epoch=1, self_epoch=1, threshold=0.0,
                       clause_mixer=mixer, fresh_adam=not carried,
                       save_dir=os.path.join(RUN_DIR, run))
    enc = EncoderConfig(arch="bert", dtype="bfloat16", attention_impl=impl)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = build_stage1_model(cfg, enc, "cuda")
    t_init = time.perf_counter() - t0
    logger, losses = _Records(), []
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    best_state, best, pair_file = fit_stage1(cfg, model, train, test, tok,
                                             logger, losses=losses)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    losses = torch.stack(losses).tolist()
    events = [r["event"] for r in logger.records]
    evals = events.count("stage1_eval") + events.count("stage1_self_eval")
    print(f"{tag}: init {t_init:.1f} s; {len(losses)} steps and {evals} "
          f"evaluations in {wall:.2f} s; events {events}; best {best}; "
          f"losses {[round(x, 4) for x in losses]}; launches "
          f"{ {k: n for k, n in counts.items() if n} }", flush=True)
    if not losses or not all(math.isfinite(x) for x in losses):
        fail(f"{tag}: a loss is not finite")
    if "stage1_selftrain" not in events or pair_file is None:
        fail(f"{tag}: the self-training set did not grow, or no pair file")
    layers = enc.num_layers
    want = {"emb_bwd": len(losses)}
    if impl == "flash":
        want.update(flash_fwd=layers * (len(losses) + evals),
                    flash_bwd_dkv=layers * len(losses),
                    flash_bwd_dq=layers * len(losses))
    else:
        want.update(xla_attention_launches(tag, counts, layers, len(losses),
                                           evals))
    count_path_launches(records, run, counts, want)

    # the best snapshot is a copy: no shared storage, and a step leaves it
    live = {t.untyped_storage().data_ptr()
            for t in model.state_dict().values()}
    if any(t.untyped_storage().data_ptr() in live
           for t in best_state.values()):
        fail(f"{tag}: the best snapshot shares storage with the live model")
    kept = {k: v.clone() for k, v in best_state.items()}
    step = make_stage1_step(cfg, model, None if not carried else
                            torch.optim.Adam([p for p in model.parameters()
                                              if p.requires_grad],
                                             lr=cfg.learning_rate,
                                             fused=True))
    batch = to_device(train, np.arange(cfg.batch_size), torch.device("cuda"))
    step(batch)
    if not same_state(kept, best_state) or same_state(
            kept, model.state_dict()):
        fail(f"{tag}: the best snapshot moved with the live params")

    # three steps from one state (the same dropout draws) repeat their
    # bits: the clause mixer on the card (cuDNN's LSTM) included
    start, rng_state = snapshot(model), torch.cuda.get_rng_state()
    fresh = make_stage1_step(dataclasses.replace(cfg, fresh_adam=True), model)
    batches = [to_device(train, np.arange(i, i + cfg.batch_size),
                         torch.device("cuda"))
               for i in range(0, 3 * cfg.batch_size, cfg.batch_size)]
    repeats = []
    for _ in range(2):
        model.load_state_dict(start)
        torch.cuda.set_rng_state(rng_state)
        repeats.append((torch.stack([fresh(b) for b in batches]),
                        snapshot(model)))
    same = torch.equal(repeats[0][0], repeats[1][0]) and same_state(
        repeats[0][1], repeats[1][1])
    print(f"{tag}: three steps from one state twice, losses and params "
          f"bit-equal: {same}", flush=True)
    if not same:
        fail(f"{tag}: steps from one state do not repeat their bits")
    del start, repeats, batches

    # the pair file: the best snapshot's argmax, read back with its misses
    model.load_state_dict(best_state)
    probs = predict_docs(model, test, torch.device("cuda"))
    if not (probs.shape == (8, 75, 7) and np.all(np.isfinite(probs))
            and probs.min() >= 0.0 and probs.max() <= 1.0):
        fail(f"{tag}: probabilities are not finite values in [0, 1]")
    pred = probs.argmax(-1)
    written = parse_ecpe_file(pair_file)
    got = [[c.emotion for c in d.clauses] for d in written]
    if got != [list(pred[i, :test.doc_len[i]]) for i in range(len(test))]:
        fail(f"{tag}: the pair file's predictions are not the best "
             "snapshot's")
    misses = sum(int(pred[i, d.pairs[0][0] - 1] == 6)
                 for i, d in enumerate(written))
    pairs = build_pairs(written, test=True)
    print(f"{tag}: pair file {os.path.basename(pair_file)}: "
          f"{len(written)} documents, {len(pairs)} test pairs, "
          f"{pairs.num_unpred_emotions} forced misses (want {misses}); best "
          "snapshot kept apart from the live params", flush=True)
    if pairs.num_unpred_emotions != misses:
        fail(f"{tag}: build_pairs counts {pairs.num_unpred_emotions} forced "
             f"misses (want {misses})")
    if not len(pairs):
        fail(f"{tag}: the pair file holds no predicted pair to read back")

    nums = step_numbers(lambda: step(batch))
    ev = step_numbers(lambda: predict_docs(model, test,
                                           torch.device("cuda")), steps=3)
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"{tag} b4x75x60: step wall {nums['wall_ms']:.2f} ms (device "
          f"{nums['device_ms']:.2f} ms, busy "
          f"{nums['device_ms'] / nums['wall_ms']:.3f}, "
          f"{nums['kernels']:.1f} kernels), "
          f"{cfg.batch_size / nums['wall_ms'] * 1e3:.1f} documents/s; "
          f"evaluation of 8 documents (600 x 60) wall {ev['wall_ms']:.2f} "
          f"ms (device {ev['device_ms']:.2f} ms, {ev['kernels']:.1f} "
          f"kernels), {8 / ev['wall_ms'] * 1e3:.1f} documents/s; peak "
          f"memory {peak:.2f} GiB", flush=True)
    return dict(nums, eval_wall_ms=ev["wall_ms"],
                eval_device_ms=ev["device_ms"], peak_gib=peak)


def phase_dann(records: dict) -> dict:
    """The clause-level DANN at full width (12L/768H bf16 encoder; batches
    of 32 clauses x 128 tokens, predictions in batches of 256) on synthetic
    domain files (~320 source and ~300 target clauses): one base epoch and
    one self-training iteration of one epoch, the domain loss on. The
    losses must be finite, the running statistics must move, K10 (once a
    step) and the xla attention pair (the default attention) alone of the
    port's kernels launch,
    the gradient reversal must send the domain head's gradient back to the
    features as -3 times itself, and three steps from one state must give
    the same losses, params and running statistics bit for bit. Then it
    times a step and a prediction batch."""
    from carel_tpu_torch import ops
    from carel_tpu_torch.config import EncoderConfig
    from carel_tpu_torch.data.ecpe_format import write_ecpe_file
    from carel_tpu_torch.data.tokenizer import ZhCharTokenizer
    from carel_tpu_torch.models import dann
    from carel_tpu_torch.stage1.dann_driver import (DannConfig,
                                                    build_dann_model,
                                                    encode_clauses,
                                                    fit_dann, read_domains)
    from carel_tpu_torch.stage1.trainer import snapshot

    tag = "dann path (xla attention)"
    root = os.path.join(RUN_DIR, "dann")
    rng = np.random.default_rng(9)
    cfg = DannConfig(epochs=1, self_iteration=1, self_epochs=1)
    for name, n_docs in ((cfg.source_domain, 40), (cfg.target_domain, 38)):
        path = os.path.join(root, cfg.doc_dir, f"{name}.txt")
        os.makedirs(os.path.dirname(path), exist_ok=True)
        write_ecpe_file(path, synth_docs(rng, n_docs, 12))
    tok = ZhCharTokenizer(ZH_CHARS)
    source, target = (encode_clauses(tok, sent, y, cfg.max_len)
                      for sent, y in read_domains(cfg, root))
    enc = EncoderConfig(arch="bert", dtype="bfloat16")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = build_dann_model(cfg, enc, "cuda")
    stats0 = {k: v.clone() for k, v in model.state_dict().items()
              if k.startswith("batchnorm_l.running")}
    logger, losses = _Records(), []
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    res = fit_dann(cfg, model, source, target, logger, losses)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    flat = torch.stack([torch.stack(pair) for pair in losses]).cpu()
    events = [r["event"] for r in logger.records]
    print(f"{tag}: {len(source['labels'])} source and "
          f"{len(target['labels'])} target clauses; {len(losses)} steps in "
          f"{wall:.2f} s with their evaluations; events {events}; base "
          f"{res['base']}, best {res['best']}", flush=True)
    if not losses or not bool(torch.isfinite(flat).all()):
        fail(f"{tag}: a loss is not finite")
    if "dann_selftrain" not in events:
        fail(f"{tag}: no self-training iteration ran")
    count_path_launches(records, "dann", counts, {
        "emb_bwd": len(losses),
        **xla_attention_launches(tag, counts, enc.num_layers, len(losses))})
    moved = {k: float((model.state_dict()[k] - v).abs().max())
             for k, v in stats0.items()}
    if not all(m > 0.0 for m in moved.values()):
        fail(f"{tag}: the running statistics did not move: {moved}")

    # the gradient reversal, on the model's own forward
    seen = {}

    def keep(key, t):  # a hook that returns None changes nothing
        t.retain_grad()
        seen[key] = t

    hooks = [model.batchnorm_l.register_forward_hook(
        lambda m, i, o: keep("feat", o)),
        model.dom_linear_1.register_forward_pre_hook(
            lambda m, i: keep("d", i[0]))]
    idx = np.arange(cfg.batch_size)
    rows = [torch.from_numpy(np.asarray(source[k])[idx]).cuda() for k in
            ("input_ids", "attention_mask", "token_type_ids")]
    _, dom = model(*rows, deterministic=False, use_running_average=False)
    for h in hooks:
        h.remove()
    torch.nn.functional.cross_entropy(
        dom.float(), torch.zeros(len(idx), dtype=torch.long,
                                 device="cuda")).backward()
    g_feat, g_d = seen["feat"].grad, seen["d"].grad
    ok = torch.equal(g_feat, -cfg.domain_weight * g_d) and bool(
        (g_feat * g_d <= 0).all()) and bool(g_d.abs().max() > 0)
    print(f"{tag}: running statistics moved by {moved}; the features' "
          f"gradient is -{cfg.domain_weight:g} x the domain head's: {ok}",
          flush=True)
    if not ok:
        fail(f"{tag}: the gradient reversal does not reverse")

    # three steps from one state (params, running statistics, dropout
    # draws; train_dann seeds its numpy draws) repeat their bits: losses,
    # params and running statistics
    start, rng_state = snapshot(model), torch.cuda.get_rng_state()
    three = {k: np.asarray(v)[:16 * 3] for k, v in source.items()}
    repeats = []
    for _ in range(2):
        model.load_state_dict(start)
        torch.cuda.set_rng_state(rng_state)
        run_losses = []
        dann.train_dann(model, three, target, epochs=1,
                        learning_rate=cfg.learning_rate, losses=run_losses)
        repeats.append((torch.stack([torch.stack(p) for p in run_losses]),
                        snapshot(model)))
    same = torch.equal(repeats[0][0], repeats[1][0]) and same_state(
        repeats[0][1], repeats[1][1])
    print(f"{tag}: three steps from one state twice, losses, params and "
          f"running statistics bit-equal: {same}", flush=True)
    if not same:
        fail(f"{tag}: steps from one state do not repeat their bits")
    del start, repeats

    few = {k: np.asarray(v)[:16 * 5] for k, v in source.items()}
    nums = step_numbers(lambda: dann.train_dann(
        model, few, target, epochs=1, learning_rate=cfg.learning_rate),
        steps=1)
    per_step = {k: v / 5 for k, v in nums.items()}
    pred = step_numbers(lambda: dann.predict_dann(
        model, {k: v[:256] for k, v in target.items()}), steps=3)
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"{tag} b32xs128: step wall {per_step['wall_ms']:.2f} ms (device "
          f"{per_step['device_ms']:.2f} ms, busy "
          f"{per_step['device_ms'] / per_step['wall_ms']:.3f}, "
          f"{per_step['kernels']:.1f} kernels), "
          f"{cfg.batch_size / per_step['wall_ms'] * 1e3:.1f} clauses/s; "
          f"prediction of 256 clauses wall {pred['wall_ms']:.2f} ms (device "
          f"{pred['device_ms']:.2f} ms), "
          f"{256 / pred['wall_ms'] * 1e3:.1f} clauses/s; peak memory "
          f"{peak:.2f} GiB", flush=True)
    return dict(per_step, pred_wall_ms=pred["wall_ms"], peak_gib=peak)


def phase_reference_original() -> None:
    """A tiny fp32 original 3-latent DRL step (train/steps_original.py: one
    backward of vae_loss + disc_losses, the main Adam and the adversaries'
    RMSprop) on the card and on the CPU from the same weights, batch and
    noise: losses within rel 1e-4, gradients within 1e-3 normwise, every
    parameter within 2 lr of its group (an entry whose gradient is rounding
    noise moves by up to ~lr either way) and within 1e-3 lr where its
    gradient is over 1e-3 of its tensor's largest (Adam's first step moves
    such an entry by about lr * sign(g), so only there does the step show
    the gradient), the six latent heads bit-unchanged and the five
    adversaries moved on both devices; K10 once on the card."""
    from carel_tpu_torch import ops
    from carel_tpu_torch.data.batching import cut_batch
    from carel_tpu_torch.models.drl_original import (ADVERSARIES,
                                                     LATENT_HEADS,
                                                     DrlOriginalModel,
                                                     OriginalModelConfig)
    from carel_tpu_torch.models.encoder import init_flax_, tiny_encoder_config
    from carel_tpu_torch.train.steps import batch_to_device
    from carel_tpu_torch.train.steps_original import (
        DISC, FROZEN, OriginalLossConfig, create_original_state,
        make_original_train_step)

    tag = "reference step original (tiny fp32, card vs CPU)"
    mcfg = OriginalModelConfig(
        encoder=tiny_encoder_config(vocab_size=256, dropout=0.0), ec_dim=24,
        con_dim=384, bow_dim=3000, dropout=0.0)
    lcfg = OriginalLossConfig(vae_lr=1e-3)
    model = DrlOriginalModel(mcfg)
    init_flax_(model, torch.Generator().manual_seed(0))
    init = {k: v.clone() for k, v in model.state_dict().items()}
    arrays = synth_pair_arrays(np.random.default_rng(3), 16, 32, 256, 3000,
                               min_len=8)
    host = cut_batch(arrays, np.arange(14), 16).as_dict()  # 2 padded rows
    gen = torch.Generator().manual_seed(4)
    eps = [torch.randn(d, generator=gen) for d in (384, 24, 24)]
    runs = {}
    for dev in ("cpu", "cuda"):
        m = DrlOriginalModel(mcfg)
        m.load_state_dict(init)
        m.to(dev)
        state = create_original_state(lcfg, m, torch.Generator(device=dev))
        ops.reset_launch_counts()
        metrics = make_original_train_step(lcfg)(
            state, batch_to_device(host, torch.device(dev)), 0,
            eps=[e.to(dev) for e in eps])
        # neither optimizer clears .grad: the step's one backward is left
        # there (None on the frozen heads)
        runs[dev] = ({k: float(v) for k, v in metrics.items()},
                     {k: v.detach().cpu() for k, v in m.state_dict().items()},
                     {n: p.grad.cpu() for n, p in m.named_parameters()
                      if p.grad is not None},
                     ops.launch_counts(), state.labels)
    (m_c, p_c, g_c, _, labels), (m_g, p_g, g_g, counts, _) = (runs["cpu"],
                                                             runs["cuda"])
    if g_c.keys() != g_g.keys() or any(labels[n] == FROZEN for n in g_c):
        fail(f"{tag}: card and CPU leave gradients on other parameters")
    worst_m = max(abs(m_g[k] - m_c[k]) / max(abs(m_c[k]), 1e-30)
                  for k in m_c)
    worst_g = max(relnorm(g_g[n], g_c[n]) for n in g_c)
    lrs = {DISC: lcfg.adv_lr}
    worst_p = max(float((p_g[n] - p_c[n]).abs().max())
                  / lrs.get(label, lcfg.vae_lr) for n, label in labels.items())
    safe = {n: g_c[n].abs() > 1e-3 * g_c[n].abs().max() for n in g_c}
    worst_safe = max(float((p_g[n] - p_c[n])[safe[n]].abs().max())
                     / lrs.get(labels[n], lcfg.vae_lr) for n in g_c)
    frozen = all(torch.equal(p[f"{h}.{w}"], init[f"{h}.{w}"])
                 for p in (p_c, p_g) for h in LATENT_HEADS
                 for w in ("weight", "bias"))
    moved = all(not torch.equal(p[f"{a}.weight"], init[f"{a}.weight"])
                for p in (p_c, p_g) for a in ADVERSARIES)
    print(f"{tag}: vae loss {m_g['vae_loss']:.6f} vs {m_c['vae_loss']:.6f}, "
          f"disc loss {m_g['disc_loss']:.6f} vs {m_c['disc_loss']:.6f}; "
          f"worst metric rel {worst_m:.2e}, grad normwise rel "
          f"{worst_g:.2e}, param abs {worst_p:.2e} lr ({worst_safe:.2e} lr "
          f"where |g| > 1e-3 max|g|); latent heads unchanged {frozen}, "
          f"adversaries moved {moved}; launches {counts}", flush=True)
    if not (worst_m <= 1e-4 and worst_g <= 1e-3 and worst_p <= 2
            and worst_safe <= 1e-3 and frozen and moved):
        fail(f"{tag}: card and CPU disagree")
    if counts["emb_bwd"] != 1 or sum(counts.values()) != 1:
        fail(f"{tag}: launches {counts} (want K10 once, nothing else)")


def path_line(tag: str, nums: dict, peak_gib: float, smi: str,
              per: str = "step") -> str:
    """Wall and device ms a step, kernels a step, busy share and peak
    memory, with the card's name and power limit."""
    return (f"{tag}: wall {nums['wall_ms']:.2f} ms/{per}, device "
            f"{nums['device_ms']:.2f} ms/{per} (busy "
            f"{nums['device_ms'] / nums['wall_ms']:.3f}), "
            f"{nums['kernels']:.1f} kernels/{per}, peak memory "
            f"{peak_gib:.2f} GiB ({smi})")


EMBED_DOMAINS = 4


def phase_embed(records: dict, smi: str) -> dict:
    """The embed verb's trainer at full width (12L/768H, vocab 21,128, bf16,
    attention_impl="flash") at b32 x s200 over synthetic documents of four
    domain labels (load_domain_docs over four files: 512 texts, one epoch
    of 16 steps), then EncoderEmbedder over the 512 texts at batch 256.
    K7 must launch once a layer on every forward, K8/K9 once a layer and
    K10 once on every step; the loss and the embeddings must be
    finite; save_encoder then load_encoder_checkpoint must give the same
    bits and the same config. Then a step is timed and profiled. Returns
    the numbers, the encoder's config and its trained params."""
    from carel_tpu_torch import ops
    from carel_tpu_torch.config import EncoderConfig
    from carel_tpu_torch.data.ecpe_format import write_ecpe_file
    from carel_tpu_torch.data.tokenizer import ZhCharTokenizer
    from carel_tpu_torch.embeddings import (EmbedderTrainConfig,
                                            EncoderEmbedder,
                                            load_domain_docs,
                                            make_embedder_step,
                                            train_domain_embedder)
    from carel_tpu_torch.models.encoder import TransformerEncoder
    from carel_tpu_torch.models.hf_port import load_encoder_checkpoint
    from carel_tpu_torch.pretrain import save_encoder
    from carel_tpu_torch.train.state import adam

    tag = "embed path (flash attention)"
    enc = EncoderConfig(arch="bert", dtype="bfloat16", attention_impl="flash")
    cfg = EmbedderTrainConfig(epochs=1)
    B, L, layers, steps = cfg.batch_size, cfg.max_len, enc.num_layers, 16
    rng = np.random.default_rng(11)
    paths = {}
    for d in range(EMBED_DOMAINS):
        path = os.path.join(RUN_DIR, "embed", f"domain{d}.txt")
        os.makedirs(os.path.dirname(path), exist_ok=True)
        write_ecpe_file(path, synth_docs(rng, B * steps // EMBED_DOMAINS,
                                         20))
        paths[f"domain{d}"] = path
    texts, labels = load_domain_docs(paths)
    tok = ZhCharTokenizer(ZH_CHARS)
    lengths = tok.encode_batch(texts, L).attention_mask.sum(1)
    logger = _Records()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    params = train_domain_embedder(cfg, enc, tok, texts, labels,
                                   logger=logger, device="cuda")
    embedder = EncoderEmbedder(enc, params, tok, max_len=L, batch_size=256,
                               device="cuda")
    emb = embedder(texts)
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    losses = [r["loss"] for r in logger.records]
    forwards = -(-len(texts) // 256)
    print(f"{tag}: {len(texts)} texts of {EMBED_DOMAINS} domains (tokens "
          f"{int(lengths.min())}-{int(lengths.max())} of {L}), {steps} steps "
          f"and the embeddings in {wall:.2f} s; epoch losses {losses}; "
          f"embeddings {emb.shape}; launches {counts}", flush=True)
    if len(texts) != B * steps or not all(math.isfinite(x) for x in losses):
        fail(f"{tag}: {len(texts)} texts, or a loss not finite")
    if emb.shape != (len(texts), enc.hidden_dim) or not np.all(
            np.isfinite(emb)):
        fail(f"{tag}: embeddings of shape {emb.shape}, or not finite")
    count_path_launches(records, "embed", counts, {
        "flash_fwd": layers * (steps + forwards),
        "flash_bwd_dkv": layers * steps, "flash_bwd_dq": layers * steps,
        "emb_bwd": steps})

    # the encoder dir: written, read back bit for bit with the same shape
    enc_dir = save_encoder(os.path.join(RUN_DIR, "embed", "encoder"), params)
    loaded_cfg, loaded = load_encoder_checkpoint(enc_dir, enc)
    same = loaded_cfg == enc and loaded.keys() == params.keys() and all(
        torch.equal(loaded[k], params[k].cpu()) for k in params)
    print(f"{tag}: save_encoder -> load_encoder_checkpoint bit-equal, same "
          f"config: {same}", flush=True)
    if not same:
        fail(f"{tag}: the encoder dir does not give back the trained bits")

    # a step timed and profiled, from the trained params
    model = TransformerEncoder(enc)
    model.load_state_dict(params)
    model.cuda().train()
    step = make_embedder_step(cfg, model, adam(list(model.parameters()),
                                               cfg.learning_rate,
                                               torch.device("cuda")))
    e = tok.encode_batch(texts[:B], L)
    batch = [torch.from_numpy(np.asarray(a)).cuda() for a in (
        e.input_ids, e.attention_mask, e.token_type_ids,
        np.asarray(labels[:B], np.int32))]
    nums = step_numbers(lambda: step(*batch))
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(path_line(f"{tag} b{B}xs{L}", nums, peak, smi)
          + f"; {B / nums['wall_ms'] * 1e3:.1f} texts/s", flush=True)
    del model, step, embedder
    return dict(nums, peak_gib=peak, enc=enc, params=params)


def cit_target(rng, n_docs: int):
    """Target documents as a stage-1 file gives them: one predicted
    emotion clause each (the gold one), so every document has one
    candidate pair a clause."""
    docs = synth_docs(rng, n_docs, 12)
    for d in docs:
        emo = d.pairs[0][0]
        for c in d.clauses:
            if c.sen_id != emo:
                c.emotion, c.emotion_raw = 6, "6"
            elif c.emotion == 6:
                c.emotion, c.emotion_raw = 0, "0"
    return docs


def cit_classifier(ccfg, enc, encoder_params: dict, arrays) -> dict:
    """The CIT classifier's initial state_dict: the encoder's params, the
    classifier's weight along the first principal direction of the pooled
    outputs of ``arrays`` (scaled to logits of std 2) and its bias at their
    median logit. Its forwards use the default attention: no port kernel."""
    from carel_tpu_torch.train.pair_trainer import (PairTrainerConfig,
                                                    build_pair_trainer)

    model, _, _, _ = build_pair_trainer(
        PairTrainerConfig(max_len=ccfg.max_len, seed=ccfg.seed), enc, "cuda")
    model.encoder.load_state_dict(encoder_params)
    with torch.no_grad():
        pooled = torch.cat([model.encoder(*(torch.from_numpy(np.asarray(
            getattr(arrays, k)[s: s + 256])).cuda() for k in (
                "input_ids", "attention_mask", "token_type_ids")))[1].float()
            for s in range(0, len(arrays), 256)])
        v = torch.linalg.svd(pooled - pooled.mean(0),
                             full_matrices=False).Vh[0]
        w = v * (2.0 / (pooled @ v).std())
        model.classifier.weight.copy_(w[None])
        model.classifier.bias.fill_(-float((pooled @ w).median()))
    return {k: t.clone() for k, t in model.state_dict().items()}


def phase_cit(records: dict, served, embed: dict, smi: str) -> dict:
    """The cit verb's pieces at full width: the serving path's model (flash
    attention) scores the candidate pairs of 64 synthetic target documents
    through run_pair_inference (its pair classifier's bias centred on the
    median logit of those pairs first, so that the predictions split), and
    the CIT filter takes those predictions in memory (the GPU machine has no
    pandas for infer's pickles): build_cit_triples over 256 source documents
    with the embed path's encoder as the embedder (max_len 64), then run_cit
    at CitConfig's defaults (12L/768H bf16, default attention, s128, b32),
    its encoder started from the embed path's (as cit --hf_encoder), a base
    epoch of 16 steps and one self-training iteration. A random classifier
    gives every triple nearly the same logit, all on one side of 0.5, and
    then no predicted pair is left to self-train on: its weight is set
    along the first principal direction of the evaluation triples' pooled
    outputs (logits of std 2) and its bias at their median logit, so that
    its predictions split. K7 once a layer on
    every inference and embedder batch, K10 once on every step, the xla
    attention pair once a layer on every CIT step (and the forward on every
    evaluation batch), nothing else; the refined predictions must be 0 or 1 and P/R/F1 in
    [0, 1]. Then a CIT step is timed and profiled."""
    from carel_tpu_torch import ops
    from carel_tpu_torch.config import EncoderConfig
    from carel_tpu_torch.data.batching import encode_pairs, iter_batches
    from carel_tpu_torch.data.bow import BowVocab
    from carel_tpu_torch.data.pairs import build_pairs
    from carel_tpu_torch.data.tokenizer import ZhCharTokenizer
    from carel_tpu_torch.data.triples import build_cit_triples
    from carel_tpu_torch.embeddings import EncoderEmbedder
    from carel_tpu_torch.infer import run_pair_inference
    from carel_tpu_torch.train.cit_trainer import (CitConfig,
                                                   predicted_pair_triples,
                                                   run_cit)
    from carel_tpu_torch.train.pair_trainer import (PairTrainerConfig,
                                                    build_pair_trainer)
    from carel_tpu_torch.train.steps import batch_to_device, make_eval_step

    tag = "cit path"
    rng = np.random.default_rng(13)
    source, target = synth_docs(rng, 256, 12), cit_target(rng, 64)
    tok = ZhCharTokenizer(ZH_CHARS)
    bow = BowVocab.from_words([], "zh")
    test_pairs = build_pairs(target, test=True)
    arrays = encode_pairs(test_pairs, tok, bow, 96)
    eval_step = make_eval_step()
    with torch.no_grad():
        probe = run_pair_inference(eval_step, served, test_pairs, arrays)
        served.heads.pair_classifier.bias -= float(torch.logit(
            torch.from_numpy(probe.probs).double()).median())
    ccfg = CitConfig(epochs=1, self_epochs=1, self_iteration=1)
    enc = EncoderConfig(arch="bert", dtype="bfloat16")
    layers = embed["enc"].num_layers
    embedder = EncoderEmbedder(embed["enc"], embed["params"], tok,
                               max_len=64, device="cuda")
    calls = []

    def counted(texts):
        calls.append(-(-len(texts) // embedder.batch_size))
        return embedder(texts)

    logger = _Records()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    inference = run_pair_inference(eval_step, served, test_pairs, arrays)
    init = cit_classifier(ccfg, enc, embed["params"], encode_pairs(
        predicted_pair_triples(test_pairs.pairs, inference.preds)[0], tok,
        bow, ccfg.max_len))
    triples = build_cit_triples(source, counted)
    res = run_cit(ccfg, enc, tok, triples, target, test_pairs.docs_pair_size,
                  test_pairs.pairs, inference.preds, test_pairs.labels,
                  counted, logger, encoder_params=embed["params"],
                  device="cuda", params=init)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    evals = [r for r in logger.records if r["event"].endswith("_eval")]
    steps = sum(r["steps"] for r in evals)
    base_steps = evals[0]["steps"]
    infer_batches = -(-len(arrays) // 512)
    events = [r["event"] for r in logger.records]
    print(f"{tag}: {len(test_pairs)} candidate pairs of {len(target)} "
          f"documents, {int(inference.preds.sum())} predicted positive; "
          f"{len(triples)} train triples; {steps} steps ({base_steps} "
          f"base), {sum(calls)} embedder batches, events {events}; base "
          f"{res['base']}, best {res['best']}, in {wall:.2f} s; launches "
          f"{counts}", flush=True)
    if base_steps != 16 or steps <= base_steps or "cit_selftrain" not in \
            events:
        fail(f"{tag}: {base_steps} base steps (want 16) or no "
             "self-training step")
    if not set(np.unique(res["predictions"])) <= {0.0, 1.0}:
        fail(f"{tag}: refined predictions other than 0 and 1")
    if not all(0.0 <= v <= 1.0 for r in (res["base"], res["best"])
               for v in r.values()):
        fail(f"{tag}: a metric out of [0, 1]")
    count_path_launches(records, "cit", counts, {
        "flash_fwd": layers * (infer_batches + sum(calls)),
        "emb_bwd": steps,
        **xla_attention_launches(tag, counts, enc.num_layers, steps)})

    # a CIT step timed and profiled, from the best params
    pcfg = PairTrainerConfig(max_len=ccfg.max_len,
                             batch_size=ccfg.batch_size,
                             learning_rate=ccfg.learning_rate,
                             dropout=ccfg.dropout)
    _, _, train_step, _ = build_pair_trainer(pcfg, enc, "cuda",
                                             res["params"])
    batch = batch_to_device(next(iter_batches(
        encode_pairs(triples, tok, bow, ccfg.max_len), ccfg.batch_size,
        rng=np.random.default_rng(0))).as_dict(), torch.device("cuda"))
    nums = step_numbers(lambda: train_step(batch))
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(path_line(f"{tag} b{ccfg.batch_size}xs{ccfg.max_len} (eager)",
                    nums, peak, smi)
          + f"; {ccfg.batch_size / nums['wall_ms'] * 1e3:.1f} triples/s",
          flush=True)
    return dict(nums, peak_gib=peak)


def phase_original(records: dict, smi: str) -> dict:
    """The original verb's pieces at full width (12L/768H bf16 encoder,
    content 384, emotion and cause 24, BoW V 23,808) at b64 x s96 on the zh
    paths' synthetic data: train_original's base epoch of 16 eager steps,
    its evaluation of the 514 target pairs, the best saved and reloaded,
    one self-training iteration (random strategy) from the best, then 4
    steps of the --bow_loss variant. The pair classifier's bias is centred
    on the median logit of the test pairs first, so that the random model's
    predictions split and a best F1 above 0 is saved. K10 once a
    step and the xla attention pair 12 a step and forward, nothing else;
    the six latent heads bit-unchanged and all five
    adversaries moved; finite losses; probabilities in [0, 1]; after
    train_original the model holds the saved best. Then a step is timed
    and profiled."""
    from carel_tpu_torch import ops
    from carel_tpu_torch.config import SelfStrategy
    from carel_tpu_torch.data.batching import iter_batches
    from carel_tpu_torch.models.drl_original import (ADVERSARIES,
                                                     LATENT_HEADS,
                                                     OriginalModelConfig)
    from carel_tpu_torch.train import checkpoint as ckpt
    from carel_tpu_torch.train.loop import evaluate
    from carel_tpu_torch.train.original_driver import (build_original_state,
                                                       train_original)
    from carel_tpu_torch.train.steps import batch_to_device, make_eval_step
    from carel_tpu_torch.train.steps_original import (
        OriginalLossConfig, make_original_train_step)

    tag, model_id = "original path", "original"
    cfg = full_width_config("ec_mmd_final_mul", model_id, self_iteration=1,
                            self_epochs=1,
                            self_strategy=SelfStrategy.RANDOM)
    enc, B, L = cfg.model.encoder, cfg.train.batch_size, cfg.data.max_len
    V, unpred = cfg.model.bow_dim, 10
    rng = np.random.default_rng(0)
    train = synth_pair_arrays(rng, 1024, L, enc.vocab_size, V)
    test_pairs, test, encode = synth_target_domain(rng, 512, L,
                                                   enc.vocab_size, V)
    loss_cfg = OriginalLossConfig(vae_lr=cfg.train.vae_lr)
    state = build_original_state(cfg, loss_cfg, OriginalModelConfig(
        encoder=enc, bow_dim=V, ec_num_class=1), "cuda")
    model, device = state.model, torch.device("cuda")
    eval_step = make_eval_step()
    gen = torch.Generator(device=device).manual_seed(0)
    with torch.no_grad():
        p = evaluate(eval_step, model, test, unpred, gen).probs
        model.pair_classifier.bias -= float(torch.logit(
            torch.from_numpy(p).double()).median())
    init = {k: v.clone() for k, v in model.state_dict().items()}
    plain = make_original_train_step(loss_cfg)
    losses = []

    def step(state, batch, it):
        metrics = plain(state, batch, it)
        losses.append(torch.stack([metrics["vae_loss"],
                                   metrics["disc_loss"]]))
        return metrics

    logger = _Records()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    state, base_best, self_best = train_original(
        cfg, state, step, train, test, test_pairs, unpred, encode, model_id,
        logger)
    torch.cuda.synchronize()
    t_train = time.perf_counter() - t0
    saved = ckpt.load_best(cfg.train.checkpoint_dir, model_id, device)
    reloaded = same_state(model.state_dict(), saved)
    bow_step = make_original_train_step(dataclasses.replace(
        loss_cfg, learned_bow_weights=True))
    for it, batch in enumerate(iter_batches(
            train, B, rng=np.random.default_rng(1))):
        if it == 4:
            break
        metrics = bow_step(state, batch_to_device(batch.as_dict(), device),
                           it)
        losses.append(torch.stack([metrics["vae_loss"],
                                   metrics["disc_loss"]]))
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    flat = torch.stack(losses).cpu()
    events = [r["event"] for r in logger.records]
    n = len(losses)
    print(f"{tag}: {n} steps ({n - 4} train_original, 4 --bow_loss) in "
          f"{t_train:.2f} s with their evaluations; events {events}; base "
          f"{base_best}, self {self_best}; the best reloaded: {reloaded}; "
          f"launches {counts}", flush=True)
    print(f"{tag}: vae and disc losses (every step) "
          f"{[[round(x, 4) for x in row] for row in flat.tolist()]}",
          flush=True)
    if not bool(torch.isfinite(flat).all()):
        fail(f"{tag}: a loss is not finite")
    if "selftrain_iter" not in events or n <= 16 + 4:
        fail(f"{tag}: no self-training step")
    if "best" not in events or not reloaded:
        fail(f"{tag}: no best saved, or the model does not hold it")
    count_path_launches(records, "original", counts, {
        "emb_bwd": n, **xla_attention_launches(tag, counts, enc.num_layers,
                                               n)})
    now = model.state_dict()
    frozen = all(torch.equal(now[f"{h}.{w}"], init[f"{h}.{w}"])
                 for h in LATENT_HEADS for w in ("weight", "bias"))
    moved = {a: float((now[f"{a}.weight"] - init[f"{a}.weight"])
                      .abs().max()) for a in ADVERSARIES}
    probs = evaluate(eval_step, model, test, unpred, gen).probs
    print(f"{tag}: latent heads bit-unchanged {frozen}; adversaries moved "
          f"by (max abs) {moved}", flush=True)
    if not frozen or not all(m > 0.0 for m in moved.values()):
        fail(f"{tag}: a latent head moved or an adversary did not")
    if not probabilities(probs, len(test)):
        fail(f"{tag}: probabilities are not finite values in [0, 1]")

    batch = batch_to_device(next(iter_batches(
        train, B, rng=np.random.default_rng(2))).as_dict(), device)
    nums = step_numbers(lambda: plain(state, batch, 0))
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(path_line(f"{tag} b{B}xs{L} (eager)", nums, peak, smi)
          + f"; {B / nums['wall_ms'] * 1e3:.1f} pairs/s", flush=True)
    return dict(nums, peak_gib=peak)


CLUSTER_TEXTS = 4096


def phase_cluster(records: dict, embed: dict, smi: str) -> dict:
    """The clustering tool at its real size: 4,096 synthetic clauses
    embedded by the embed path's encoder (flash, max_len 64, batches of
    256: K7 once a layer a batch) and standardized per feature (a nearly
    random encoder's pooled outputs differ little between texts, and IDEC
    then puts every clause in one cluster), then train_idec (the [500, 500,
    2000] autoencoder, z 10, 25 clusters, 5 pretraining epochs of 16
    batches and 20 refinement steps over all 4,096 x 768) and
    emotion_cluster_chi2 of the assignments against the clauses' emotion
    codes. The port's kernels launch only in the embedder; the assignments
    must use more than one cluster and the soft assignments and the test
    must be well formed. The whole train_idec is then profiled once, its
    K-means on the host included."""
    from carel_tpu_torch import ops
    from carel_tpu_torch.data.tokenizer import ZhCharTokenizer
    from carel_tpu_torch.embeddings import EncoderEmbedder
    from carel_tpu_torch.tools.clustering import (IdecConfig,
                                                  emotion_cluster_chi2,
                                                  train_idec)

    tag = "clustering path"
    rng = np.random.default_rng(17)
    clauses = [c for d in synth_docs(rng, 900, 12) for c in d.clauses][
        :CLUSTER_TEXTS]
    texts = [c.text for c in clauses]
    emotions = np.asarray([c.emotion for c in clauses])
    embedder = EncoderEmbedder(embed["enc"], embed["params"],
                               ZhCharTokenizer(ZH_CHARS), max_len=64,
                               device="cuda")
    cfg = IdecConfig(pretrain_epochs=5, refine_steps=20)
    steps = cfg.pretrain_epochs * -(-len(texts) // cfg.batch_size) \
        + cfg.refine_steps
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    emb = embedder(texts)
    data = (emb - emb.mean(0)) / (emb.std(0) + 1e-6)
    t_embed = time.perf_counter() - t0
    assign, art = train_idec(data, cfg, device="cuda")
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    res = emotion_cluster_chi2(assign, emotions)
    q = art["q"]
    print(f"{tag}: {len(texts)} clauses embedded to {data.shape} in "
          f"{t_embed:.2f} s, train_idec ({steps} steps) in "
          f"{wall - t_embed:.2f} s; {len(np.unique(assign))} clusters used; "
          f"chi2 {res['chi2']:.2f}, p {res['p_value']:.4f}, dof "
          f"{res['dof']}; launches {counts}", flush=True)
    if data.shape != (len(texts), embed["enc"].hidden_dim) or not np.all(
            np.isfinite(data)):
        fail(f"{tag}: embeddings of shape {data.shape}, or not finite")
    if not (assign.shape == (len(texts),) and len(np.unique(assign)) > 1
            and assign.min() >= 0
            and assign.max() < cfg.n_clusters and np.all(np.isfinite(q))
            and np.allclose(q.sum(1), 1.0, atol=1e-4)):
        fail(f"{tag}: assignments or soft assignments not well formed")
    if not (math.isfinite(res["chi2"]) and res["dof"] > 0
            and 0.0 <= res["p_value"] <= 1.0):
        fail(f"{tag}: the chi-squared test is not well formed: {res}")
    count_path_launches(records, "cluster", counts, {
        "flash_fwd": embed["enc"].num_layers * -(-len(texts)
                                                 // embedder.batch_size)})

    def run():
        train_idec(data, cfg, device="cuda")

    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    device_ms, kernels = device_profile(run, iters=1, warmup=0)
    nums = dict(wall_ms=wall_ms, device_ms=device_ms / steps,
                kernels=kernels / steps)
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(path_line(f"{tag} train_idec over {len(texts)} x "
                    f"{data.shape[1]}", nums, peak, smi), flush=True)
    return dict(nums, peak_gib=peak)


# device memory still allocated after each main-path phase (GiB): what a
# phase leaves held raises every later phase's peak
HELD: dict = {}


# MLM pretraining at full width: MlmConfig's batch, two captured dispatches
PRETRAIN_STEPS, PRETRAIN_SCAN = 16, 8
# pairs the ordering phase holds card against CPU, and its gate: the mean
# masked log-prob of the bf16 flash scorer within 1e-2 relative of the fp32
# CPU scorer's (bf16 rounds each of the 12 layers' products to 2^-9; the
# error expected is ~1e-3 of a log-prob near -10)
ORDERING_CPU_PAIRS, ORDERING_GATE = 8, 1e-2


def mlm_step_calls(layers: int) -> dict:
    """Kernel launches of one MLM training step with flash attention: K7-K9
    once a layer, K10 once for the three tables."""
    return {"flash_fwd": layers, "flash_bwd_dkv": layers,
            "flash_bwd_dq": layers, "emb_bwd": 1}


def phase_reference_pretrain() -> None:
    """One tiny fp32 MLM step (pretrain/mlm.py: MlmTrainer, flash
    attention) on the card, captured and replayed, and on the CPU from the
    same weights and the same draws, at the lr after warmup: loss within
    rel 1e-4, gradients within 1e-3 normwise, every parameter within 2 lr
    and within 1e-3 lr where its gradient is over 1e-3 of its tensor's
    largest (the attention key biases, whose gradient is 0 in exact
    arithmetic, to 2 lr only); the card's step launches K7-K9 once a layer
    and K10 once."""
    from carel_tpu_torch import ops
    from carel_tpu_torch.models.encoder import tiny_encoder_config
    from carel_tpu_torch.pretrain import mlm

    tag = "reference step pretrain (tiny fp32, flash, card vs CPU)"
    enc = tiny_encoder_config(vocab_size=256, dropout=0.0,
                              attention_impl="flash")
    cfg = mlm.MlmConfig(batch_size=16, seq_len=32, warmup_steps=4,
                        learning_rate=1e-3)
    rng = np.random.default_rng(6)
    n, B, L = 64, cfg.batch_size, cfg.seq_len
    lengths = rng.integers(6, L + 1, n)
    mask = (np.arange(L)[None, :] < lengths[:, None]).astype(np.int32)
    ids = (rng.integers(5, enc.vocab_size, (n, L)) * mask).astype(np.int32)
    ids[:, 0] = 2
    u = rng.random((B, L)).astype(np.float32)
    u[:, ::4] = 0.01  # a few masked positions of each branch
    u2 = rng.random((B, L)).astype(np.float32)
    host = (rng.integers(0, n, B), u, u2,
            rng.integers(5, enc.vocab_size, (B, L)))
    draws = {dev: tuple(torch.from_numpy(np.asarray(a)).to(dev)
                        for a in host) for dev in ("cpu", "cuda")}
    init_model = mlm.build_mlm(enc, seed=0)
    init = {k: v.clone() for k, v in init_model.state_dict().items()}
    runs = {}
    real = mlm.draw_noise
    mlm.draw_noise = lambda gen, n, shape, vocab, device: draws[
        torch.device(device).type]
    try:
        for dev in ("cpu", "cuda"):
            model = mlm.MlmModel(enc)
            model.load_state_dict(init)
            trainer = mlm.MlmTrainer(model.to(dev), cfg, ids, mask, None, 4,
                                     dev)
            trainer.count.fill_(cfg.warmup_steps)  # lr = learning_rate
            ops.reset_launch_counts()
            loss = float(trainer.dispatch(1))
            runs[dev] = (loss,
                         {k: v.detach().cpu()
                          for k, v in model.state_dict().items()},
                         {k: p.grad.cpu() for k, p in
                          model.named_parameters()},
                         ops.launch_counts(), trainer.captures)
    finally:
        mlm.draw_noise = real
    (l_c, p_c, g_c, _, _), (l_g, p_g, g_g, counts, captures) = (runs["cpu"],
                                                                runs["cuda"])
    lr = cfg.learning_rate
    rel_loss = abs(l_g - l_c) / abs(l_c)
    worst_g = max(relnorm(g_g[k], g_c[k]) for k in g_c
                  if float(g_c[k].abs().max()) > 0)
    worst_p = max(float((p_g[k] - p_c[k]).abs().max()) for k in p_c) / lr
    key_bias = {k: torch.zeros_like(g, dtype=torch.bool) for k, g in
                g_c.items()}
    for k, g in g_c.items():
        if k.endswith("attention.qkv.bias"):
            d = g.shape[0] // 3
            key_bias[k][d:2 * d] = True
    safe = {k: (g.abs() > 1e-3 * g.abs().max()) & ~key_bias[k]
            for k, g in g_c.items()}
    worst_safe = max(float((p_g[k] - p_c[k])[safe[k]].abs().max())
                     for k in g_c if bool(safe[k].any())) / lr
    print(f"{tag}: loss {l_g:.6f} vs {l_c:.6f} (rel {rel_loss:.2e}), grad "
          f"normwise rel {worst_g:.2e}, param abs {worst_p:.2e} lr "
          f"({worst_safe:.2e} lr where |g| > 1e-3 max|g|); {captures} "
          f"capture, launches {counts}", flush=True)
    if not (rel_loss <= 1e-4 and worst_g <= 1e-3 and worst_p <= 2
            and worst_safe <= 1e-3 and captures == 1):
        fail(f"{tag}: card and CPU disagree")
    want = mlm_step_calls(enc.num_layers)
    if {k: v for k, v in counts.items() if v} != want:
        fail(f"{tag}: launches {counts} (want {want})")


def pretrain_texts(n_docs: int = 1024) -> list:
    """The clauses of synthetic zh documents (5-25 chars each)."""
    rng = np.random.default_rng(21)
    return [c.text for d in synth_docs(rng, n_docs, 20) for c in d.clauses]


def phase_pretrain(records: dict, smi: str) -> dict:
    """The pretrain verb's trainer at full width (12L/768H bf16, vocab
    21,128, flash attention) at MlmConfig's b256 x s64 over the clauses of
    synthetic documents: PRETRAIN_STEPS steps in dispatches of
    PRETRAIN_SCAN replays of one captured step, the whole MLM saved as
    --save_mlm does and the encoder as --out does. K7-K9 must launch once a
    layer and K10 once on every step, nothing else; each dispatch's
    loss finite; the encoder dir loads through load_encoder_checkpoint into
    the flagship's encoder bit for bit; a second captured run and an eager
    run of the same seed give the first run's bits. Then dispatches are
    timed (wall by the host clock around a synchronize, device ms and
    kernels by the profiler), each on its own. Returns the numbers, the MLM
    dir and its pinned tokenizer."""
    import copy

    from carel_tpu_torch import ops
    from carel_tpu_torch.config import EncoderConfig
    from carel_tpu_torch.data.tokenizer import ZhCharTokenizer
    from carel_tpu_torch.models.encoder import TransformerEncoder
    from carel_tpu_torch.models.hf_port import load_encoder_checkpoint
    from carel_tpu_torch.pretrain import mlm

    tag = "pretrain path (flash attention)"
    enc = EncoderConfig(arch="bert", dtype="bfloat16", attention_impl="flash")
    root = os.path.join(RUN_DIR, "pretrain")
    out_dir, mlm_dir = os.path.join(root, "encoder"), os.path.join(root, "mlm")
    cfg = mlm.MlmConfig(steps=PRETRAIN_STEPS, scan_size=PRETRAIN_SCAN,
                        save_full_path=mlm_dir)
    B, L, layers = cfg.batch_size, cfg.seq_len, enc.num_layers
    texts = pretrain_texts()
    tok = ZhCharTokenizer(ZH_CHARS)
    os.makedirs(root, exist_ok=True)
    tok.save(mlm_dir + ".tokenizer.json")
    t0 = time.perf_counter()
    init_model = mlm.build_mlm(enc, cfg.seed)
    print(f"{tag}: {len(texts)} clauses, MlmModel of "
          f"{sum(p.numel() for p in init_model.parameters())} params built "
          f"in {time.perf_counter() - t0:.1f} s", flush=True)

    logger = _Records()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    params = mlm.pretrain_mlm(enc, tok, texts, cfg, logger, device="cuda",
                              model=copy.deepcopy(init_model))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    losses = [r["loss"] for r in logger.records]
    print(f"{tag}: {PRETRAIN_STEPS} steps in {len(losses)} dispatches of "
          f"{PRETRAIN_SCAN} (capture, tokenization and the MLM save "
          f"included) in {wall:.2f} s; loss of each dispatch {losses}; "
          f"launches {counts}; peak memory {peak:.2f} GiB", flush=True)
    if len(losses) != PRETRAIN_STEPS // PRETRAIN_SCAN or not all(
            math.isfinite(x) for x in losses):
        fail(f"{tag}: dispatch losses {losses}")
    count_path_launches(records, "pretrain", counts, {
        k: v * PRETRAIN_STEPS for k, v in mlm_step_calls(layers).items()})

    # --out: the encoder dir, read as train --hf_encoder reads it into the
    # flagship's encoder
    mlm.save_encoder(out_dir, params)
    flagship_enc = EncoderConfig(arch="bert", dtype="bfloat16")
    loaded_cfg, loaded = load_encoder_checkpoint(out_dir, flagship_enc)
    encoder = TransformerEncoder(loaded_cfg)
    encoder.load_state_dict(loaded)
    full = mlm.load_mlm(mlm_dir)
    same = loaded_cfg == flagship_enc and all(
        torch.equal(encoder.state_dict()[k], params[k].cpu())
        and torch.equal(full[f"encoder.{k}"], params[k].cpu())
        for k in params)
    print(f"{tag}: the encoder dir loads into the flagship's encoder "
          f"bit-equal, the MLM dir holds the same encoder: {same}",
          flush=True)
    if not same:
        fail(f"{tag}: the saved encoder does not give back the trained bits")

    # the same seed again, captured and eager: the same bits
    for kind, capture in (("captured", True), ("eager", False)):
        again = mlm.pretrain_mlm(
            enc, tok, texts, dataclasses.replace(cfg, save_full_path=""),
            device="cuda", model=copy.deepcopy(init_model), capture=capture)
        if not all(torch.equal(again[k], params[k]) for k in params):
            fail(f"{tag}: a second run ({kind}) of the seed differs")
        del again
    print(f"{tag}: a second captured run and an eager run of the seed give "
          "the first run's bits", flush=True)

    # dispatches timed, each on its own, from a trainer of the trained model
    model = mlm.MlmModel(enc)
    model.load_state_dict(full)
    ids, mask = mlm.make_mlm_batches(texts, tok, cfg)
    torch.cuda.reset_peak_memory_stats()
    trainer = mlm.MlmTrainer(model.cuda(), cfg, ids, mask, None,
                             mlm.mask_id_of(tok), "cuda")
    dispatch = lambda: trainer.dispatch(PRETRAIN_SCAN)  # noqa: E731
    dispatch()
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dispatch()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) / PRETRAIN_SCAN * 1e3)
    devs = [device_profile(dispatch, iters=1, warmup=0) for _ in range(3)]
    nums = dict(wall_ms=float(np.median(walls)),
                device_ms=float(np.median([d[0] for d in devs]))
                / PRETRAIN_SCAN,
                kernels=float(np.median([d[1] for d in devs]))
                / PRETRAIN_SCAN)
    timed_peak = torch.cuda.max_memory_allocated() / 2**30

    # the fp32 head's share of the step: its forward and backward alone
    # over the trainer's capacity of rows (TF32 off), against the step's
    # device time; its GEMMs' operations over the card's fp32 peak bound it
    import torch.nn.functional as F

    rows, d, V = trainer.capacity, enc.hidden_dim, enc.vocab_size
    print(f"{tag}: the head runs over {rows} rows a step of {B * L}; "
          f"{trainer.masked} rows masked over {trainer.head_rows} head "
          f"rows ({100 * trainer.masked / trainer.head_rows:.1f} %), "
          f"{trainer.full_steps} steps past capacity", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(8)
    hidden = torch.randn(rows, d, device="cuda", generator=gen,
                         requires_grad=True)
    target = torch.randint(0, V, (rows,), device="cuda", generator=gen)
    weight = torch.ones(rows, device="cuda")
    head_params = [p for n, p in model.named_parameters()
                   if n.startswith("mlm_")]

    def head_step():
        nll = F.cross_entropy(model.head(hidden), target, reduction="none")
        loss = (nll * weight).sum() / weight.sum()
        return torch.autograd.grad(loss, [hidden, *head_params])

    head_ms, head_kernels = device_profile(head_step, iters=5, warmup=2)
    head_flop = 6.0 * rows * d * (d + V)
    head_bound = head_flop / PEAK_FP32_FLOPS * 1e3
    nums["head_ms"] = head_ms
    print(f"{tag}: the fp32 head (forward and backward, {head_flop:.3e} "
          f"FLOP) {head_ms:.3f} ms of device time in {head_kernels:.0f} "
          f"kernels, {head_ms / nums['device_ms']:.3f} of the step's; "
          f"{head_flop / head_ms / 1e9:.1f} TFLOP/s against the fp32 bound "
          f"{head_bound:.3f} ms ({smi})", flush=True)
    del hidden
    print(f"{tag} b{B}xs{L}, each dispatch of {PRETRAIN_SCAN} steps on its "
          f"own: wall ms/step {[round(w, 3) for w in walls]}, device "
          f"ms/step {[round(d[0] / PRETRAIN_SCAN, 3) for d in devs]}, "
          f"kernels/step {[round(d[1] / PRETRAIN_SCAN, 1) for d in devs]}; "
          f"{B * L / nums['wall_ms'] * 1e3:.0f} tokens/s; peak "
          f"{timed_peak:.2f} GiB over the timed dispatches; launches a step "
          f"{mlm_step_calls(layers)}", flush=True)
    del trainer, model, init_model
    return dict(nums, peak_gib=peak, mlm_dir=mlm_dir, enc=enc,
                tok_path=mlm_dir + ".tokenizer.json")


def ordering_docs(n_docs: int):
    """Synthetic documents of 3-8 clauses of 5-25 chars (the clause
    lengths of the zh corpora), one gold pair each."""
    return synth_docs(np.random.default_rng(31), n_docs, 8)


def phase_ordering(records: dict, pre: dict, smi: str) -> dict:
    """The ordering verb's pieces over pretrain's MLM dir: MlmScorer with
    the pretrain path's encoder (flash attention, 32 x 64 a call) over the
    gold pairs of a synthetic ECPE file, through ordering_probe, and the
    verb's JSON of its stats: ms a call (wall: the host clock around the
    probe, a fetch a call; device: the profiler over one call's batch), K7
    once a layer a call and nothing else; and the scores of
    ORDERING_CPU_PAIRS pairs held against an fp32 scorer on the CPU with
    the same weights (ORDERING_GATE)."""
    from carel_tpu_torch import ops
    from carel_tpu_torch.cli.main import ordering_summary
    from carel_tpu_torch.data.ecpe_format import (parse_ecpe_file,
                                                  write_ecpe_file)
    from carel_tpu_torch.data.tokenizer import ZhCharTokenizer
    from carel_tpu_torch.tools.mlm_scorer import MlmScorer
    from carel_tpu_torch.tools.ordering import ordering_probe

    tag = "ordering path (MLM scorer, flash attention)"
    torch.cuda.reset_peak_memory_stats()
    path = os.path.join(RUN_DIR, "ordering", "docs.txt")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    write_ecpe_file(path, ordering_docs(160))
    # the tokenizer pinned beside the MLM dir, as the verb reads it
    tok = ZhCharTokenizer.load(pre["tok_path"])
    scorer = MlmScorer(pre["mlm_dir"], tok, pre["enc"], device="cuda")
    docs = parse_ecpe_file(path)
    calls = []

    def counted(p, h):
        calls.append(1)
        return scorer(p, h)

    ops.reset_launch_counts()
    t0 = time.perf_counter()
    stats = ordering_probe(docs, entailment_scorer=counted)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / len(calls) * 1e3
    counts = ops.launch_counts()
    print(f"{tag}: the ordering verb's JSON "
          f"{json.dumps(ordering_summary(stats, True))}", flush=True)
    if stats.scored_pairs < 64 or len(calls) != 2 * stats.scored_pairs:
        fail(f"{tag}: {stats.scored_pairs} scored pairs in {len(calls)} "
             "calls (want 64 or more, two calls each)")
    count_path_launches(records, "ordering", counts, {
        "flash_fwd": pre["enc"].num_layers * len(calls)})

    pairs = [(d.clause(c).text.strip(), d.clause(e).text.strip())
             for d in docs for e, c in d.pairs if e != c]
    batch = scorer.batch(*pairs[0])
    dev_ms, kernels = device_profile(
        lambda: scorer.masked_logprobs(*batch[:4]))
    cpu = MlmScorer(pre["mlm_dir"], tok, dataclasses.replace(
        pre["enc"], dtype="float32", attention_impl="xla"), device="cpu")
    held = [(scorer(p, h), cpu(p, h)) for p, h in
            pairs[:ORDERING_CPU_PAIRS]]
    worst = max(abs(g - c) / abs(c) for g, c in held)
    print(f"{tag}: {stats.scored_pairs} scored pairs ({len(calls)} calls); "
          f"wall {wall:.3f} ms a call, device {dev_ms:.3f} ms a call in "
          f"{kernels:.1f} kernels; launches {counts}; card (bf16, flash) vs "
          f"CPU (fp32) on {len(held)} pairs: "
          f"{[(round(g, 5), round(c, 5)) for g, c in held]}, worst rel "
          f"{worst:.2e} (gate {ORDERING_GATE}) ({smi})", flush=True)
    if not worst <= ORDERING_GATE:
        fail(f"{tag}: the card's scores are off the CPU's by {worst:.2e}")
    del scorer, cpu
    return dict(wall_ms=wall, device_ms=dev_ms, kernels=kernels,
                peak_gib=torch.cuda.max_memory_allocated() / 2**30)


def docs_of(pairs):
    """Documents for a synthetic PairSet (synth_target_domain): each its
    clauses and its one gold pair, so that self_chain_doc_ids finds the
    documents whose emotion clause is its own cause."""
    from carel_tpu_torch.data.ecpe_format import Clause, Document

    docs = []
    for i, n in enumerate(pairs.docs_pair_size):
        ex = [e for e in pairs.examples if e.doc_index == i]
        gold = [(e.emo_sen_id, e.cau_sen_id) for e in ex if e.label]
        clauses = [Clause(sen_id=c, emotion=6, cause=6, text=f"c{c}",
                          emotion_raw="6", cause_raw="6", text_field3=f"c{c}")
                   for c in range(1, n + 1)]
        docs.append(Document(doc_id=str(i + 1), pairs=gold, clauses=clauses))
    return docs


def phase_case_analysis(records: dict, smi: str) -> dict:
    """The case_analysis verb's compare_checkpoints over two checkpoints
    that the paths above saved, the flagship's (default attention) and the
    flash path's, both scored by the flagship with flash attention over the
    514 test pairs of the paths' synthetic target domain: both F1s and the
    self-chain split printed, the CSV's rows counted, K7 once a layer on
    each of the four evaluation batches and nothing else."""
    from carel_tpu_torch import ops
    from carel_tpu_torch.models.drl import DrlModel
    from carel_tpu_torch.tools.case_analysis import compare_checkpoints
    from carel_tpu_torch.train import checkpoint as ckpt
    from carel_tpu_torch.train.steps import make_eval_step

    tag = "case_analysis path (flash attention)"
    cfg = full_width_config(FLAGSHIP, "case", attention_impl="flash")
    enc, L, V = cfg.model.encoder, cfg.data.max_len, cfg.model.bow_dim
    rng = np.random.default_rng(0)
    synth_pair_arrays(rng, 1024, L, enc.vocab_size, V)  # the paths' train set
    test_pairs, test, _ = synth_target_domain(rng, 512, L, enc.vocab_size, V)
    test_pairs.num_unpred_emotions = 10
    docs = docs_of(test_pairs)
    device = torch.device("cuda")
    pa = ckpt.load_best(os.path.join(RUN_DIR, "ckpt", FLAGSHIP), FLAGSHIP,
                        device)
    pb = ckpt.load_best(os.path.join(RUN_DIR, "ckpt", "flash"), "flash",
                        device)
    with torch.device("cuda"):
        model = DrlModel(cfg.model)
    out_csv = os.path.join(RUN_DIR, "case_analysis.csv")
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    res = compare_checkpoints(
        make_eval_step(), model, pa, pb, test_pairs, test, docs, out_csv,
        torch.Generator(device=device).manual_seed(0),
        cfg.train.eval_batch_size)
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    with open(out_csv, encoding="utf8") as f:
        rows = sum(1 for _ in f) - 1
    batches = -(-len(test) // cfg.train.eval_batch_size)
    print(f"{tag}: flagship F1 {res.model_a_f1:.4f}, flash F1 "
          f"{res.model_b_f1:.4f}; self-chain {res.self_chain_counts}, "
          f"normal {res.normal_counts}; split F1 {res.split_f1}; {rows} CSV "
          f"rows; {wall:.2f} s; launches {counts} ({smi})", flush=True)
    if rows != len(test) or not res.self_chain_counts["total"] or not (
            0.0 <= res.model_a_f1 <= 1.0 and 0.0 <= res.model_b_f1 <= 1.0):
        fail(f"{tag}: {rows} rows, or no self-chain row, or an F1 out of "
             "range")
    count_path_launches(records, "case_analysis", counts, {
        "flash_fwd": enc.num_layers * batches * 2})
    del model, pa, pb
    return dict(wall_s=wall)


HPO_TRIALS = 2


def phase_hpo(records: dict, smi: str) -> dict:
    """The hpo verb's search with its objective (cli/main.py:
    hpo_objective) over the flagship at full width: HPO_TRIALS trials of
    one base epoch (16 captured steps, K1-K4 and K10 on every step) and its
    evaluation over the paths' 514 test pairs, from DEFAULT_SPACE's draws
    by random.Random(42), as the verb makes them."""
    from types import SimpleNamespace

    from carel_tpu_torch import ops
    from carel_tpu_torch.cli.main import hpo_objective
    from carel_tpu_torch.tools.hpo import DEFAULT_SPACE, search

    tag = "hpo path"
    cfg = full_width_config(FLAGSHIP, "hpo", self_iteration=0)
    enc, L, V = cfg.model.encoder, cfg.data.max_len, cfg.model.bow_dim
    rng = np.random.default_rng(0)
    train = synth_pair_arrays(rng, 1024, L, enc.vocab_size, V)
    _, test, _ = synth_target_domain(rng, 512, L, enc.vocab_size, V)
    pipe = SimpleNamespace(cfg=cfg, model_id="hpo", train_arrays=train,
                           test_arrays=test, num_unpred_pairs=10)
    logger = _Records()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    best, trials = search(hpo_objective(pipe, torch.device("cuda"), logger),
                          cfg, DEFAULT_SPACE, HPO_TRIALS, logger=logger)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    steps = HPO_TRIALS * -(-len(train) // cfg.train.batch_size)
    verb = {"best_value": best.value if best else None,
            "best_params": best.params if best else None,
            "trials": len(trials)}
    print(f"{tag}: {HPO_TRIALS} trials of one epoch ({steps} steps) in "
          f"{wall:.1f} s: {[(t.number, t.value, t.pruned) for t in trials]};"
          f" the verb's JSON {json.dumps(verb)}; launches {counts} ({smi})",
          flush=True)
    if len(trials) != HPO_TRIALS or best is None or not all(
            t.value is not None and 0.0 <= t.value <= 1.0 for t in trials):
        fail(f"{tag}: trials {trials}")
    count_path_launches(records, "hpo", counts, {
        **dict.fromkeys(PATH_KERNELS[FLAGSHIP], steps),
        **xla_attention_launches(tag, counts, enc.num_layers, steps)})
    return dict(wall_s=wall)


VERB_DIR = os.path.join(RUN_DIR, "verbs")


def blocked_jieba() -> str:
    """A directory whose ``jieba.py`` raises ImportError, put first on a
    verb's PYTHONPATH: the zh verbs must run on the segmentation cache."""
    path = os.path.join(VERB_DIR, "no_jieba")
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "jieba.py"), "w") as f:
        f.write('raise ImportError("jieba is blocked for this run")\n')
    return path


def run_train_verb(tag: str, preset: str, data_root: str, cache: str,
                   extra=()) -> dict:
    """``python -m carel_tpu_torch.cli train --preset PRESET`` at the
    preset's full width (the default ``--encoder base``: 12L/768H bf16) for
    one base epoch and one self-training iteration of one epoch, with
    jieba blocked, a state snapshot each epoch, in a process of its own:
    its kernel launches are counted from 0 there and logged at its end.
    Returns its last line, log events, final params and wall seconds."""
    run = os.path.join(VERB_DIR, tag)
    log_dir, ckpt_dir = os.path.join(run, "log"), os.path.join(run, "ckpt")
    argv = [sys.executable, "-m", "carel_tpu_torch.cli", "train",
            "--preset", preset, "--data_root", data_root, "--cache_dir",
            cache, "--epochs", "1", "--self_iteration", "1",
            "--self_epochs", "1", "--save_state_every", "1",
            "--checkpoint_dir", ckpt_dir, "--log_dir", log_dir, *extra]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [blocked_jieba(), ROOT] + [p for p in [os.environ.get(
            "PYTHONPATH", "")] if p]))
    t0 = time.perf_counter()
    proc = subprocess.run(argv, cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=900)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        fail(f"{tag}: train exited {proc.returncode}:\n"
             f"{proc.stderr[-4000:]}")
    last = json.loads(proc.stdout.strip().splitlines()[-1])
    f1 = last.get("best_f1")
    if not (isinstance(f1, float) and 0.0 <= f1 <= 1.0
            and 0.0 <= last["base_f1"] <= 1.0):
        fail(f"{tag}: no pair-F1 in the last line: {last}")
    (name,) = os.listdir(log_dir)
    with open(os.path.join(log_dir, name)) as f:
        events = [json.loads(line) for line in f]

    def only(kind):
        found = [e for e in events if e["event"] == kind]
        if len(found) != 1:
            fail(f"{tag}: {len(found)} {kind} events")
        return found[0]

    config, done = only("config"), only("self_done")
    trains = [e["losses"] for e in events if e["event"] == "train"]
    steps = sum(len(t) for t in trains)
    if len(trains) != 2 or not np.all(np.isfinite(np.concatenate(trains))):
        fail(f"{tag}: train events {trains}")
    if done["jieba_imported"]:
        fail(f"{tag}: jieba was imported")
    if not (config["epoch_step"] and done["captures"] == 1
            and done["replays"] == steps):
        fail(f"{tag}: {done['captures']} captures and {done['replays']} "
             f"replays for {steps} steps (want 1 capture)")
    state = torch.load(os.path.join(ckpt_dir, f"{last['model_id']}_state.pt"),
                       map_location="cpu", weights_only=True)
    return dict(last=last, config=config, done=done, trains=trains,
                steps=steps, wall_s=wall, params=state["model"],
                epoch_s=[e["epoch_seconds"] for e in events
                         if e["event"] == "eval"])


def verb_line(tag: str, run: dict, smi: str) -> str:
    cfg = run["config"]
    launched = {k: v for k, v in run["done"]["launches"].items() if v}
    return (f"verb {tag}: exit 0 in {run['wall_s']:.1f} s wall; "
            f"{cfg['train_pairs']} train / {cfg['test_pairs']} test pairs, "
            f"BoW V {cfg['bow_dim']}, vocab {cfg['vocab']}; "
            f"segmentation {cfg['segmentation']}; {run['steps']} steps "
            f"(1 capture, {run['done']['replays']} replays); epoch seconds "
            f"(base incl. capture, self-training) "
            f"{[round(x, 3) for x in run['epoch_s']]}; best_f1 "
            f"{run['last']['best_f1']:.4f}; launches {launched}; {smi}")


def verb_launches(records: dict, tag: str, preset: str, run: dict) -> None:
    counts = run["done"]["launches"]
    count_path_launches(records, tag, counts, {
        **dict.fromkeys(PATH_KERNELS[preset], run["steps"]),
        **xla_attention_launches(tag, counts, 12, run["steps"])})


def phase_verb_zh(records: dict, smi: str, tag: str = "verb_zh",
                  extra=()) -> dict:
    """The flagship's train verb over the committed synthetic zh corpus and
    its segmentation cache, jieba blocked: K1-K4 and K10 on every step."""
    from carel_tpu_torch.data.synthetic import install_zh_fixture

    data = os.path.join(VERB_DIR, tag, "data")
    cache = os.path.join(VERB_DIR, tag, "cache")
    install_zh_fixture(data, cache)
    run = run_train_verb(tag, FLAGSHIP, data, cache, extra)
    if run["config"]["segmentation"] != "cache":
        fail(f"{tag}: the zh words came from "
             f"{run['config']['segmentation']}, not the cache")
    verb_launches(records, tag, FLAGSHIP, run)
    print(verb_line(tag, run, smi), flush=True)
    return run


def phase_verb_en(records: dict, smi: str) -> dict:
    """en_newsplit's train verb over a seeded synthetic en corpus (a
    WordPiece trained into the cache): K1-K4 and K10 on every step."""
    from carel_tpu_torch.data.synthetic import write_en_newsplit_corpus

    data = os.path.join(VERB_DIR, "verb_en", "data")
    write_en_newsplit_corpus(data)
    run = run_train_verb("verb_en", EN_PRESET, data,
                         os.path.join(VERB_DIR, "verb_en", "cache"))
    verb_launches(records, "verb_en", EN_PRESET, run)
    print(verb_line("verb_en", run, smi), flush=True)
    return run


def phase_mesh(records: dict, zh: dict, smi: str) -> None:
    """The flagship's train verb under --mesh_shape 1,1 (NCCL, a world of
    one, the collectives inside the captured step) against the same seed's
    run without a mesh: every batch's loss and the final params bit-equal,
    one capture."""
    run = phase_verb_zh(records, smi, "mesh", ("--mesh_shape", "1,1"))
    if run["config"]["mesh_shape"] != [1, 1]:
        fail(f"mesh: the run's mesh is {run['config']['mesh_shape']}")
    if run["trains"] != zh["trains"]:
        fail(f"mesh: losses {run['trains']} against {zh['trains']}")
    if run["params"].keys() != zh["params"].keys() or not all(
            torch.equal(v, zh["params"][k]) for k, v in run["params"].items()):
        fail("mesh: final params differ from the run without a mesh")
    print(f"mesh 1,1 against no mesh: {run['steps']} losses and "
          f"{len(run['params'])} param tensors bit-equal; wall "
          f"{run['wall_s']:.1f} s against {zh['wall_s']:.1f} s; epoch "
          f"seconds {[round(x, 3) for x in run['epoch_s']]} against "
          f"{[round(x, 3) for x in zh['epoch_s']]}; {smi}", flush=True)


# steps each arm of the bench verb runs at bench.main's defaults: a warm-up
# of two, then three rounds of ten
BENCH_ARM_STEPS = 2 + 3 * 10


def phase_bench(records: dict, flag: dict, smi: str) -> None:
    """``python -m carel_tpu_torch.cli bench`` in a process of its own, as a
    user runs it: the flagship's step at b64 x s96 timed captured and eager,
    and the reference's eager step (transformers BERT-base, fp32, anomaly
    detection) on the card. Its JSON line is held to itself and to the
    capture phase's flagship ``flag``, and its kernel launches, counted
    from 0 in its process, to K1-K4 once and K10 once a step."""
    argv = [sys.executable, "-m", "carel_tpu_torch.cli", "bench"]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [ROOT] + [p for p in [os.environ.get("PYTHONPATH", "")] if p]))
    t0 = time.perf_counter()
    proc = subprocess.run(argv, cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=600)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        fail(f"bench exited {proc.returncode}:\n{proc.stderr[-4000:]}")
    lines = proc.stdout.strip().splitlines()
    try:
        line = json.loads(lines[-1]) if lines else None
    except json.JSONDecodeError:
        line = None
    if not isinstance(line, dict) or "details" not in line:
        fail(f"bench: no JSON last line in {proc.stdout[-2000:]!r}")
    value, d = line["value"], line["details"]
    ms = d["ms_per_step"]
    if not (isinstance(value, float) and math.isfinite(value) and value > 0):
        fail(f"bench: value {value}")
    if abs(value * ms / 1e3 - 64) > 1e-6 * 64:
        fail(f"bench: {value} pairs/s at {ms} ms/step is not batch 64")
    if not 0.0 < d["mfu_pct_of_h100_bf16_peak"] <= 100.0:
        fail(f"bench: MFU {d['mfu_pct_of_h100_bf16_peak']} %")
    if not 0.67 * flag["wall_ms"] <= ms <= 1.5 * flag["wall_ms"]:
        fail(f"bench: captured {ms:.3f} ms/step against the capture "
             f"phase's {flag['wall_ms']:.3f}")
    if d["captures"] != 1:
        fail(f"bench: {d['captures']} captures (want 1)")
    want = dict.fromkeys(PATH_KERNELS[FLAGSHIP], BENCH_ARM_STEPS)
    want.update(xla_attn_fwd=12 * BENCH_ARM_STEPS,
                xla_attn_bwd=12 * BENCH_ARM_STEPS)
    for arm in ("captured", "eager"):
        # the line lists the kernels launched; a path kernel missing is 0
        count_path_launches(records, f"bench {arm}",
                            {**dict.fromkeys(want, 0), **d["launches"][arm]},
                            want)
    print(f"bench: exit 0 in {wall:.1f} s wall; {value:.1f} pairs/s "
          f"captured ({ms:.3f} ms/step; the capture phase's flagship "
          f"{flag['wall_ms']:.3f}), eager {d['ms_per_step_eager']:.3f} "
          f"ms/step, {d['model_tflops_per_sec']:.2f} TFLOP/s, MFU "
          f"{d['mfu_pct_of_h100_bf16_peak']:.3f} % of 989 bf16; reference "
          f"(transformers BERT-base fp32 b64xs128, anomaly detection) "
          f"{d['torch_reference_ms_step']:.1f} ms/step, "
          f"{d['torch_reference_pairs_per_sec']:.1f} pairs/s, ratio "
          f"{d['torch_reference_ratio']:.2f} on "
          f"{d['torch_reference_device']}; launches a arm {want}; bench "
          f"device {d['device']}; {smi}", flush=True)
    print(f"bench line: {json.dumps(line)}", flush=True)


def held_after(phase: str) -> None:
    HELD[phase] = round(torch.cuda.memory_allocated() / 2**30, 3)


def main() -> int:
    smi = phase_device()
    sys.path.insert(0, ROOT)
    phase_host()
    phase_build()
    records: dict = {}
    phase_mmd(records)
    phase_hsic(records)
    phase_bow(records)
    phase_bow_corrections(records)
    phase_embedding(records)
    phase_moe(records)
    phase_scores()
    phase_flash(records)
    phase_xla_attention(records)
    for preset in ZH_PATHS:
        phase_reference(preset)
    phase_reference(FLAGSHIP, "flash")
    for kind in ADAPTER_KINDS:
        phase_reference(FLAGSHIP, adapter=kind)
    phase_reference_stage1()
    phase_reference_original()
    phase_reference_pretrain()
    paths = {}
    for preset, iterations, strategy in (
            (FLAGSHIP, 1, "temporal_order_modification"),
            ("ec_hsic", 2, "random"), ("ec_gan", 1, "random"),
            ("ec_vi_final", 1, "random")):
        paths[preset] = phase_path(records, preset, iterations, strategy)
        torch.cuda.empty_cache()
        held_after(preset)
    for kind in ADAPTER_KINDS:
        paths[f"adapter {kind}"] = phase_adapter(records, kind)
        torch.cuda.empty_cache()
        held_after(f"adapter {kind}")
    paths["bf16 mu"] = phase_path(
        records, FLAGSHIP, 1, "temporal_order_modification",
        cfg=mu_bf16_config(), timed_epochs=True, name="bf16 mu")
    torch.cuda.empty_cache()
    held_after("bf16 mu")
    new_paths = {"embed": phase_embed(records, smi)}
    embed = {k: new_paths["embed"].pop(k) for k in ("enc", "params")}
    torch.cuda.empty_cache()
    held_after("embed")
    paths["flash"] = phase_serve(records)
    torch.cuda.empty_cache()
    held_after("flash")
    new_paths["cit"] = phase_cit(records, paths["flash"].pop("served"),
                                 embed, smi)
    torch.cuda.empty_cache()
    held_after("cit")
    pair = phase_pair(records)
    torch.cuda.empty_cache()
    held_after("pair")
    new_paths["original"] = phase_original(records, smi)
    torch.cuda.empty_cache()
    held_after("original")
    new_paths["clustering"] = phase_cluster(records, embed, smi)
    del embed
    torch.cuda.empty_cache()
    held_after("clustering")
    pre = phase_pretrain(records, smi)
    new_paths["pretrain"] = {k: pre.pop(k) for k in
                             ("wall_ms", "device_ms", "kernels", "peak_gib")}
    torch.cuda.empty_cache()
    held_after("pretrain")
    new_paths["ordering"] = phase_ordering(records, pre, smi)
    torch.cuda.empty_cache()
    held_after("ordering")
    phase_case_analysis(records, smi)
    torch.cuda.empty_cache()
    held_after("case_analysis")
    phase_hpo(records, smi)
    torch.cuda.empty_cache()
    held_after("hpo")
    paths[EN_PRESET] = phase_en(records)
    torch.cuda.empty_cache()
    clause_paths = {}
    for mixer, impl, carried in STAGE1_RUNS:
        clause_paths[f"stage1 {mixer}/{impl}"] = phase_stage1(
            records, mixer, impl, carried)
        torch.cuda.empty_cache()
    clause_paths["dann"] = phase_dann(records)
    torch.cuda.empty_cache()
    steps = {}
    for preset, impl in CAPTURE_VARIANTS:
        steps[preset if impl == "xla" else "flash"] = phase_capture(preset,
                                                                    impl)
    for preset in (FLAGSHIP, "ec_vi_final"):
        phase_sensitivity(preset)
    phase_bits("entmax adapter", adapter_config("entmax"))
    phase_bits("bf16 mu", mu_bf16_config(), resume=True)
    phase_adam()
    # the verbs run in processes of their own, after every profiled phase:
    # another process on the card made this one's profiler drop kernel
    # records afterwards (PERF.md, PR 16)
    zh = phase_verb_zh(records, smi)
    phase_mesh(records, zh, smi)
    del zh
    phase_verb_en(records, smi)
    held_after("verbs")
    flag = steps[FLAGSHIP]["captured"]
    phase_bench(records, flag, smi)
    print(f"memory held between phases (allocated, GiB): {HELD}",
          flush=True)
    for name, by_kind in steps.items():
        for kind in ("eager", "captured"):
            p = by_kind[kind]
            print(f"step b64xs96, {name} ({kind}): device "
                  f"{p['device_ms']:.2f} ms/step "
                  f"({p['device_ms'] - flag['device_ms']:+.2f} against the "
                  f"captured flagship), {p['kernels']:.1f} kernels/step, "
                  f"wall {p['wall_ms']:.2f} ms/step (device busy "
                  f"{p['device_ms'] / p['wall_ms']:.3f}), peak memory "
                  f"{p['peak_gib']:.2f} GiB", flush=True)
        path = paths[name]
        print(f"path {name} (captured: train, evaluate, self-train): peak "
              f"memory {path['peak_gib']:.2f} GiB"
              + (f", K3/K4 {path['bow_per_step']:.0f} a step"
                 if "bow_per_step" in path else ""), flush=True)
    en = paths[EN_PRESET]["step"]
    print(f"step b64xs128, {EN_PRESET} over roberta-base's shape "
          f"(captured): device {en['device_ms']:.2f} ms/step "
          f"({en['device_ms'] - flag['device_ms']:+.2f} against the captured "
          f"flagship at b64xs96), {en['kernels']:.1f} kernels/step, wall "
          f"{en['wall_ms']:.2f} ms/step (device busy "
          f"{en['device_ms'] / en['wall_ms']:.3f}), peak memory "
          f"{en['peak_gib']:.2f} GiB; path peak memory "
          f"{paths[EN_PRESET]['peak_gib']:.2f} GiB, K3/K4 "
          f"{paths[EN_PRESET]['bow_per_step']:.0f} a step", flush=True)
    for name in [f"adapter {kind}" for kind in ADAPTER_KINDS] + ["bf16 mu"]:
        p = paths[name]["step"]
        print(f"step b64xs96, {name} (captured): device "
              f"{p['device_ms']:.2f} ms/step "
              f"({p['device_ms'] - flag['device_ms']:+.2f} against the "
              f"captured flagship), {p['kernels']:.1f} kernels/step "
              f"({p['kernels'] - flag['kernels']:+.1f}), wall "
              f"{p['wall_ms']:.2f} ms/step (device busy "
              f"{p['device_ms'] / p['wall_ms']:.3f}), peak memory over the "
              f"timed epochs {p['peak_gib']:.2f} GiB; path peak memory "
              f"{paths[name]['peak_gib']:.2f} GiB "
              f"({paths[name]['peak_gib'] - paths[FLAGSHIP]['peak_gib']:+.3f} "
              f"against the flagship path), K3/K4 "
              f"{paths[name]['bow_per_step']:.0f} a step", flush=True)
    print(f"step b64xs96, pair classifier (eager, flash): device "
          f"{pair['device_ms']:.2f} ms/step "
          f"({pair['device_ms'] - flag['device_ms']:+.2f} against the "
          f"captured flagship), {pair['kernels']:.1f} kernels/step, wall "
          f"{pair['wall_ms']:.2f} ms/step (device busy "
          f"{pair['device_ms'] / pair['wall_ms']:.3f}; "
          f"{64 / pair['wall_ms'] * 1e3:.1f} pairs/s), peak memory "
          f"{pair['peak_gib']:.2f} GiB", flush=True)
    for name, p in new_paths.items():
        print(path_line(f"path {name}", p, p["peak_gib"], smi,
                        "call" if name == "ordering" else "step"),
              flush=True)
    for name, p in clause_paths.items():
        print(f"path {name} (eager): device {p['device_ms']:.2f} ms/step, "
              f"{p['kernels']:.1f} kernels/step, wall {p['wall_ms']:.2f} "
              f"ms/step (device busy {p['device_ms'] / p['wall_ms']:.3f}), "
              f"peak memory {p['peak_gib']:.2f} GiB", flush=True)
    print(f"device_profile: {PROFILE_WINDOWS['empty']} of "
          f"{PROFILE_WINDOWS['profiled']} windows recorded no device event, "
          f"{PROFILE_WINDOWS['short']} epoch profiles missed a path kernel's "
          f"launch, {PROFILE_WINDOWS['guard_lost']} of "
          f"{PROFILE_WINDOWS['guarded']} windows with work lost a guard's "
          f"record ({PROFILE_WINDOWS['guards_lost']} of "
          f"{2 * GUARD_KERNELS * PROFILE_WINDOWS['guarded']} guards' records)",
          flush=True)
    shutil.rmtree(RUN_DIR, ignore_errors=True)
    print(json.dumps({"kernels": list(records.values())}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
