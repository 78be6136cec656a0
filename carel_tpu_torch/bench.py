"""Flagship train-step throughput on the card: the port's ``bench`` verb.

The counterpart of the root ``bench.py`` as ``python -m carel_tpu.cli bench``
runs it: the full CAREL-VAE training step (12L/768H encoder in bf16, VAE
heads, MMD regularizer, pos-weighted pair BCE, BoW reconstruction over a
23,808-word vocabulary) at batch 64 over the s96 zero-truncation window, on
one random batch drawn from ``np.random.default_rng(0)``.

Two arms of the same step on the same batch, each warmed up for 2 steps,
then ``rounds`` rounds of ``n_steps`` steps at within-epoch iterations 0 ..
n_steps - 1 (JAX passes ``i`` to its step), each round ended by a value
fetch of its last loss; the best round counts:

- captured (the headline): the ``EpochStep`` of ``train/scan_epoch.py``
  over the batch stacked ``n_steps`` times, which is what ``train`` runs by
  default. A round holds the epoch's pack into pinned memory, its one copy
  to the card, ``n_steps`` graph replays and the fetch. One capture serves
  every round; a second would be timed inside a round, so it raises.
- eager: ``make_train_step`` of ``train/steps.py``, the literal counterpart
  of the jitted step JAX times.

JAX's second arm, ``rng_impl="rbg"``, has no counterpart: torch has one
generator (Philox), so the line says ``"rng_recipe": "philox"``.

Also reported: analytic model FLOPs a step (JAX's formula), the TFLOP/s they
give at the captured step's time, their share of the H100's dense bf16 peak
(989 TFLOP/s), and the reference's own eager step (``transformers``
BERT-base, fp32, anomaly detection on) measured on the same device for
context. ``vs_baseline`` stays JAX's: the single-A100 envelope the reference
trained on.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", "details"}.

    python -m carel_tpu_torch.cli bench [--device cuda|cpu]
"""

from __future__ import annotations

import json
import subprocess
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from carel_tpu_torch import ops
from carel_tpu_torch.config import (CarelConfig, DataConfig, EncoderConfig,
                                    LossConfig, ModelConfig, Regularizer,
                                    TrainConfig)
from carel_tpu_torch.device import resolve_device
from carel_tpu_torch.models.drl import DrlModel
from carel_tpu_torch.models.encoder import init_flax_
from carel_tpu_torch.train.scan_epoch import WARMUP_STEPS, make_epoch_step
from carel_tpu_torch.train.state import TrainState, create_train_state
from carel_tpu_torch.train.steps import batch_to_device, make_train_step

A100_ENVELOPE_PAIRS_PER_SEC = 800.0  # historical context only
BENCH_BATCH = 64
BENCH_SEQ = 96  # zero-truncation window for the zh corpora
BOW_TERMS = 32  # BoW indices a row
H100_BF16_PEAK_TFLOPS = 989.0  # dense, SXM, 700 W


def bench_config() -> CarelConfig:
    """The flagship at the bench's operating point: bert-base sized encoder
    over the zh vocabulary (bf16, the default attention), ec_dim 24, BoW V
    23,808, the MMD loss with its default weights, batch 64 at max_len 96."""
    model = ModelConfig(encoder=EncoderConfig(vocab_size=21128), ec_dim=24,
                        bow_dim=23808)
    return CarelConfig(model=model,
                       loss=LossConfig(regularizer=Regularizer.MMD),
                       data=DataConfig(max_len=BENCH_SEQ),
                       train=TrainConfig(batch_size=BENCH_BATCH))


def bench_batch(cfg: CarelConfig, seed: int = 0) -> Dict[str, np.ndarray]:
    """One batch of random ids and labels for ``cfg``'s shape, drawn in
    JAX's order: ids, pair labels, emotion labels, BoW indices."""
    B, L = cfg.train.batch_size, cfg.data.max_len
    rng = np.random.default_rng(seed)
    return {
        "input_ids": rng.integers(
            1, cfg.model.encoder.vocab_size, (B, L)).astype(np.int32),
        "attention_mask": np.ones((B, L), np.int32),
        "token_type_ids": np.zeros((B, L), np.int32),
        "pair_labels": rng.integers(0, 2, B).astype(np.float32),
        "emotion_labels": rng.integers(0, 6, B).astype(np.int32),
        "bow_indices": rng.integers(
            0, cfg.model.bow_dim, (B, BOW_TERMS)).astype(np.int32),
        "bow_weights": np.full((B, BOW_TERMS), 1.0 / BOW_TERMS, np.float32),
        "example_mask": np.ones(B, np.float32),
    }


def train_flops_per_step(B: int, L: int, d: int = 768, layers: int = 12,
                         ffn: int = 3072, bow_dim: int = 23808,
                         ec_dim: int = 24) -> float:
    """Analytic matmul FLOPs for one fwd+bwd step (bwd ~ 2x fwd)."""
    # per token, per layer: QKVO projections + FFN + attention matmuls
    proj = 2 * 4 * d * d + 2 * 2 * d * ffn
    attn = 2 * 2 * L * d
    fwd_encoder = B * L * layers * (proj + attn)
    # heads: 4 latent projections, classifiers, BoW decoder (48 -> 23.8k)
    fwd_heads = B * 2 * (4 * d * ec_dim + ec_dim * 6 + ec_dim
                         + 2 * ec_dim + 2 * ec_dim * bow_dim)
    return 3.0 * (fwd_encoder + fwd_heads)


def bench_state(cfg: CarelConfig, device: torch.device) -> TrainState:
    """The model with Flax-style init from a CPU generator seeded 0, on
    ``device``, and its optimizers; the training stream (dropout, from the
    default generator, and the sampling noise) seeded 2, as JAX's bench
    seeds its params with key 0 and its train state with key 2."""
    torch.manual_seed(2)
    model = DrlModel(cfg.model)
    init_flax_(model, torch.Generator().manual_seed(0))
    model.to(device)
    return create_train_state(cfg, model,
                              torch.Generator(device=device).manual_seed(2))


def stacked(arrays: Dict[str, np.ndarray], n: int) -> Dict[str, np.ndarray]:
    """The batch ``arrays`` stacked ``n`` times: an epoch of ``n`` steps."""
    return {k: np.stack([v] * n) for k, v in arrays.items()}


def eager_steps(step: Callable, state: TrainState,
                batch: Dict[str, torch.Tensor], n: int) -> torch.Tensor:
    """``n`` eager steps on ``batch`` at iterations 0 .. n - 1: their
    losses, on the device, not synchronized."""
    return torch.stack([step(state, batch, i)["loss"] for i in range(n)])


def best_round(run: Callable[[], torch.Tensor], rounds: int) -> float:
    """Seconds of the fastest of ``rounds`` calls of ``run``, each ended by
    a value fetch of its last loss (the fetch waits for the device)."""
    best = float("inf")
    for _ in range(rounds):
        t0 = time.perf_counter()
        float(run()[-1])
        best = min(best, time.perf_counter() - t0)
    return best


def card_line(device: torch.device) -> str:
    """The card's name and power limit as nvidia-smi gives them, or
    "cpu"."""
    if device.type != "cuda":
        return "cpu"
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    return subprocess.run(
        ["nvidia-smi", "-i", str(index), "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
        check=True).stdout.strip()


def launched() -> dict:
    """The kernel launches counted since the last reset, those not 0."""
    return {k: n for k, n in ops.launch_counts().items() if n}


def time_port(cfg: CarelConfig, device: torch.device, n_steps: int,
              rounds: int) -> dict:
    """Both arms of the port's step on one state and one batch: the best
    round's seconds of each, the epoch step's captures and each arm's
    kernel launches (warm-up included)."""
    arrays = bench_batch(cfg)
    state = bench_state(cfg, device)
    out = {}

    ops.reset_launch_counts()
    epoch_step = make_epoch_step(cfg)
    float(epoch_step(state, stacked(arrays, WARMUP_STEPS), 0.0)[-1])
    epoch = stacked(arrays, n_steps)
    out["captured_s"] = best_round(lambda: epoch_step(state, epoch, 0.0),
                                   rounds)
    want = 1 if device.type == "cuda" else 0
    if epoch_step.captures != want:
        raise RuntimeError(f"the epoch step made {epoch_step.captures} "
                           f"captures (want {want}): a capture was timed")
    out["captures"] = epoch_step.captures
    out["captured_launches"] = launched()

    ops.reset_launch_counts()
    step = make_train_step(cfg)
    batch = batch_to_device(arrays, device)
    float(eager_steps(step, state, batch, WARMUP_STEPS)[-1])
    out["eager_s"] = best_round(
        lambda: eager_steps(step, state, batch, n_steps), rounds)
    out["eager_launches"] = launched()
    return out


def reference_bert_config(cfg: CarelConfig):
    """The ``transformers`` BertConfig of ``cfg``'s encoder (at
    ``bench_config()``: ``BertConfig(vocab_size=21128)``)."""
    from transformers import BertConfig

    enc = cfg.model.encoder
    return BertConfig(vocab_size=enc.vocab_size, hidden_size=enc.hidden_dim,
                      num_hidden_layers=enc.num_layers,
                      num_attention_heads=enc.num_heads,
                      intermediate_size=enc.mlp_dim,
                      max_position_embeddings=enc.max_position,
                      type_vocab_size=enc.type_vocab_size,
                      layer_norm_eps=enc.layer_norm_eps)


def measure_torch_reference(cfg: Optional[CarelConfig] = None,
                            B: int = BENCH_BATCH, L: int = 128,
                            steps: int = 2, device="cuda") -> dict:
    """The reference's training step, measured on ``device``: eager torch
    in fp32 (TF32 stays off, ``device.set_numerics``), a ``transformers``
    BertModel of ``cfg``'s widths (``bench_config()`` by default: BERT-base)
    from random init, the flagship loss stack, anomaly detection ON
    (flagship :837), b64 x s128 as the reference trains.

    Architecture per drl_classifier_ec_mmd_final_mul.py :149-263 (pooler ->
    4x 768->24 latent heads, shared-eps sampling :345-351, emotion CE, cause
    BCE, pos-weighted pair BCE, -MMD :537-596, KLs, BoW recon)."""
    from transformers import BertModel

    cfg = cfg or bench_config()
    device = resolve_device(device)
    torch.manual_seed(0)
    bert = BertModel(reference_bert_config(cfg)).to(device)
    d, ec, bow = (cfg.model.encoder.hidden_dim, cfg.model.ec_dim,
                  cfg.model.bow_dim)
    heads = torch.nn.ModuleDict({
        "emo_mu": torch.nn.Linear(d, ec), "emo_lv": torch.nn.Linear(d, ec),
        "cau_mu": torch.nn.Linear(d, ec), "cau_lv": torch.nn.Linear(d, ec),
        "emo_cls": torch.nn.Linear(ec, 6), "cau_cls": torch.nn.Linear(ec, 1),
        "pair_cls": torch.nn.Linear(2 * ec, 1),
        "decoder": torch.nn.Linear(2 * ec, bow),
    }).to(device)
    params = list(bert.parameters()) + list(heads.parameters())
    opt = torch.optim.Adam(params, lr=1e-5)

    g = torch.Generator(device=device).manual_seed(0)
    ids = torch.randint(1, cfg.model.encoder.vocab_size, (B, L),
                        generator=g, device=device)
    mask = torch.ones(B, L, dtype=torch.long, device=device)
    emo_y = torch.randint(0, 6, (B,), generator=g, device=device)
    pair_y = torch.randint(0, 2, (B,), generator=g, device=device).float()
    bow_y = torch.rand(B, bow, generator=g, device=device)
    bow_y = bow_y / bow_y.sum(-1, keepdim=True)

    def pdist(a, b):
        # eps + abs inside the sqrt, like the reference (flagship :589)
        n2 = (a * a).sum(-1)[:, None] + (b * b).sum(-1)[None, :]
        return (1e-5 + (n2 - 2 * a @ b.T).abs()).sqrt()

    def mmd(x, y):
        n = x.shape[0]
        z = torch.cat([x, y])
        dist = pdist(z, z)
        k = torch.exp(-0.1 * dist ** 2)
        kxx = (k[:n, :n].sum() - n) / (n * (n - 1))
        kyy = (k[n:, n:].sum() - n) / (n * (n - 1))
        kxy = k[:n, n:].mean()
        return kxx + kyy - 2 * kxy

    def one_step():
        with torch.autograd.set_detect_anomaly(True):
            pooled = bert(ids, attention_mask=mask).pooler_output
            e_mu, e_lv = heads["emo_mu"](pooled), heads["emo_lv"](pooled)
            c_mu, c_lv = heads["cau_mu"](pooled), heads["cau_lv"](pooled)
            eps = torch.randn(ec, generator=g, device=device)
            e_z = e_mu + eps * torch.exp(e_lv)
            c_z = c_mu + eps * torch.exp(c_lv)
            ce = torch.nn.functional.cross_entropy(heads["emo_cls"](e_z),
                                                   emo_y)
            cau = torch.nn.functional.binary_cross_entropy_with_logits(
                heads["cau_cls"](c_z)[:, 0], pair_y)
            pos = pair_y.sum()
            pw = (B - pos) / pos.clamp(min=1.0)
            pair = torch.nn.functional.binary_cross_entropy_with_logits(
                heads["pair_cls"](torch.cat([e_z, c_z], -1))[:, 0], pair_y,
                pos_weight=pw)
            kl = (-0.5 * (1 + e_lv - e_lv.exp() - e_mu ** 2).sum(-1)).mean() \
                + (-0.5 * (1 + c_lv - c_lv.exp() - c_mu ** 2).sum(-1)).mean()
            recon = torch.nn.functional.binary_cross_entropy(
                torch.softmax(heads["decoder"](
                    torch.cat([e_z, c_z], -1)), -1).clamp(1e-7, 1 - 1e-7),
                bow_y)
            loss = (30 * (-mmd(e_z, c_z)) + 10 * ce + 10 * cau + 30 * pair
                    + 0.03 * kl + recon)
            opt.zero_grad()
            loss.backward()
            opt.step()
        return float(loss.detach())

    one_step()  # warmup
    t0 = time.perf_counter()
    for _ in range(steps):
        one_step()
    dt = (time.perf_counter() - t0) / steps
    return {"torch_reference_ms_step": dt * 1e3,
            "torch_reference_pairs_per_sec": B / dt,
            "torch_reference_device": (torch.cuda.get_device_name(device)
                                       if device.type == "cuda" else "cpu")}


def main(device="cuda", cfg: Optional[CarelConfig] = None, n_steps: int = 10,
         rounds: int = 3, reference: Optional[dict] = None) -> dict:
    """Time the step (``time_port``) and the reference, print the JSON line
    and return it. ``reference`` holds ``measure_torch_reference``'s B, L
    and steps (its defaults when None)."""
    device = resolve_device(device)
    cfg = cfg or bench_config()
    B, L = cfg.train.batch_size, cfg.data.max_len
    port = time_port(cfg, device, n_steps, rounds)
    best_dt = port["captured_s"]
    pairs_per_sec = n_steps * B / best_dt
    enc = cfg.model.encoder
    flops = train_flops_per_step(B, L, enc.hidden_dim, enc.num_layers,
                                 enc.mlp_dim, cfg.model.bow_dim,
                                 cfg.model.ec_dim)
    tflops_per_sec = flops / (best_dt / n_steps) / 1e12

    # the reference's own step on the same device (context only; the
    # headline comparator is the A100 envelope)
    ref = measure_torch_reference(cfg, device=device, **(reference or {}))
    ref["torch_reference_ratio"] = (
        pairs_per_sec / ref["torch_reference_pairs_per_sec"])

    line = {
        "metric": ("ECPE train pairs/sec/chip (flagship MMD step, bf16, "
                   f"b{B}xs{L} zero-truncation window, captured step, "
                   "value-fetch timed; vs_baseline = single-A100 reference "
                   "envelope, the hardware the reference trained on)"),
        "value": pairs_per_sec,
        "unit": "pairs/sec",
        "vs_baseline": pairs_per_sec / A100_ENVELOPE_PAIRS_PER_SEC,
        "details": {
            "ms_per_step": best_dt / n_steps * 1e3,
            "ms_per_step_eager": port["eager_s"] / n_steps * 1e3,
            "rng_recipe": "philox",
            "model_tflops_per_sec": tflops_per_sec,
            "mfu_pct_of_h100_bf16_peak": (
                100 * tflops_per_sec / H100_BF16_PEAK_TFLOPS),
            "baseline_kind": "a100-envelope",
            "a100_envelope_pairs_per_sec": A100_ENVELOPE_PAIRS_PER_SEC,
            **ref,
            "captures": port["captures"],
            "launches": {"captured": port["captured_launches"],
                         "eager": port["eager_launches"]},
            "device": card_line(device),
        },
    }
    print(json.dumps(line), flush=True)
    return line
