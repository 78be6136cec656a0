"""What the drivers share: the program's configuration built from the
cell's files, the model with the seed's weights, the seeds of the
program's generators, the batches handed to the reference, and the
program's readings of its first steps from its optimizer."""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from harness.weights import make_weights, weight_seed
from reference import carel as ref
from reference.encoder import part_norms

# streams of the seed for the program's generators: the device's default
# one (dropout) and the sampling noise
DROPOUT_STREAM, NOISE_STREAM, REST_STREAM = 21, 22, 12


def dtype_of(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[name]


def encoder_config(c: dict, attention: str):
    from carel_tpu_torch.config import EncoderConfig

    return EncoderConfig(
        vocab_size=c["vocab_size"], hidden_dim=c["hidden_size"],
        num_layers=c["num_hidden_layers"], num_heads=c["num_attention_heads"],
        mlp_dim=c["intermediate_size"],
        max_position=c["max_position_embeddings"],
        type_vocab_size=c["type_vocab_size"],
        dropout=c["hidden_dropout_prob"], layer_norm_eps=c["layer_norm_eps"],
        arch=c["model_type"], pad_token_id=c["pad_token_id"],
        dtype=c["precision"]["encoder"], attention_impl=attention)


def program_config(c: dict, t: dict):
    """The port's CarelConfig: the configuration's preset with its encoder,
    latent size and BoW vocabulary, at the traffic's batch and length.
    Raises where the preset states other weights or rates than the
    configuration: the program would not run what the cell states."""
    from carel_tpu_torch.config import PRESETS

    k = c["carel"]
    if c["attention_probs_dropout_prob"] != c["hidden_dropout_prob"]:
        raise ValueError("the port's encoder takes one dropout rate")
    base = PRESETS[k["preset"]]
    lc, tc = base.loss, base.train
    stated = {"mmd_loss_weight": k["mmd_weight"],
              "mmd_alphas": tuple(k["mmd_alphas"]),
              "emo_mul_loss_weight": k["emo_weight"],
              "cau_mul_loss_weight": k["cau_weight"],
              "pair_mul_loss_weight": k["pair_weight"],
              "ec_kl_lambda": k["kl_lambda"],
              "kl_ann_iterations": k["kl_ann_iterations"],
              "label_smoothing": k["label_smoothing"]}
    differ = {n: (getattr(lc, n), v) for n, v in stated.items()
              if getattr(lc, n) != v}
    if base.model.dropout != k["head_dropout"]:
        differ["dropout"] = (base.model.dropout, k["head_dropout"])
    if tc.vae_lr != k["lr"]:
        differ["vae_lr"] = (tc.vae_lr, k["lr"])
    if lc.regularizer.value != k["regularizer"]:
        differ["regularizer"] = (lc.regularizer.value, k["regularizer"])
    if differ:
        raise ValueError(f"preset {k['preset']} differs from the "
                         f"configuration (preset, configuration): {differ}")
    model = dataclasses.replace(
        base.model, encoder=encoder_config(c, t["attention"]),
        ec_dim=k["ec_dim"], bow_dim=k["bow_vocab"],
        e_num_class=k["emotion_classes"])
    return base.replace(
        model=model,
        data=dataclasses.replace(base.data, max_len=t["max_len"]),
        train=dataclasses.replace(base.train, batch_size=t["batch"]))


def load_weights(model: torch.nn.Module, weights: Dict[str, torch.Tensor],
                 seed: int, device) -> None:
    """The seed's weights into ``model``; the program's leaves that the
    reference does not hold (the unused adversaries) get a draw of their
    own."""
    missing, unexpected = model.load_state_dict(weights, strict=False)
    if unexpected:
        raise KeyError(f"the program has no leaves {unexpected[:3]}")
    params = dict(model.named_parameters())
    rest = [(n, tuple(params[n].shape)) for n in missing if n in params]
    if len(rest) != len(missing):
        raise KeyError(f"unfilled state {sorted(set(missing) - set(params))}")
    if rest:
        model.load_state_dict(make_weights(rest, seed, device, REST_STREAM),
                              strict=False)


def build_model(pcfg, c: dict, k: dict, seed: int, device, phases=None):
    """The port's DrlModel on ``device`` holding the seed's weights;
    ``phases`` gets the time of each stage."""
    import time

    from carel_tpu_torch.models.drl import DrlModel

    mark = (phases or []).append
    # built where it runs: the meta device would spend seconds importing
    # its decompositions of the random initialisers
    with torch.device(device):
        model = DrlModel(pcfg.model)
    mark(("model built on the device", time.perf_counter()))
    weights = make_weights(ref.carel_spec(c, k), seed, device)
    mark(("weights drawn", time.perf_counter()))
    load_weights(model, weights, seed, device)
    return model


def seeds(seed: int):
    """(dropout seed, noise seed) of ``seed``."""
    return weight_seed(seed, DROPOUT_STREAM), weight_seed(seed, NOISE_STREAM)


def to_device(rows: Dict[str, np.ndarray], lo: int, hi: int,
              device) -> Dict[str, torch.Tensor]:
    """Rows lo..hi as the reference's batch, every row real."""
    out = {key: torch.from_numpy(np.ascontiguousarray(v[lo:hi])).to(device)
           for key, v in rows.items() if key != "temporal_order"}
    out["example_mask"] = torch.ones(hi - lo, device=device)
    return out


@torch.no_grad()
def first_gradient(optimizer, model) -> Dict[str, float]:
    """Each leaf's gradient norm at the first step, from the optimizer's
    first moment after it: (1 - beta1) g."""
    names = {id(p): n for n, p in model.named_parameters()}
    moments = []
    for group in optimizer.param_groups:
        beta1 = group["betas"][0]
        moments += [(names[id(p)], optimizer.state[p]["exp_avg"] / (1 - beta1))
                    for p in group["params"]
                    if "exp_avg" in optimizer.state.get(p, {})]
    return part_norms(moments)


@torch.no_grad()
def change(optimizer, model, start: Dict[str, torch.Tensor]
           ) -> Dict[str, float]:
    """The norm of each trained leaf's change since ``start``."""
    held = {id(p) for g in optimizer.param_groups for p in g["params"]}
    return part_norms((n, p - start[n]) for n, p in model.named_parameters()
                      if id(p) in held)
