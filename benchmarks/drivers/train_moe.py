"""Training the pair classifier over a DeepSeek-V2 encoder through the
port's captured epoch step, as ``drivers/train.py`` runs the BERT encoder:
per epoch ``stack_epoch`` shuffles and cuts the training set, ``EpochStep``
copies it to the card and replays the captured step once a batch, and the
epoch's losses and MoE counters are fetched in one copy.

The configuration's ``n_routed_experts`` is the count of routed experts
held here (``experts_held``: the first one and the router's width); every
mixture layer routes over the router's width and computes the held
experts' part, as one expert-parallel rank does. The traffic's content ids
are drawn below ``tokens.content_below``.

The seed's weights, with each mixture layer's gate made orthogonal to the
mean of its input over the first check batch (``balance_gates``: random
gates would send most of a layer's tokens to one expert, and the held
experts' work would follow the seed; a trained router spreads them), go to
the program and to the reference alike. Where the configuration's
``carel.router`` is "frozen" the driver takes the gates out of training
(``requires_grad_(False)`` before the TrainState is made), and the
reference leaves them as they are: trained at lr 1e-5 with no balance loss,
such random gates sent a layer's tokens to one expert within ~100 steps.

Set-up builds the model with those weights and one TrainState, and runs
three steps on check rows through the same call, three epochs of one batch
(the first captures the step). Their losses, the first gradient and the
change after three steps are the program's readings, and so are the
experts each step's layers chose, read back after each epoch from the
captured step's own tensors (``MoE.record``). The reference
(``reference/carel_moe.py``) repeats the three steps from the same
weights, rows and draws, in blocks of rows, computing the experts the
program chose (a near-tie of the gate flips on bf16 rounding, and a
flipped choice moves an expert's gradient by a whole row). The share of
choices its own gate would have made otherwise, ``routing_flip_share``, is
compared with a limit of its own: sound runs read 0.12-0.15, a gate that
picks other experts than its scores' top-k reads near 1.
One full epoch more, untimed, ends the set-up. A unit is one epoch.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from drivers import _carel
from harness import compare
from harness import traffic as tr
from harness.weights import make_weights
from harness.work_moe import moe_train_flops_per_step
from reference import carel_moe as ref
from reference.deepseek_v2 import balance_gates
from reference.numerics import Numerics, set_reference_numerics

# rows of a block of the reference's encoder passes
REFERENCE_BLOCK_ROWS = 16


def model_keys(c: dict) -> dict:
    """The configuration's model keys with ``n_routed_experts`` the
    router's width, as the reference reads them."""
    return dict(c, n_routed_experts=c["experts_held"]["router_experts"])


def held_range(c: dict):
    return c["experts_held"]["first"], c["n_routed_experts"]


def encoder_config(c: dict, dtype: str):
    from carel_tpu_torch.config import DeepseekV2Config

    rs = c["rope_scaling"]
    return DeepseekV2Config(
        vocab_size=c["vocab_size"], hidden_dim=c["hidden_size"],
        num_layers=c["num_hidden_layers"],
        num_heads=c["num_attention_heads"], mlp_dim=c["intermediate_size"],
        max_position=c["max_position_embeddings"],
        layer_norm_eps=c["rms_norm_eps"], pad_token_id=c["tokens"]["pad"],
        dtype=dtype, kv_lora_rank=c["kv_lora_rank"],
        qk_nope_head_dim=c["qk_nope_head_dim"],
        qk_rope_head_dim=c["qk_rope_head_dim"], v_head_dim=c["v_head_dim"],
        moe_intermediate_size=c["moe_intermediate_size"],
        n_routed_experts=c["experts_held"]["router_experts"],
        n_shared_experts=c["n_shared_experts"],
        num_experts_per_tok=c["num_experts_per_tok"],
        first_k_dense_replace=c["first_k_dense_replace"],
        routed_scaling_factor=float(c["routed_scaling_factor"]),
        norm_topk_prob=c["norm_topk_prob"], rope_theta=float(c["rope_theta"]),
        rope_factor=float(rs["factor"]),
        rope_beta_fast=float(rs["beta_fast"]),
        rope_beta_slow=float(rs["beta_slow"]), rope_mscale=rs["mscale"],
        rope_mscale_all_dim=rs["mscale_all_dim"],
        rope_original_max_position=rs["original_max_position_embeddings"],
        experts_held=held_range(c))


def program_config(c: dict, t: dict):
    """The port's CarelConfig: the configuration's preset with this
    encoder, at the traffic's batch and length. Raises where the preset
    states other weights or rates than the configuration."""
    from carel_tpu_torch.config import PRESETS

    k = c["carel"]
    base = PRESETS[k["preset"]]
    lc = base.loss
    stated = {"mmd_loss_weight": k["mmd_weight"],
              "mmd_alphas": tuple(k["mmd_alphas"]),
              "emo_mul_loss_weight": k["emo_weight"],
              "cau_mul_loss_weight": k["cau_weight"],
              "pair_mul_loss_weight": k["pair_weight"],
              "ec_kl_lambda": k["kl_lambda"],
              "kl_ann_iterations": k["kl_ann_iterations"],
              "label_smoothing": k["label_smoothing"],
              "regularizer": k["regularizer"]}
    got = {n: getattr(lc, n) for n in stated}
    got["regularizer"] = lc.regularizer.value
    differ = {n: (got[n], v) for n, v in stated.items() if got[n] != v}
    if base.model.dropout != k["head_dropout"]:
        differ["dropout"] = (base.model.dropout, k["head_dropout"])
    if base.train.vae_lr != k["lr"]:
        differ["vae_lr"] = (base.train.vae_lr, k["lr"])
    if differ:
        raise ValueError(f"preset {k['preset']} differs from the "
                         f"configuration (preset, configuration): {differ}")
    model = dataclasses.replace(
        base.model, encoder=encoder_config(c, c["precision"]["encoder"]),
        ec_dim=k["ec_dim"], bow_dim=k["bow_vocab"],
        e_num_class=k["emotion_classes"])
    return base.replace(
        model=model,
        data=dataclasses.replace(base.data, max_len=t["max_len"]),
        train=dataclasses.replace(base.train, batch_size=t["batch"]))


def program_view(weights: dict, model: torch.nn.Module) -> dict:
    """The seed's weights in the program's shapes (each expert stack
    [held x rows, cols] as [held, rows, cols])."""
    shapes = {n: p.shape for n, p in model.named_parameters()}
    return {n: w.view(shapes[n]) if n in shapes else w
            for n, w in weights.items()}


class Driver:
    def __init__(self, c: dict, t: dict, seed: int, device):
        self.c, self.t, self.seed = c, t, seed
        self.device = torch.device(device)
        self.k = c["carel"]
        self.B = t["batch"]
        self.keys = model_keys(c)
        self.held = held_range(c)
        self.pcfg = program_config(c, t)
        self.spec = ref.carel_spec(self.keys, self.k, self.held)
        content = c["tokens"]["content_below"]
        self.rows = tr.pair_rows(t, c["tokens"], content,
                                 self.k["bow_vocab"], t["epoch_rows"], seed)
        self.check = tr.pair_rows(t, c["tokens"], content,
                                  self.k["bow_vocab"], 3 * self.B, seed,
                                  tr.STREAM_CHECK)
        self.order = tr.rng_for(seed, tr.STREAM_ORDER)
        self.dropout_seed, self.noise_seed = _carel.seeds(seed)
        self.flops = moe_train_flops_per_step(self.B, t["max_len"], self.keys,
                                              self.held[1],
                                              self.k["bow_vocab"],
                                              self.k["ec_dim"])
        self.trace_units = 1

    def shapes(self) -> dict:
        c, k = self.c, self.k
        return {"B": self.B, "L": self.t["max_len"], "D": c["hidden_size"],
                "moe_width": c["moe_intermediate_size"],
                "held_experts": self.held[1],
                "latent": k["ec_dim"], "mmd_alphas": len(k["mmd_alphas"]),
                "bow_hidden": 2 * k["ec_dim"], "bow_vocab": k["bow_vocab"],
                "bow_slots": self.t["bow_slots"],
                "tables": [c["vocab_size"]]}

    def _balanced(self) -> dict:
        """The seed's weights with the balanced gates (made on the first
        call)."""
        P = make_weights(self.spec, self.seed, self.device)
        if getattr(self, "gates", None) is None:
            set_reference_numerics()
            first = _carel.to_device(self.check, 0, self.B, self.device)
            balance_gates(P, self.keys, first["input_ids"],
                          first["attention_mask"], self.held)
            self.gates = {n: P[n].clone() for n in P
                          if n.endswith("mlp.gate")}
        for n, g in self.gates.items():
            P[n].copy_(g)
        return P

    def _weights(self, model) -> dict:
        return program_view(self._balanced(), model)

    def setup(self) -> None:
        self.phases = [("start", time.perf_counter())]
        from carel_tpu_torch.data.batching import PairArrays
        from carel_tpu_torch.models.drl import DrlModel
        from carel_tpu_torch.train.scan_epoch import (make_epoch_step,
                                                      stack_epoch)
        from carel_tpu_torch.train.state import create_train_state

        self.phases.append(("program imported", time.perf_counter()))
        torch.empty(1, device=self.device)
        self.phases.append(("device ready", time.perf_counter()))
        self.stack_epoch = stack_epoch
        with torch.device(self.device):
            model = DrlModel(self.pcfg.model)
        self.phases.append(("model built on the device",
                            time.perf_counter()))
        _carel.load_weights(model, self._weights(model), self.seed,
                            self.device)
        self.phases.append(("weights", time.perf_counter()))
        self.model = model
        if self.k["router"] == "frozen":
            # the configuration's gates are random ones balanced at set-up:
            # they take no gradient and no Adam update (``assumed.router``)
            for m in model.encoder.moe_layers():
                m.gate.requires_grad_(False)
        torch.manual_seed(self.dropout_seed)
        noise = torch.Generator(device=self.device).manual_seed(
            self.noise_seed)
        self.state = create_train_state(self.pcfg, model, noise)
        self.step = make_epoch_step(self.pcfg)
        self.arrays = PairArrays(**self.rows)
        check = PairArrays(**self.check)
        B = self.B
        layers = model.encoder.moe_layers()
        seen: list = []
        for m in layers:
            m.record = seen
        losses, self.program_routes = [], []
        for i in range(3):
            losses += list(self.step.fetch(self.step(
                self.state, stack_epoch(check.take(np.arange(i * B,
                                                             (i + 1) * B)),
                                        B), 0.0)))
            # the captured step's last tensors of top-k ids hold this
            # replay's choices
            self.program_routes.append([t.cpu() for t in
                                        seen[-len(layers):]])
            if i == 0:
                self.phases.append(("first step (capture)",
                                    time.perf_counter()))
                grad = _carel.first_gradient(self.state.optimizer, model)
        for m in layers:
            m.record = None
        del seen
        change = _carel.change(self.state.optimizer, model,
                               self._weights(model))
        self.phases.append(("steps 2-3 and readings", time.perf_counter()))
        self.program = {"losses": [float(v) for v in losses],
                        "grad": grad, "change": change}
        self.unit([])
        self.phases.append(("warm epoch", time.perf_counter()))

    def unit(self, spans: list) -> dict:
        t0 = time.perf_counter()
        stacked = self.stack_epoch(self.arrays, self.B, rng=self.order)
        t1 = time.perf_counter()
        losses = self.step(self.state, stacked, 0.0)
        t2 = time.perf_counter()
        host = self.step.fetch(losses)
        t3 = time.perf_counter()
        spans.append(("stack_epoch", t0, t1))
        spans.append(("epoch_step_call", t1, t2))
        spans.append(("fetch", t2, t3))
        if not np.isfinite(host).all():
            raise FloatingPointError(f"non-finite losses {host}")
        steps = len(host)
        return {"pairs": float(len(self.arrays)), "steps": float(steps),
                "flops": steps * self.flops}

    def counters(self) -> dict:
        return {"captures": self.step.captures, "replays": self.step.replays,
                "moe": self.step.moe_counts}

    def release(self) -> None:
        for name in ("state", "step", "model", "arrays"):
            setattr(self, name, None)
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, mode: str = "fp32", half: bool = False,
                  head: str = "fp32") -> dict:
        """The reference's three steps from the seed's weights, rows and
        draws, in ``mode`` and ``head`` (``Numerics``), computing the
        experts the program chose; ``half`` leaves out half of each batch.
        The fp32 reference's own choices are kept
        (``reference_routes``)."""
        set_reference_numerics()
        P = self._balanced()
        torch.manual_seed(self.dropout_seed)
        noise = torch.Generator(device=self.device).manual_seed(
            self.noise_seed)
        B = self.B
        batches = [_carel.to_device(self.check, i * B, (i + 1) * B,
                                    self.device) for i in range(3)]
        routes: list = []
        out = ref.train_steps(P, self.keys, self.k, self.held, batches,
                              [0, 0, 0], noise, Numerics(mode, head=head),
                              half, REFERENCE_BLOCK_ROWS, routes,
                              self.program_routes,
                              self.k["router"] == "frozen")
        if (mode, half, head) == ("fp32", False, "fp32"):
            self.reference_routes = [[r.cpu() for r in step]
                                     for step in routes]
        return out

    def numbers(self, reference: dict, program: dict = None) -> dict:
        """The training numbers and, for the program against the fp32
        reference, the share of (real token, layer, step) whose top-k
        experts differ from the reference's own gate's."""
        out = compare.training_numbers(program or self.program, reference)
        theirs = getattr(self, "reference_routes", None)
        if program is None and theirs is not None:
            masks = [torch.from_numpy(self.check["attention_mask"][
                i * self.B:(i + 1) * self.B]) for i in range(3)]
            out["routing_flip_share"] = ref.flip_share(self.program_routes,
                                                       theirs, masks)
        return out
