"""Training through the port's captured epoch step, as ``train_epochs``
runs it: per epoch ``stack_epoch`` shuffles and cuts the training set,
``EpochStep`` packs it, copies it to the card in one copy and replays the
captured step once a batch, and the epoch's losses are fetched.

Set-up builds the model with the seed's weights and one TrainState, seeds
the card's default generator (dropout) and the sampling generator, and
runs three steps through the same call on check rows that all differ: an
epoch of one batch (which captures the step) and an epoch of two. Their
losses, the first gradient (from Adam's first moment after one step) and
the parameters' change after three steps are the program's readings; the
reference repeats the three steps from the same weights, rows and draws.
One full epoch more, untimed, ends the set-up. A unit is one epoch.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from drivers import _carel
from harness import compare
from harness import traffic as tr
from harness.weights import make_weights
from harness.work import train_flops_per_step
from reference import carel as ref
from reference.numerics import Numerics, set_reference_numerics


class Driver:
    def __init__(self, c: dict, t: dict, seed: int, device):
        self.c, self.t, self.seed = c, t, seed
        self.device = torch.device(device)
        self.k = c["carel"]
        self.B = t["batch"]
        self.pcfg = _carel.program_config(c, t)
        self.rows = tr.pair_rows(t, c["tokens"], c["vocab_size"],
                                 self.k["bow_vocab"], t["epoch_rows"], seed)
        self.check = tr.pair_rows(t, c["tokens"], c["vocab_size"],
                                  self.k["bow_vocab"], 3 * self.B, seed,
                                  tr.STREAM_CHECK)
        self.order = tr.rng_for(seed, tr.STREAM_ORDER)
        self.dropout_seed, self.noise_seed = _carel.seeds(seed)
        self.flops = train_flops_per_step(
            self.B, t["max_len"], c["hidden_size"], c["num_hidden_layers"],
            c["intermediate_size"], self.k["bow_vocab"], self.k["ec_dim"])
        self.trace_units = 1

    def shapes(self) -> dict:
        c, k = self.c, self.k
        tables = [c["vocab_size"], c["max_position_embeddings"]]
        if c["type_vocab_size"] > 0:
            tables.append(c["type_vocab_size"])
        return {"B": self.B, "L": self.t["max_len"], "D": c["hidden_size"],
                "latent": k["ec_dim"], "mmd_alphas": len(k["mmd_alphas"]),
                "bow_hidden": 2 * k["ec_dim"], "bow_vocab": k["bow_vocab"],
                "bow_slots": self.t["bow_slots"], "tables": tables}

    def setup(self) -> None:
        self.phases = [("start", time.perf_counter())]
        from carel_tpu_torch.data.batching import PairArrays
        from carel_tpu_torch.train.scan_epoch import (make_epoch_step,
                                                      stack_epoch)
        from carel_tpu_torch.train.state import create_train_state

        self.phases.append(("program imported", time.perf_counter()))
        torch.empty(1, device=self.device)
        self.phases.append(("device ready", time.perf_counter()))
        self.stack_epoch = stack_epoch
        self.model = _carel.build_model(self.pcfg, self.c, self.k, self.seed,
                                        self.device, self.phases)
        self.phases.append(("model", time.perf_counter()))
        torch.manual_seed(self.dropout_seed)
        noise = torch.Generator(device=self.device).manual_seed(
            self.noise_seed)
        self.state = create_train_state(self.pcfg, self.model, noise)
        self.step = make_epoch_step(self.pcfg)
        self.arrays = PairArrays(**self.rows)
        check = PairArrays(**self.check)
        B = self.B
        l1 = self.step(self.state, stack_epoch(check.take(np.arange(B)), B),
                       0.0).cpu().numpy()
        self.phases.append(("first step (capture)", time.perf_counter()))
        grad = _carel.first_gradient(self.state.optimizer, self.model)
        l23 = self.step(self.state,
                        stack_epoch(check.take(np.arange(B, 3 * B)), B),
                        0.0).cpu().numpy()
        change = _carel.change(self.state.optimizer, self.model,
                               make_weights(ref.carel_spec(self.c, self.k),
                                            self.seed, self.device))
        self.phases.append(("steps 2-3 and readings", time.perf_counter()))
        self.program = {"losses": [float(l1[0]), float(l23[0]),
                                   float(l23[1])],
                        "grad": grad, "change": change}
        self.unit([])
        self.phases.append(("warm epoch", time.perf_counter()))

    def unit(self, spans: list) -> dict:
        t0 = time.perf_counter()
        stacked = self.stack_epoch(self.arrays, self.B, rng=self.order)
        t1 = time.perf_counter()
        losses = self.step(self.state, stacked, 0.0)
        t2 = time.perf_counter()
        host = losses.cpu().numpy()
        t3 = time.perf_counter()
        # a replay returns once the card's queue has room, so the epoch
        # step's call lasts about as long as its replays
        spans.append(("stack_epoch", t0, t1))
        spans.append(("epoch_step_call", t1, t2))
        spans.append(("fetch", t2, t3))
        if not np.isfinite(host).all():
            raise FloatingPointError(f"non-finite losses {host}")
        steps = len(host)
        return {"pairs": float(len(self.arrays)), "steps": float(steps),
                "flops": steps * self.flops}

    def counters(self) -> dict:
        return {"captures": self.step.captures, "replays": self.step.replays}

    def release(self) -> None:
        for name in ("state", "step", "model", "arrays"):
            setattr(self, name, None)
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, mode: str = "fp32", half: bool = False,
                  head: str = "fp32") -> dict:
        """The reference's three steps from the seed's weights, rows and
        draws, in ``mode`` and ``head`` (``Numerics``); ``half`` leaves
        out half of each batch."""
        set_reference_numerics()
        P = make_weights(ref.carel_spec(self.c, self.k), self.seed,
                         self.device)
        torch.manual_seed(self.dropout_seed)
        noise = torch.Generator(device=self.device).manual_seed(
            self.noise_seed)
        B = self.B
        batches = [_carel.to_device(self.check, i * B, (i + 1) * B,
                                    self.device) for i in range(3)]
        return ref.train_steps(
            P, self.c, self.k, batches, [0, 0, 1], noise,
            Numerics(mode, head=head),
            _carel.dtype_of(self.c["precision"]["encoder"]), half)

    def numbers(self, reference: dict, program: dict = None) -> dict:
        return compare.training_numbers(program or self.program, reference)
