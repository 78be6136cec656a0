"""MLM pretraining through the port's ``pretrain/mlm.MlmTrainer``, as the
``pretrain`` verb runs it: the corpus on the card, one step captured and
replayed ``scan_size`` times a dispatch, the dispatch's mean loss
fetched.

Set-up builds the MlmModel with the seed's weights and the trainer (its
generator seeded from the seed), and runs three dispatches of one step
(the first captures): their losses, the first gradient from AdamW's first
moment and the change after three steps are the program's readings; the
reference repeats the three steps with the same draws. A unit is one
dispatch.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from drivers import _carel
from harness import compare
from harness import traffic as tr
from harness.weights import make_weights
from harness.work import mlm_flops_per_step
from reference import mlm as ref
from reference.numerics import Numerics, set_reference_numerics


class Driver:
    def __init__(self, c: dict, t: dict, seed: int, device):
        self.c, self.t, self.seed = c, t, seed
        self.device = torch.device(device)
        self.ids, self.mask = tr.mlm_corpus(t, c["vocab_size"], seed)
        _, self.noise_seed = _carel.seeds(seed)
        B, L = t["batch"], t["seq_len"]
        masked = B * t["mask_prob"] * tr.mean_candidates(t)
        self.flops = mlm_flops_per_step(
            B, L, masked, c["hidden_size"], c["num_hidden_layers"],
            c["intermediate_size"], c["vocab_size"])
        self.trace_units = 1

    def shapes(self) -> dict:
        return {"B": self.t["batch"], "L": self.t["seq_len"],
                "D": self.c["hidden_size"]}

    def setup(self) -> None:
        self.phases = [("start", time.perf_counter())]
        from carel_tpu_torch.pretrain.mlm import (MlmConfig, MlmModel,
                                                  MlmTrainer)

        self.phases.append(("program imported", time.perf_counter()))
        torch.empty(1, device=self.device)
        self.phases.append(("device ready", time.perf_counter()))
        t = self.t
        enc = _carel.encoder_config(self.c, t["attention"])
        with torch.device(self.device):
            self.model = MlmModel(enc)
        self.phases.append(("model built on the device", time.perf_counter()))
        self.model.load_state_dict(make_weights(ref.mlm_spec(self.c),
                                                self.seed, self.device))
        self.phases.append(("model", time.perf_counter()))
        mcfg = MlmConfig(batch_size=t["batch"], seq_len=t["seq_len"],
                         steps=1 << 30, warmup_steps=t["warmup_steps"],
                         learning_rate=t["lr"], mask_prob=t["mask_prob"],
                         seed=self.noise_seed, scan_size=t["scan_size"])
        self.trainer = MlmTrainer(self.model, mcfg, self.ids, self.mask,
                                  None, t["mask_id"], self.device)
        losses = [float(self.trainer.dispatch(1))]
        self.phases.append(("first step (capture)", time.perf_counter()))
        grad = _carel.first_gradient(self.trainer.optimizer, self.model)
        losses += [float(self.trainer.dispatch(1)) for _ in range(2)]
        self.program = {"losses": losses, "grad": grad,
                        "change": _carel.change(
                            self.trainer.optimizer, self.model,
                            make_weights(ref.mlm_spec(self.c), self.seed,
                                         self.device))}
        self.phases.append(("steps 2-3 and readings", time.perf_counter()))

    def unit(self, spans: list) -> dict:
        n = self.t["scan_size"]
        t0 = time.perf_counter()
        mean = self.trainer.dispatch(n)
        t1 = time.perf_counter()
        loss = float(mean)
        t2 = time.perf_counter()
        spans.append(("dispatch_launch", t0, t1))
        spans.append(("replays_and_fetch", t1, t2))
        if not np.isfinite(loss):
            raise FloatingPointError(f"non-finite loss {loss}")
        B, L = self.t["batch"], self.t["seq_len"]
        return {"tokens": float(n * B * L), "steps": float(n),
                "flops": n * self.flops}

    def counters(self) -> dict:
        return {"captures": self.trainer.captures,
                "replays": self.trainer.replays}

    def release(self) -> None:
        self.trainer = self.model = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, mode: str = "fp32", half: bool = False,
                  head: str = "fp32") -> dict:
        set_reference_numerics()
        P = make_weights(ref.mlm_spec(self.c), self.seed, self.device)
        gen = torch.Generator(device=self.device).manual_seed(
            self.noise_seed)
        ids = torch.from_numpy(self.ids).to(self.device)
        mask = torch.from_numpy(self.mask).to(self.device)
        return ref.train_steps(
            P, self.c, self.t, ids, mask, gen, 3,
            Numerics(mode, head=head),
            _carel.dtype_of(self.c["precision"]["encoder"]), half)

    def numbers(self, reference: dict, program: dict = None) -> dict:
        return compare.training_numbers(program or self.program, reference)
