"""Scoring through the port's ``infer/pair_inference.score_pairs`` with
``make_eval_step(sample=True)``, as ``evaluate`` and every pseudo-label
pass run it: a closed loop of one caller, each request one batch of
candidate pairs of a domain file, from the host arrays to the
probabilities on the host. The noise of each request's latents comes
from one generator on the card, two draws a request.

Set-up builds the model with the seed's weights, makes the domain file
and scores a few requests with a generator of their own (the warm-up).
A unit is one request. The check: a sample of the window's requests,
drawn from the seed, scored again by the reference with the same noise.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from drivers import _carel
from harness import traffic as tr
from harness.weights import make_weights
from harness.work import score_flops_per_batch
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
                                 self.k["bow_vocab"],
                                 t["file_requests"] * self.B, seed)
        self.dropout_seed, self.noise_seed = _carel.seeds(seed)
        self.flops = score_flops_per_batch(
            self.B, t["max_len"], c["hidden_size"], c["num_hidden_layers"],
            c["intermediate_size"], self.k["ec_dim"])
        self.trace_units = t["trace_requests"]
        self.outputs = []

    def shapes(self) -> dict:
        return {"B": self.B, "L": self.t["max_len"],
                "D": self.c["hidden_size"]}

    def _request(self, j: int):
        lo = (j % self.t["file_requests"]) * self.B
        return self.arrays.take(np.arange(lo, lo + self.B))

    def setup(self) -> None:
        self.phases = [("start", time.perf_counter())]
        from carel_tpu_torch.data.batching import PairArrays
        from carel_tpu_torch.infer.pair_inference import score_pairs
        from carel_tpu_torch.train.steps import make_eval_step

        self.phases.append(("program imported", time.perf_counter()))
        torch.empty(1, device=self.device)
        self.phases.append(("device ready", time.perf_counter()))
        self.score_pairs = score_pairs
        self.model = _carel.build_model(self.pcfg, self.c, self.k, self.seed,
                                        self.device, self.phases)
        self.model.eval()
        self.phases.append(("model", time.perf_counter()))
        self.eval_step = make_eval_step(sample=True)
        self.arrays = PairArrays(**self.rows)
        self.requests = [self._request(j)
                         for j in range(self.t["file_requests"])]
        warm = torch.Generator(device=self.device).manual_seed(
            self.noise_seed ^ 1)
        for j in range(self.t["warmup_requests"]):
            score_pairs(self.eval_step, self.model, self.requests[j], warm,
                        self.B)
        self.phases.append(("warm requests", time.perf_counter()))
        self.gen = torch.Generator(device=self.device).manual_seed(
            self.noise_seed)
        self.program = None

    def unit(self, spans: list) -> dict:
        j = len(self.outputs)
        t0 = time.perf_counter()
        probs, _ = self.score_pairs(self.eval_step, self.model,
                                    self.requests[j % len(self.requests)],
                                    self.gen, self.B)
        t1 = time.perf_counter()
        spans.append(("request", t0, t1))
        if not np.isfinite(probs).all():
            raise FloatingPointError("non-finite probabilities")
        self.outputs.append(probs)
        return {"pairs": float(self.B), "requests": 1.0,
                "flops": self.flops}

    def counters(self) -> dict:
        return {"requests": len(self.outputs)}

    def release(self) -> None:
        self.model = self.eval_step = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def sample(self) -> list:
        """The requests the check reads: a sample of those the window
        finished, drawn from the seed."""
        n = len(self.outputs)
        rng = tr.rng_for(self.seed, tr.STREAM_SAMPLE)
        k = min(self.t["check_requests"], n)
        return sorted(rng.choice(n, size=k, replace=False).tolist())

    @torch.no_grad()
    def reference(self, mode: str = "fp32", half: bool = False,
                  head: str = "fp32") -> dict:
        """The reference's probabilities of the sampled requests, with the
        noise the program's generator gave each: two draws a request."""
        set_reference_numerics()
        P = make_weights(ref.carel_spec(self.c, self.k), self.seed,
                         self.device)
        ec = self.k["ec_dim"]
        out = {}
        for j in self.sample():
            gen = torch.Generator(device=self.device).manual_seed(
                self.noise_seed)
            for _ in range(2 * j):
                torch.randn(ec, generator=gen, device=self.device)
            lo = (j % self.t["file_requests"]) * self.B
            batch = _carel.to_device(self.rows, lo, lo + self.B, self.device)
            out[j] = ref.pair_probabilities(
                P, self.c, self.k, batch, gen, Numerics(mode, head=head),
                _carel.dtype_of(self.c["precision"]["encoder"])
            ).cpu().numpy()
        return out

    def numbers(self, reference: dict, program: dict = None) -> dict:
        """{prob}: the widest gap between a served probability and the
        reference's."""
        program = program or {j: self.outputs[j] for j in reference}
        return {"prob": max(float(np.max(np.abs(program[j] - reference[j])))
                            for j in reference)}
