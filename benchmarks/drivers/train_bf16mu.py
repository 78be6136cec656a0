"""``drivers/train.py`` with the first moment of the main Adam stored in
bfloat16, as ``train --optim_mu_dtype bfloat16`` trains (``MuDtypeAdam``,
whose foreach update replaces the fused Adam), against the reference's
Adam with the same moment (``reference/optim_mu.py``). The traffic is
train.py's: this driver alone sets the moment's dtype."""

from __future__ import annotations

import dataclasses

import torch

from drivers import _carel
from drivers.train import Driver as TrainDriver
from harness.weights import make_weights
from reference import carel as ref
from reference import optim_mu
from reference.numerics import Numerics, set_reference_numerics


# the main Adam's first moment, as the train verb's --optim_mu_dtype takes it
MU_DTYPE = "bfloat16"


class Driver(TrainDriver):
    def __init__(self, c: dict, t: dict, seed: int, device):
        super().__init__(c, t, seed, device)
        self.pcfg = dataclasses.replace(self.pcfg, train=dataclasses.replace(
            self.pcfg.train, optim_mu_dtype=MU_DTYPE))

    def reference(self, mode: str = "fp32", half: bool = False,
                  head: str = "fp32") -> dict:
        set_reference_numerics()
        P = make_weights(ref.carel_spec(self.c, self.k), self.seed,
                         self.device)
        torch.manual_seed(self.dropout_seed)
        noise = torch.Generator(device=self.device).manual_seed(
            self.noise_seed)
        B = self.B
        batches = [_carel.to_device(self.check, i * B, (i + 1) * B,
                                    self.device) for i in range(3)]
        return optim_mu.train_steps(
            P, self.c, self.k, batches, [0, 0, 1], noise,
            Numerics(mode, head=head),
            _carel.dtype_of(self.c["precision"]["encoder"]), half)
