"""Train and eval steps, port of carel_tpu/train/steps.py.

One train step per regularizer, as in JAX:

- none/mmd/hsic: one gradient of the weighted multi-task loss, the main
  Adam steps (flagship forward :184-263, train :820-845);
- gan: one gradient of vae_loss + ec_disc_bce + ce_disc_bce; the disc BCEs
  see detached latents and the entropy term's gradient reaches the
  discriminators through the live ones, so the main Adam and the disc
  RMSprop step from the same gradients (ec_gan :775-804);
- vi: phase 1 steps the CLUB net's Adam from the approximation NLL on
  detached latents; phase 2 adds vi_beta * upper bound, computed with the
  UPDATED club params, to the main loss and steps the main Adam only; its
  club gradients are dropped (vi_final :760-781). JAX runs the encoder
  forward twice with one rng, hence the same noise and params; one forward
  feeding both phases computes the same function.

One body serves the eager step (``make_train_step``) and the step that
train/scan_epoch.py captures in a CUDA graph: it takes the KL-annealing
weight and vi_beta as 0-d device tensors, draws its noise and the vi
permutation from ``state.generator`` and reads no value back to the host.
The eager step computes the weight on the host in double and hands both in.

The BoW reconstruction term is always the fused loss (kernels K3/K4 on
CUDA, the plain version on the CPU), so the model never computes the
[B, V] decoder logits in training; the MMD term goes through kernels K1/K2
and the HSIC term through K5/K6 on CUDA.

Under a mesh (``model.mesh``) the batch holds this rank's rows. The model
gathers its latents over the mesh's 'data' axis (models/drl.py), the body
gathers the batch's loss inputs, and every rank computes the loss of the
global batch: the pair BCE's batch pos_weight, MMD, HSIC, the CLUB
permutation, the discriminators and every masked mean see all its rows, as
on one device. The vi permutation is drawn over the global batch from the
generator every rank holds alike. After the backward the gradients of the
model's ``local_parameters`` (the modules that saw this rank's rows only)
are summed over 'data'; the rest (classifiers, decoder, discriminators,
CLUB) ran on the gathered rows and hold the whole gradient on every rank.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from carel_tpu_torch.config import CarelConfig, Regularizer
from carel_tpu_torch.losses.classify import (
    binary_smoothed_bce,
    cause_bce_loss,
    emotion_ce_loss,
    pair_bce_pos_weighted,
)
from carel_tpu_torch.losses.registry import (
    club_aprx_loss,
    gan_disc_losses,
    regularizer_loss,
)
from carel_tpu_torch.losses.vae import annealed_kl_weight, kl_loss
from carel_tpu_torch.ops.cuda_bow import fused_bow_loss
from carel_tpu_torch.parallel.sharding import all_reduce_grads, gather_batch
from carel_tpu_torch.train.state import TrainState

# the batch arrays the loss reads, gathered over a mesh's 'data' axis
LOSS_INPUTS = ("pair_labels", "emotion_labels", "bow_indices", "bow_weights",
               "example_mask")


def batch_to_device(batch: Dict[str, np.ndarray],
                    device: torch.device) -> Dict[str, torch.Tensor]:
    """numpy batch (``Batch.as_dict()``) -> tensors on ``device``."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in batch.items()}


def vae_and_classifier_loss(
    cfg: CarelConfig,
    out: Dict[str, torch.Tensor],
    batch: Dict[str, torch.Tensor],
    kl_weight,
    decoder: torch.nn.Linear,
    vi_beta=None,
    perm: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The weighted multi-task loss (flagship :208-261); the reconstruction
    term is the fused BoW loss from the generative embedding and the
    decoder's weights. ``kl_weight`` is the annealing weight of this batch
    (``annealed_kl_weight`` of its within-epoch index), a float or a 0-d
    tensor; ``vi_beta`` (likewise) and ``perm`` feed the vi term."""
    lc = cfg.loss
    mask = batch["example_mask"]
    pair_labels = batch["pair_labels"]

    if cfg.model.binary_emotion:
        emo = binary_smoothed_bce(out["emotion_logits"],
                                  torch.ones_like(pair_labels),
                                  lc.label_smoothing, 1, mask)
    else:
        emo = emotion_ce_loss(out["emotion_logits"], batch["emotion_labels"],
                              mask)
    cau = cause_bce_loss(out["cause_logits"], pair_labels, lc.label_smoothing,
                         mask)
    pair = pair_bce_pos_weighted(out["pair_logits"], pair_labels,
                                 lc.label_smoothing, mask)

    kl_e = kl_weight * kl_loss(out["emotion_mu"], out["emotion_log_var"],
                               mask)
    kl_c = kl_weight * kl_loss(out["cause_mu"], out["cause_log_var"], mask)

    recon = fused_bow_loss(out["generative_emb"], decoder.weight,
                           decoder.bias, batch["bow_indices"],
                           batch["bow_weights"], lc.label_smoothing, mask)
    reg = regularizer_loss(out, lc, mask, vi_beta=vi_beta, perm=perm)

    # gan and hsic: the cause term takes the EMOTION weight (ec_gan
    # :275-279, ec_hsic :249-253)
    cau_weight = (lc.emo_mul_loss_weight
                  if lc.regularizer in (Regularizer.GAN, Regularizer.HSIC)
                  else lc.cau_mul_loss_weight)
    total = (reg
             + lc.emo_mul_loss_weight * emo
             + cau_weight * cau
             + lc.pair_mul_loss_weight * pair
             + kl_e + kl_c + recon)
    metrics = {
        "loss": total,
        "emo_loss": emo,
        "cau_loss": cau,
        "pair_loss": pair,
        "kl_emotion": kl_e,
        "kl_cause": kl_c,
        "recon_loss": recon,
        "reg_loss": reg,
    }
    return total, metrics


def make_step_body(cfg: CarelConfig) -> Callable:
    """The train step body for this config's regularizer:
    ``body(state, batch, kl_weight, vi_beta, eps=None, perm=None) ->
    metrics`` (0-d tensors, not synchronized). ``kl_weight`` and ``vi_beta``
    are 0-d float32 tensors on the batch's device; ``vi_beta`` weighs the vi
    upper bound, which the other regularizers ignore. ``eps`` =
    (eps_emotion, eps_cause) fixes the sampling noise and ``perm`` (a
    permutation of the B rows) the vi negatives; otherwise both come from
    ``state.generator``. Every parameter's ``.grad`` is cleared first, and
    the club's is cleared after the vi step, so no group carries a stale
    gradient to the next step. Nothing here reads a value back to the host,
    so the body captures in a CUDA graph."""
    reg = cfg.loss.regularizer

    def body(state: TrainState, batch: Dict[str, torch.Tensor],
             kl_weight: torch.Tensor, vi_beta: torch.Tensor,
             eps: Optional[Sequence[torch.Tensor]] = None,
             perm: Optional[torch.Tensor] = None) -> Dict:
        model = state.model
        mesh = model.mesh
        model.zero_grad(set_to_none=True)
        out = model(batch["input_ids"], batch["attention_mask"],
                    batch["token_type_ids"], deterministic=False,
                    sample=True, compute_recon=False, eps=eps,
                    generator=state.generator)
        if mesh is not None:
            batch = gather_batch(mesh, {k: batch[k] for k in LOSS_INPUTS})
        mask = batch["example_mask"]
        if reg == Regularizer.VI:
            # phase 1: the club's Adam from the approximation NLL, whose
            # inputs are detached, so only the club gets gradient
            out.update(model.club_approx_outputs(out["z_cause"]))
            club_aprx_loss(out, mask).backward()
            state.club_optimizer.step()
            # phase 2 reads the club only after its update
            out.update(model.club_bound_outputs(out["z_cause"]))
            if perm is None:
                perm = torch.randperm(mask.shape[0], device=mask.device,
                                      generator=state.generator)
        elif reg == Regularizer.GAN:
            out.update(model.gan_outputs(out, deterministic=False))
        total, metrics = vae_and_classifier_loss(
            cfg, out, batch, kl_weight, model.heads.decoder,
            vi_beta=vi_beta, perm=perm)
        if reg == Regularizer.GAN:
            # metrics["loss"] stays the main loss, as in JAX
            ec, ce = gan_disc_losses(out, cfg.loss,
                                     torch.ones_like(batch["pair_labels"]),
                                     batch["pair_labels"], mask)
            metrics["ec_disc_loss"] = ec
            metrics["ce_disc_loss"] = ce
            total = total + ec + ce
        total.backward()
        if mesh is not None:
            all_reduce_grads(model.local_parameters(), mesh)
        state.optimizer.step()
        if reg == Regularizer.GAN:
            state.disc_optimizer.step()
        elif reg == Regularizer.VI:
            state.club_optimizer.zero_grad(set_to_none=True)
        state.step += 1
        return {k: v.detach() for k, v in metrics.items()}

    return body


def scalar(value: float, device: torch.device) -> torch.Tensor:
    """``value`` rounded to float32, as a 0-d tensor on ``device`` (a fill,
    no host-to-device copy)."""
    return torch.full((), value, dtype=torch.float32, device=device)


def make_train_step(cfg: CarelConfig) -> Callable:
    """The eager train step:
    ``step(state, batch, iteration, vi_beta=0.0, eps=None, perm=None) ->
    metrics``. ``iteration`` is the within-epoch batch index, whose
    annealing weight is computed here in double; see ``make_step_body`` for
    the rest."""
    body = make_step_body(cfg)
    lc = cfg.loss

    def step(state: TrainState, batch: Dict[str, torch.Tensor],
             iteration: int, vi_beta: float = 0.0,
             eps: Optional[Sequence[torch.Tensor]] = None,
             perm: Optional[torch.Tensor] = None) -> Dict:
        device = batch["example_mask"].device
        weight = annealed_kl_weight(iteration, lc.kl_ann_iterations,
                                    lc.ec_kl_lambda)
        return body(state, batch, scalar(weight, device),
                    scalar(vi_beta, device), eps, perm)

    return step


def make_eval_step(sample: bool = True) -> Callable:
    """Batched eval: pair probabilities (get_pair_preds, flagship :265-282).
    The reference re-samples the latents at eval; ``sample`` keeps that, with
    the noise drawn from the generator passed in."""

    @torch.no_grad()
    def step(model, batch: Dict[str, torch.Tensor],
             generator: torch.Generator) -> torch.Tensor:
        return model.pair_probabilities(
            batch["input_ids"], batch["attention_mask"],
            batch["token_type_ids"], sample=sample,
            generator=generator).float()

    return step
