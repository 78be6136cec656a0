"""The CAREL-VAE pair classifier (the flagship
``drl_classifier_ec_mmd_final_mul_newsplit_emnlp.py`` of tk1363704/CAREL-VAE,
SURVEY.md §2) in plain PyTorch: the encoder's pooled output, four latent
projections (frozen: the reference's optimizer never holds them), one
noise vector shared by the batch with std exp(log_var), the emotion,
cause and pair classifiers behind dropout, and the loss

    -w_mmd MMD(z_e, z_c) + w_emo CE + w_cau BCE_ls + w_pair BCE_ls,pos
    + kl_w (KL_e + KL_c) + BoW

with the unbiased MMD^2 over an RBF kernel on the eps-guarded distance,
the label-smoothed cause BCE, the pair BCE weighted by the batch's
(N - P) / P, the KL of each latent, and the BCE of softmax(decoder(z))
against the smoothed bag of words (p clamped at 1 - 1e-7), each a mean
over the batch's real rows. Adam updates every leaf but the latent
projections.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from reference.encoder import encode, encoder_spec, part_norms
from reference.numerics import Numerics
from reference.optim import Adam

LATENT_HEADS = ("heads.emotion_mu.", "heads.emotion_log_var.",
                "heads.cause_mu.", "heads.cause_log_var.")


def carel_spec(c: dict, k: dict) -> List[Tuple[str, tuple]]:
    d, ec, classes = c["hidden_size"], k["ec_dim"], k["emotion_classes"]
    spec = encoder_spec(c)
    for head in ("emotion_mu", "emotion_log_var", "cause_mu",
                 "cause_log_var"):
        spec += [(f"heads.{head}.weight", (ec, d)),
                 (f"heads.{head}.bias", (ec,))]
    spec += [("heads.emotion_classifier.weight", (classes, ec)),
             ("heads.emotion_classifier.bias", (classes,)),
             ("heads.cause_classifier.weight", (1, ec)),
             ("heads.cause_classifier.bias", (1,)),
             ("heads.pair_classifier.weight", (1, 2 * ec)),
             ("heads.pair_classifier.bias", (1,)),
             ("heads.decoder.weight", (k["bow_vocab"], 2 * ec)),
             ("heads.decoder.bias", (k["bow_vocab"],))]
    return spec


def trainable(names) -> List[str]:
    return [n for n in names if not n.startswith(LATENT_HEADS)]


def kl_weight(i: int, k: dict) -> float:
    """The tanh annealing weight of within-epoch batch ``i`` (flagship
    :515-523), in double."""
    T = float(k["kl_ann_iterations"])
    if not i < T:
        return 1.0
    return (math.tanh((i - 1.5 * T) / (T / 3.0)) + 1.0) * k["kl_lambda"]


def masked_mean(x, mask):
    return (x * mask).sum() / mask.sum().clamp(min=1.0)


def mmd(x, y, mask, alphas, num: Numerics):
    """Unbiased MMD^2 of two equal-size samples over their real rows."""
    B = x.shape[0]
    n = mask.sum()
    z = torch.cat([x, y])
    n2 = (z * z).sum(1, keepdim=True)
    dist = torch.sqrt(1e-5 + torch.abs(n2 + n2.T - 2.0 * num.head_mm(z, z.T)))
    kern = sum(torch.exp(-a * dist ** 2) for a in alphas)
    m2 = torch.cat([mask, mask])
    kern = kern * m2[:, None] * m2[None, :]
    k1, k2, k12 = kern[:B, :B], kern[B:, B:], kern[:B, B:]
    a00 = 1.0 / (n * (n - 1.0))
    a01 = -1.0 / (n * n)
    return (2 * a01 * k12.sum() + a00 * (k1.sum() - torch.trace(k1))
            + a00 * (k2.sum() - torch.trace(k2)))


def bow_loss(h, W, b, idx, wts, ls, mask, num: Numerics):
    V = W.shape[0]
    c, s = ls / V, 1.0 - ls
    z = num.head_linear(h, W, b)
    logp = torch.log_softmax(z, dim=1)
    p = torch.clamp(torch.exp(logp), max=1.0 - 1e-7)
    valid = idx >= 0
    dense = torch.zeros(h.shape[0], V, device=h.device).scatter_add_(
        1, torch.where(valid, idx, 0).long(), torch.where(valid, wts, 0.0))
    t = dense * s + c
    R = torch.sum(-t * logp - (1.0 - t) * torch.log1p(-p), dim=1)
    return (R * mask).sum() / (mask.sum().clamp(min=1.0) * V)


def smoothed_bce(x, y, ls, mask):
    t = y * (1.0 - ls) + ls
    per = torch.clamp(x, min=0.0) - x * t + torch.log1p(torch.exp(-x.abs()))
    return masked_mean(per, mask)


def pair_bce(x, y, ls, mask):
    n, pos = mask.sum(), (y * mask).sum()
    pw = (n - pos) / pos.clamp(min=1.0)
    t = y * (1.0 - ls) + ls
    per = -(pw * t * F.logsigmoid(x) + (1.0 - t) * F.logsigmoid(-x))
    loss = masked_mean(per, mask)
    return torch.where(pos > 0, loss, torch.zeros_like(loss))


def kl(mu, lv, mask):
    return masked_mean(-0.5 * torch.sum(1.0 + lv - lv.exp() - mu ** 2, -1),
                       mask)


def latents(P, c, k, batch, num, mask_dtype, train, gen):
    """(z_e, z_c, e_mu, e_lv, c_mu, c_lv): the sampled latents with the
    one noise vector of each drawn from ``gen``, emotion first."""
    _, pooled = encode(P, c, batch["input_ids"], batch["attention_mask"],
                       batch["token_type_ids"], num, mask_dtype, train)

    def lin(x, name):
        return num.head_linear(x, P[name + ".weight"], P[name + ".bias"])

    e_mu, e_lv = lin(pooled, "heads.emotion_mu"), \
        lin(pooled, "heads.emotion_log_var")
    c_mu, c_lv = lin(pooled, "heads.cause_mu"), \
        lin(pooled, "heads.cause_log_var")
    ec = k["ec_dim"]
    eps_e = torch.randn(ec, generator=gen, device=pooled.device)
    eps_c = torch.randn(ec, generator=gen, device=pooled.device)
    z_e = e_mu + eps_e[None, :] * torch.exp(e_lv)
    z_c = c_mu + eps_c[None, :] * torch.exp(c_lv)
    return z_e, z_c, e_mu, e_lv, c_mu, c_lv


def loss(P, c, k, batch, kl_w, gen, num: Numerics, mask_dtype,
         half: bool = False):
    """The training loss of one batch; with ``half`` the second half of
    the batch is left out of every mean (a fault the check must catch)."""
    z_e, z_c, e_mu, e_lv, c_mu, c_lv = latents(P, c, k, batch, num,
                                               mask_dtype, True, gen)
    mask = batch["example_mask"].float()
    if half:
        mask = mask.clone()
        mask[mask.shape[0] // 2:] = 0.0
    y = batch["pair_labels"].float()
    hp, ls = k["head_dropout"], k["label_smoothing"]

    def lin(x, name):
        return num.head_linear(x, P[name + ".weight"], P[name + ".bias"])

    emo_logits = lin(num.drop(z_e, hp, torch.float32),
                     "heads.emotion_classifier")
    cau_logits = lin(num.drop(z_c, hp, torch.float32),
                     "heads.cause_classifier")
    pair_emb = torch.cat([z_e, z_c], -1)
    pair_logits = lin(num.drop(pair_emb, hp, torch.float32),
                      "heads.pair_classifier")
    logp = torch.log_softmax(emo_logits, -1)
    emo = masked_mean(-logp.gather(1, batch["emotion_labels"].long()[:, None])
                      [:, 0], mask)
    cau = smoothed_bce(cau_logits[:, 0], y, ls, mask)
    pair = pair_bce(pair_logits[:, 0], y, ls, mask)
    recon = bow_loss(pair_emb, P["heads.decoder.weight"],
                     P["heads.decoder.bias"], batch["bow_indices"],
                     batch["bow_weights"].float(), ls, mask, num)
    reg = -k["mmd_weight"] * mmd(z_e, z_c, mask, k["mmd_alphas"], num)
    return (reg + k["emo_weight"] * emo + k["cau_weight"] * cau
            + k["pair_weight"] * pair + kl_w * kl(e_mu, e_lv, mask)
            + kl_w * kl(c_mu, c_lv, mask) + recon)


def train_steps(P: Dict[str, torch.Tensor], c: dict, k: dict,
                batches: list, kl_indices: list, noise_gen, num: Numerics,
                mask_dtype, half: bool = False) -> dict:
    """Run the steps in place on ``P``: {losses, grad (the first step's
    gradient norm of each trainable leaf), change (each trainable leaf's
    norm of its change over the steps)}. The caller seeds the device's
    default generator (dropout) and hands ``noise_gen`` as the program's
    are seeded."""
    names = trainable(P)
    start = {n: P[n].detach().clone() for n in names}
    opt = Adam({n: P[n] for n in names}, k["adam_betas"], k["adam_eps"])
    losses, grad = [], {}
    for step, (batch, i) in enumerate(zip(batches, kl_indices)):
        leaves = {n: P[n].detach().requires_grad_(True) for n in names}
        Q = dict(P, **leaves)
        value = loss(Q, c, k, batch, kl_weight(i, k), noise_gen, num,
                     mask_dtype, half)
        grads = torch.autograd.grad(value, [leaves[n] for n in names])
        g = dict(zip(names, grads))
        if step == 0:
            grad = part_norms((n, g[n]) for n in names)
        losses.append(float(value.detach()))
        opt.step(g, k["lr"])
    change = part_norms((n, P[n] - start[n]) for n in names)
    return {"losses": losses, "grad": grad, "change": change}


@torch.no_grad()
def pair_probabilities(P, c, k, batch, gen, num: Numerics, mask_dtype
                       ) -> torch.Tensor:
    """Evaluation's pair probabilities: no dropout, the latents sampled
    with one noise vector each from ``gen``."""
    z_e, z_c, *_ = latents(P, c, k, batch, num, mask_dtype, False, gen)
    logits = num.head_linear(torch.cat([z_e, z_c], -1),
                             P["heads.pair_classifier.weight"],
                             P["heads.pair_classifier.bias"])
    return torch.sigmoid(logits[:, 0])
