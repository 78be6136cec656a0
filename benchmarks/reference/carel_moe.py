"""The CAREL-VAE pair classifier (``reference/carel.py``'s loss pieces) over
the DeepSeek-V2 encoder of ``reference/deepseek_v2.py``, and its training
steps computed in blocks of rows so that a 1.6 B-parameter step fits on the
card in fp32.

A step (``train_steps``), exact up to the order of fp32 sums:

1. the pooled features of all rows, block by block, without a graph;
2. the heads' loss over the whole batch (its MMD couples the rows), and its
   gradient with respect to the heads' leaves and to the features;
3. block by block, the encoder's forward again and its backward from that
   block's feature gradient, summed into the encoder's leaves;

then Adam over every trainable leaf. The loss is ``reference/carel.py``'s
``loss`` with the pooled output of this encoder in place of BERT's: the
same noise draws (emotion, then cause, from the noise generator) and head
dropout masks (``Numerics.drop``, the program's shapes and order).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch

from reference import carel as ref
from reference import deepseek_v2 as dsv2
from reference.encoder import part_norms
from reference.numerics import Numerics
from reference.optim import Adam


def carel_spec(c: dict, k: dict, held: Tuple[int, int]
               ) -> List[Tuple[str, tuple]]:
    """(name, shape) of the encoder's tensors and the CAREL heads'."""
    d, ec, classes = c["hidden_size"], k["ec_dim"], k["emotion_classes"]
    spec = dsv2.encoder_spec(c, held)
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


def heads_loss(P, k: dict, pooled, batch, kl_w: float, gen,
               num: Numerics, half: bool = False):
    """``reference/carel.py``'s ``loss`` from the encoder's pooled output."""
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
    mask = batch["example_mask"].float()
    if half:
        mask = mask.clone()
        mask[mask.shape[0] // 2:] = 0.0
    y = batch["pair_labels"].float()
    hp, ls = k["head_dropout"], k["label_smoothing"]
    emo_logits = lin(num.drop(z_e, hp, torch.float32),
                     "heads.emotion_classifier")
    cau_logits = lin(num.drop(z_c, hp, torch.float32),
                     "heads.cause_classifier")
    pair_emb = torch.cat([z_e, z_c], -1)
    pair_logits = lin(num.drop(pair_emb, hp, torch.float32),
                      "heads.pair_classifier")
    logp = torch.log_softmax(emo_logits, -1)
    emo = ref.masked_mean(-logp.gather(
        1, batch["emotion_labels"].long()[:, None])[:, 0], mask)
    cau = ref.smoothed_bce(cau_logits[:, 0], y, ls, mask)
    pair = ref.pair_bce(pair_logits[:, 0], y, ls, mask)
    recon = ref.bow_loss(pair_emb, P["heads.decoder.weight"],
                         P["heads.decoder.bias"], batch["bow_indices"],
                         batch["bow_weights"].float(), ls, mask, num)
    reg = -k["mmd_weight"] * ref.mmd(z_e, z_c, mask, k["mmd_alphas"], num)
    return (reg + k["emo_weight"] * emo + k["cau_weight"] * cau
            + k["pair_weight"] * pair + kl_w * ref.kl(e_mu, e_lv, mask)
            + kl_w * ref.kl(c_mu, c_lv, mask) + recon)


def _blocks(B: int, rows: int):
    return [(lo, min(B, lo + rows)) for lo in range(0, B, rows)]


def train_steps(P: Dict[str, torch.Tensor], c: dict, k: dict,
                held: Tuple[int, int], batches: list, kl_indices: list,
                noise_gen, num: Numerics, half: bool = False,
                block_rows: int = 16, routes: Optional[list] = None,
                force: Optional[list] = None,
                freeze_router: bool = False) -> dict:
    """Run the steps in place on ``P``: {losses, grad (the first step's
    gradient norm of each trainable leaf), change (each trainable leaf's
    norm of its change)}. ``routes`` gets, for each step, the top-k ids of
    each mixture layer's own gate ([rows x L, k] a layer); ``force`` (one
    such list a step) imposes the experts a step's layers compute. The
    caller seeds the device's default generator (dropout) and hands
    ``noise_gen`` as the program's are seeded. ``freeze_router`` leaves
    the gates out of training."""
    names = [n for n in ref.trainable(P)
             if not (freeze_router and n.endswith("mlp.gate"))]
    start = {n: P[n].detach().clone() for n in names}
    opt = Adam({n: P[n] for n in names}, k["adam_betas"], k["adam_eps"])
    encoder = [n for n in names if n.startswith("encoder.")]
    heads = [n for n in names if not n.startswith("encoder.")]
    losses, grad = [], {}
    for step, (batch, i) in enumerate(zip(batches, kl_indices)):
        ids, mask = batch["input_ids"], batch["attention_mask"]
        B = ids.shape[0]
        blocks = _blocks(B, block_rows)
        tied = force[step] if force is not None else None

        def per_block(lo, hi):
            # the forced routes of rows lo..hi, a mixture layer each
            if tied is None:
                return None
            L = ids.shape[1]
            return [r[lo * L:hi * L] for r in tied]

        parts, seen = [], []
        with torch.no_grad():
            for lo, hi in blocks:
                seen.append([])
                parts.append(dsv2.encode(P, c, ids[lo:hi], mask[lo:hi], held,
                                         num, seen[-1], per_block(lo, hi))[1])
        if routes is not None:
            routes.append([torch.cat(r) for r in zip(*seen)])
        feats = torch.cat(parts).requires_grad_(True)
        leaves = {n: P[n].detach().requires_grad_(True) for n in names}
        Q = dict(P, **leaves)
        value = heads_loss(Q, k, feats, batch, ref.kl_weight(i, k),
                           noise_gen, num, half)
        got = torch.autograd.grad(value, [leaves[n] for n in heads]
                                  + [feats])
        g = dict(zip(heads, got[:-1]))
        dfeat = got[-1]
        for n in encoder:
            leaves[n].grad = None
        for lo, hi in blocks:
            _, pooled = dsv2.encode(Q, c, ids[lo:hi], mask[lo:hi], held, num,
                                    None, per_block(lo, hi))
            pooled.backward(dfeat[lo:hi])
        for n in encoder:
            g[n] = leaves[n].grad if leaves[n].grad is not None \
                else torch.zeros_like(P[n])
        if step == 0:
            grad = part_norms((n, g[n]) for n in names)
        losses.append(float(value.detach()))
        opt.step(g, k["lr"])
        del leaves, Q, g, got
    change = part_norms((n, P[n] - start[n]) for n in names)
    return {"losses": losses, "grad": grad, "change": change}


def flip_share(program: List[list], reference: List[list],
               masks: List[torch.Tensor]) -> float:
    """The share of (real token, mixture layer, step) whose set of top-k
    experts differs between two routings (a list of [tokens, k] a layer,
    a step; ``masks`` the steps' attention masks)."""
    differ = total = 0
    for p_step, r_step, mask in zip(program, reference, masks):
        d, t = _differ(p_step, r_step, mask.reshape(-1).bool().cpu())
        differ, total = differ + d, total + t
    return differ / total if total else math.nan


def _differ(program, reference, real):
    differ = total = 0
    for a, b in zip(program, reference):
        a = a.cpu().sort(-1).values[real]
        b = b.cpu().sort(-1).values[real]
        differ += int((a != b).any(-1).sum())
        total += a.shape[0]
    return differ, total
