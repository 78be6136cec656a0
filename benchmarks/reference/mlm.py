"""Masked-language-model pretraining of the encoder (the BERT recipe of
Devlin et al. 2019) in plain PyTorch, as the configuration's job states
it: per step a batch of corpus rows drawn with replacement, ``mask_prob``
of the content positions chosen, of those 80 % [MASK], 10 % a random
content id, 10 % kept; the encoder without dropout; an untied head (dense
d x d, exact GELU, LayerNorm, dense d x V) in fp32 over every position;
the mean negative log-likelihood over the chosen positions; AdamW with the
learning rate rising linearly from 0 over the warm-up, read at the count
of updates made before the step.

The draws, from one generator on the device, in this order each step:
the batch's row indices, the choice uniforms, the branch uniforms and the
random ids.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from reference.encoder import encode, encoder_spec, part_norms, layer_norm
from reference.numerics import Numerics
from reference.optim import Adam


def mlm_spec(c: dict) -> List[Tuple[str, tuple]]:
    d, V = c["hidden_size"], c["vocab_size"]
    return encoder_spec(c) + [
        ("mlm_transform.weight", (d, d)), ("mlm_transform.bias", (d,)),
        ("mlm_ln.weight", (d,)), ("mlm_ln.bias", (d,)),
        ("mlm_output.weight", (V, d)), ("mlm_output.bias", (V,))]


def lr_at(job: dict, count: int, device) -> float:
    """The warm-up schedule in fp32: lr (1 - (1 - min(count, w) / w)),
    written as optax's linear schedule from 0 forms it."""
    lr, w = job["lr"], job["warmup_steps"]
    c = torch.tensor(float(count), dtype=torch.float32, device=device)
    frac = 1 - torch.clamp(c, 0, w) / w
    return float((0.0 - lr) * frac + lr)


def draws(gen, n_rows: int, B: int, L: int, vocab: int, first_content: int,
          device):
    idx = torch.randint(0, n_rows, (B,), generator=gen, device=device)
    u = torch.rand((B, L), generator=gen, device=device)
    u2 = torch.rand((B, L), generator=gen, device=device)
    rand_ids = torch.randint(first_content, vocab, (B, L), generator=gen,
                             device=device)
    return idx, u, u2, rand_ids


def mlm_loss(P, c, job, corpus_ids, corpus_mask, gen, num: Numerics,
             mask_dtype, half: bool = False):
    B, L = job["batch"], job["seq_len"]
    idx, u, u2, rand_ids = draws(gen, corpus_ids.shape[0], B, L,
                                 c["vocab_size"], job["first_content_id"],
                                 corpus_ids.device)
    ids = corpus_ids[idx].long()
    attn = corpus_mask[idx]
    candidates = (attn > 0) & (ids >= job["first_content_id"])
    chosen = (u < job["mask_prob"]) & candidates
    corrupted = torch.where(chosen & (u2 < 0.8),
                            torch.full_like(ids, job["mask_id"]),
                            torch.where(chosen & (u2 >= 0.8) & (u2 < 0.9),
                                        rand_ids.long(), ids))
    hidden, _ = encode(P, c, corrupted, attn, None, num, mask_dtype, False,
                       pool=False)
    h = F.gelu(num.head_linear(hidden, P["mlm_transform.weight"],
                               P["mlm_transform.bias"]))
    h = layer_norm(h, P["mlm_ln.weight"], P["mlm_ln.bias"], job["head_ln_eps"])
    logits = num.head_linear(h, P["mlm_output.weight"], P["mlm_output.bias"])
    nll = F.cross_entropy(logits.view(B * L, -1), ids.view(-1),
                          reduction="none").view(B, L)
    w = chosen.float()
    if half:
        w[B // 2:] = 0.0
    return (nll * w).sum() / w.sum().clamp(min=1.0)


def train_steps(P: Dict[str, torch.Tensor], c: dict, job: dict, corpus_ids,
                corpus_mask, gen, steps: int, num: Numerics, mask_dtype,
                half: bool = False) -> dict:
    """Run ``steps`` steps in place on ``P``: {losses, grad, change} as in
    ``reference.carel.train_steps``; every leaf is trained and decayed."""
    names = list(P)
    start = {n: P[n].detach().clone() for n in names}
    opt = Adam(P, job["adam_betas"], job["adam_eps"], job["weight_decay"])
    losses, grad = [], {}
    for step in range(steps):
        leaves = {n: P[n].detach().requires_grad_(True) for n in names}
        value = mlm_loss(leaves, c, job, corpus_ids, corpus_mask, gen, num,
                         mask_dtype, half)
        grads = torch.autograd.grad(value, [leaves[n] for n in names],
                                    allow_unused=True)
        g = {n: (torch.zeros_like(P[n]) if gr is None else gr)
             for n, gr in zip(names, grads)}
        if step == 0:
            grad = part_norms((n, g[n]) for n in names)
        losses.append(float(value.detach()))
        opt.step(g, lr_at(job, step, corpus_ids.device))
    change = part_norms((n, P[n] - start[n]) for n in names)
    return {"losses": losses, "grad": grad, "change": change}
