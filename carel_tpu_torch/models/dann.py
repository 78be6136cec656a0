"""Clause-level emotion classifier with DANN domain adaptation, port of
carel_tpu/models/dann.py.

Reproduces emotion_classifier.py (:112-174): encoder pooler -> linear
768->32 -> relu -> dropout -> batch norm (the feature extractor), a
32->32->7 recognizer, and a gradient-reversal domain head 32->32->2.
Training pairs the emotion CE on labeled clauses with the adversarial
domain CE on clauses of both domains; class imbalance is handled by drawing
the labeled half with inverse-frequency probabilities (the reference's
ImbalancedDatasetSampler, :273, :499).

The batch norm is Flax's ``nn.BatchNorm`` written out (``FlaxBatchNorm``):
it normalises with the batch's biased variance (E[x^2] - E[x]^2, clipped at
0), eps 1e-5, and updates its running mean and variance as
``0.99 * running + 0.01 * batch`` with that same biased variance.
``torch.nn.BatchNorm1d`` would update with the unbiased variance and reads
its momentum as 1 - 0.99.

The model's params and running statistics live in the module; the JAX
functions' (params, batch_stats, opt_state) triples become the module and a
torch Adam that the caller passes back in to continue training.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from carel_tpu_torch.config import EncoderConfig
from carel_tpu_torch.models.discriminators import grad_reverse
from carel_tpu_torch.models.encoder import TransformerEncoder, init_flax_


class FlaxBatchNorm(nn.Module):
    def __init__(self, features: int, momentum: float = 0.99,
                 eps: float = 1e-5):
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor,
                use_running_average: bool = True) -> torch.Tensor:
        if use_running_average:
            mean, var = self.running_mean, self.running_var
        else:
            mean = x.mean(0)
            var = torch.clamp((x * x).mean(0) - mean * mean, min=0.0)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.copy_(m * self.running_mean
                                        + (1.0 - m) * mean)
                self.running_var.copy_(m * self.running_var
                                       + (1.0 - m) * var)
        return (x - mean) * (torch.rsqrt(var + self.eps) * self.weight) \
            + self.bias


class ClauseEmotionDANN(nn.Module):
    def __init__(self, encoder_cfg: EncoderConfig, feature_dim: int = 32,
                 hidden_dim: int = 32, n_class: int = 7,
                 dropout: float = 0.1, domain_weight: float = 1.0):
        super().__init__()
        self.dropout = dropout
        self.domain_weight = domain_weight  # GRL lambda
        self.encoder = TransformerEncoder(encoder_cfg)
        self.linear_l = nn.Linear(encoder_cfg.hidden_dim, feature_dim)
        self.batchnorm_l = FlaxBatchNorm(feature_dim)
        self.linear_1 = nn.Linear(feature_dim, hidden_dim)
        self.linear_2 = nn.Linear(hidden_dim, n_class)
        self.dom_linear_1 = nn.Linear(feature_dim, hidden_dim)
        self.dom_linear_2 = nn.Linear(hidden_dim, 2)

    def forward(self, input_ids, attention_mask, token_type_ids,
                deterministic: bool = True,
                use_running_average: bool = True):
        """(emotion logits [B, n_class], domain logits [B, 2])."""
        _, pooled = self.encoder(input_ids, attention_mask, token_type_ids,
                                 deterministic=deterministic)
        x = F.relu(self.linear_l(pooled.float()))
        x = F.dropout(x, self.dropout, training=not deterministic)
        feat = self.batchnorm_l(x, use_running_average)
        emotion_logits = self.linear_2(F.relu(self.linear_1(feat)))
        d = grad_reverse(feat, self.domain_weight)
        domain_logits = self.dom_linear_2(F.relu(self.dom_linear_1(d)))
        return emotion_logits, domain_logits


def imbalanced_sample_weights(labels: np.ndarray) -> np.ndarray:
    """Inverse-class-frequency weights (torchsampler.ImbalancedDatasetSampler
    semantics): drawing with these probabilities oversamples rare classes."""
    labels = np.asarray(labels)
    counts = np.bincount(labels, minlength=int(labels.max()) + 1)
    w = 1.0 / np.maximum(counts[labels], 1)
    return w / w.sum()


def init_dann(model: ClauseEmotionDANN, seed: int = 42) -> None:
    """Flax's initialisers from a CPU generator seeded with ``seed``; the
    batch norm starts at scale 1, bias 0, mean 0 and variance 1."""
    init_flax_(model, torch.Generator().manual_seed(seed))


def _device(model: nn.Module) -> torch.device:
    return next(model.parameters()).device


def _rows(data: dict, idx, device) -> tuple:
    return tuple(torch.from_numpy(np.asarray(data[k])[idx]).to(device)
                 for k in ("input_ids", "attention_mask", "token_type_ids"))


@torch.no_grad()
def predict_dann(model: ClauseEmotionDANN, data: dict,
                 batch_size: int = 256) -> np.ndarray:
    """Emotion softmax probabilities [N, n_class] over a clause set, with
    the running statistics and no dropout."""
    device = _device(model)
    n = len(data["input_ids"])
    out = []
    for s in range(0, n, batch_size):
        emo, _ = model(*_rows(data, np.arange(s, min(s + batch_size, n)),
                              device),
                       deterministic=True, use_running_average=True)
        out.append(torch.softmax(emo.float(), -1).cpu().numpy())
    return np.concatenate(out, 0)


def dann_losses(
    emotion_logits: torch.Tensor,
    domain_logits: torch.Tensor,
    emotion_labels: torch.Tensor,  # [B] int; -1 = unlabeled
    domain_labels: torch.Tensor,  # [B] int 0=source 1=target
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(emotion CE over labeled rows, domain CE over all rows)."""
    labeled = (emotion_labels >= 0).float()
    safe = torch.clamp(emotion_labels, min=0).long()
    logp = torch.log_softmax(emotion_logits.float(), -1)
    emo_nll = -torch.gather(logp, 1, safe[:, None])[:, 0]
    emo_loss = torch.sum(emo_nll * labeled) / torch.clamp(
        torch.sum(labeled), min=1.0)
    dlogp = torch.log_softmax(domain_logits.float(), -1)
    dom_nll = -torch.gather(dlogp, 1, domain_labels.long()[:, None])[:, 0]
    return emo_loss, torch.mean(dom_nll)


def train_dann(
    model: ClauseEmotionDANN,
    labeled: dict,  # {"input_ids","attention_mask","token_type_ids","labels"}
    unlabeled: dict,  # same keys; labels ignored (other domain, unlabeled)
    epochs: int = 5,
    batch_size: int = 32,
    learning_rate: float = 2e-5,
    seed: int = 42,
    logger=None,
    optimizer: Optional[torch.optim.Optimizer] = None,
    labeled_domain: int = 0,  # domain id of the labeled half (0=src, 1=tgt)
    use_domain_loss: bool = True,
    eval_fn=None,  # called with (model, epoch) after each epoch
    losses: Optional[list] = None,
) -> torch.optim.Optimizer:
    """Adversarial domain-adaptation loop (emotion_classifier.py:448-553):
    each batch is half labeled clauses drawn with inverse-frequency
    probabilities (emotion CE) and half clauses of the other domain (domain
    CE through the gradient reversal), drawn by numpy calls that match the
    JAX package's one for one.

    use_domain_loss=False reproduces the reference's SHIPPED recipe (its
    train_model has the discriminator path commented out,
    emotion_classifier.py:279-288, 330-347); True trains the full DANN
    objective. Trains ``model`` in place and returns its Adam; pass it back
    as ``optimizer`` to continue (the reference reuses one Adam across the
    base run and all self-training iterations, :500, :527-534).
    ``losses``, when given, receives (emotion, domain) loss pairs of every
    step (device tensors)."""
    device = _device(model)
    if optimizer is None:
        optimizer = torch.optim.Adam(model.parameters(), lr=learning_rate,
                                     eps=1e-8, fused=device.type == "cuda")
    params = list(model.parameters())
    n_lab = len(labeled["labels"])
    n_unl = len(unlabeled["input_ids"])
    lab_y = np.asarray(labeled["labels"])
    lab_w = imbalanced_sample_weights(lab_y)
    data_rng = np.random.default_rng(seed)
    half = batch_size // 2
    steps_per_epoch = max(n_lab // half, 1)
    dom_y = torch.tensor([labeled_domain] * half
                         + [1 - labeled_domain] * (batch_size - half),
                         device=device)
    for epoch in range(epochs):
        for _ in range(steps_per_epoch):
            si = data_rng.choice(n_lab, half, p=lab_w)
            ti = data_rng.choice(n_unl, batch_size - half)
            rows = [torch.cat([a, c]) for a, c in zip(
                _rows(labeled, si, device), _rows(unlabeled, ti, device))]
            emo_y = torch.from_numpy(np.concatenate([
                lab_y[si].astype(np.int64),
                np.full(batch_size - half, -1, np.int64)])).to(device)
            for p in params:
                p.grad = None
            emo, dom = model(*rows, deterministic=False,
                             use_running_average=False)
            e_loss, d_loss = dann_losses(emo, dom, emo_y, dom_y)
            (e_loss + d_loss if use_domain_loss else e_loss).backward()
            optimizer.step()
            if losses is not None:
                losses.append((e_loss.detach(), d_loss.detach()))
        if logger:
            logger.log({"event": "dann_epoch", "epoch": epoch + 1,
                        "emo_loss": float(e_loss.detach()),
                        "dom_loss": float(d_loss.detach())})
        if eval_fn is not None:
            eval_fn(model, epoch + 1)
    return optimizer
