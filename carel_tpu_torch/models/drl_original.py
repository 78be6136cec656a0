"""Original 3-latent DRL model: content + emotion + cause; port of
carel_tpu/models/drl_original.py.

Reproduces drl_classifier.py (:148-335), the port of "Disentangled
Representation Learning for Non-Parallel Text Style Transfer" the reference
forked from: a 384-d content latent beside the two 24-d emotion and cause
latents, five linear adversaries (emotion and cause discs over the content
latent, a BoW content disc over each of the emotion and cause latents, and
the ec/ce cross discs), a multi-label BoW content classifier, the emotion,
cause and pair classifiers, and a decoder over the concatenation of all
three samples.

Every adversary is applied twice: to detached latents (``*_sg``), for the
adversaries' own losses, which must not reach the encoder, and to the live
latents, for the encoder's entropy terms. Each adversary call and each
classifier draws its own dropout mask, as Flax's do. Module names match the
JAX package's, so convert.py maps its params. The three noise draws come
from the sampling generator in the order content, emotion, cause, with
``compat_sampling``'s shared noise vector and std = exp(log_var).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from carel_tpu_torch.config import EncoderConfig
from carel_tpu_torch.models.encoder import TransformerEncoder
from carel_tpu_torch.models.heads import sample_prior

# the six latent projections, which the reference's optimizers never update
LATENT_HEADS = ("content_mu", "content_log_var", "emotion_mu",
                "emotion_log_var", "cause_mu", "cause_log_var")
# the five adversaries (drl_classifier.py:170-176)
ADVERSARIES = ("emotion_disc", "content_disc", "cause_disc", "ec_disc",
               "ce_disc")


@dataclass(frozen=True)
class OriginalModelConfig:
    encoder: EncoderConfig = field(default_factory=EncoderConfig)
    ec_dim: int = 24
    con_dim: int = 384  # drl_classifier.py:34
    ec_num_class: int = 1
    pair_num_class: int = 1
    bow_dim: int = 0
    dropout: float = 0.5
    compat_sampling: bool = True


class DrlOriginalModel(nn.Module):
    def __init__(self, cfg: OriginalModelConfig):
        super().__init__()
        self.cfg = cfg
        d, ec, con = cfg.encoder.hidden_dim, cfg.ec_dim, cfg.con_dim
        self.encoder = TransformerEncoder(cfg.encoder)
        self.content_mu = nn.Linear(d, con)
        self.content_log_var = nn.Linear(d, con)
        self.emotion_mu = nn.Linear(d, ec)
        self.emotion_log_var = nn.Linear(d, ec)
        self.cause_mu = nn.Linear(d, ec)
        self.cause_log_var = nn.Linear(d, ec)
        # adversaries (drl_classifier.py:170-176)
        self.emotion_disc = nn.Linear(con, cfg.ec_num_class)
        self.content_disc = nn.Linear(ec, cfg.bow_dim)
        self.cause_disc = nn.Linear(con, cfg.ec_num_class)
        self.ec_disc = nn.Linear(ec, cfg.ec_num_class)
        self.ce_disc = nn.Linear(ec, cfg.ec_num_class)
        # classifiers + decoder (:177-184)
        self.content_classifier = nn.Linear(con, cfg.bow_dim)
        self.emotion_classifier = nn.Linear(ec, cfg.ec_num_class)
        self.cause_classifier = nn.Linear(ec, cfg.ec_num_class)
        self.pair_classifier = nn.Linear(2 * ec, cfg.pair_num_class)
        self.decoder = nn.Linear(2 * ec + con, cfg.bow_dim)

    def latents(self, input_ids, attention_mask, token_type_ids,
                deterministic: bool = True, sample: bool = True,
                eps: Optional[Sequence[torch.Tensor]] = None,
                generator: Optional[torch.Generator] = None
                ) -> Dict[str, torch.Tensor]:
        """The three latents' mu, log_var and samples. ``eps`` =
        (eps_content, eps_emotion, eps_cause) fixes the noise; otherwise it
        is drawn from ``generator`` in that order."""
        cfg = self.cfg
        _, pooled = self.encoder(input_ids, attention_mask, token_type_ids,
                                 deterministic=deterministic)
        pooled = pooled.float()
        out = {"content_mu": self.content_mu(pooled),
               "content_log_var": self.content_log_var(pooled),
               "emotion_mu": self.emotion_mu(pooled),
               "emotion_log_var": self.emotion_log_var(pooled),
               "cause_mu": self.cause_mu(pooled),
               "cause_log_var": self.cause_log_var(pooled)}
        for i, name in enumerate(("content", "emotion", "cause")):
            mu, lv = out[f"{name}_mu"], out[f"{name}_log_var"]
            out[f"z_{name}"] = sample_prior(
                mu, lv, cfg.compat_sampling,
                None if eps is None else eps[i], generator) if sample else mu
        return out

    def forward(self, input_ids, attention_mask, token_type_ids,
                deterministic: bool = True, sample: bool = True,
                eps: Optional[Sequence[torch.Tensor]] = None,
                generator: Optional[torch.Generator] = None
                ) -> Dict[str, torch.Tensor]:
        """Every output of the JAX model, under its keys."""
        out = self.latents(input_ids, attention_mask, token_type_ids,
                           deterministic, sample, eps, generator)
        z_con, z_e, z_c = out["z_content"], out["z_emotion"], out["z_cause"]
        p = 0.0 if deterministic else self.cfg.dropout

        def drop(x):
            return F.dropout(x, p, training=p > 0.0)

        sg = torch.Tensor.detach
        out.update({
            # disc losses see detached latents (:352-364 pattern)
            "content_disc_emo_sg": self.content_disc(drop(sg(z_e))),
            "content_disc_cau_sg": self.content_disc(drop(sg(z_c))),
            "emotion_disc_sg": self.emotion_disc(drop(sg(z_con))),
            "cause_disc_sg": self.cause_disc(drop(sg(z_con))),
            "ec_disc_sg": self.ec_disc(drop(sg(z_c))),
            "ce_disc_sg": self.ce_disc(drop(sg(z_e))),
            # live outputs for the encoder's entropy terms
            "content_disc_emo": self.content_disc(drop(z_e)),
            "content_disc_cau": self.content_disc(drop(z_c)),
            "emotion_disc": self.emotion_disc(drop(z_con)),
            "cause_disc": self.cause_disc(drop(z_con)),
            "ec_disc": self.ec_disc(drop(z_c)),
            "ce_disc": self.ce_disc(drop(z_e)),
            # classifiers
            "content_logits": self.content_classifier(drop(z_con)),
            "emotion_logits": self.emotion_classifier(drop(z_e)),
            "cause_logits": self.cause_classifier(drop(z_c)),
            "pair_logits": self.pair_classifier(
                drop(torch.cat([z_e, z_c], dim=-1))),
            "recon_logits": self.decoder(torch.cat([z_e, z_c, z_con],
                                                   dim=-1)),
        })
        return out

    def pair_probabilities(self, input_ids, attention_mask, token_type_ids,
                           sample: bool = True,
                           generator: Optional[torch.Generator] = None
                           ) -> torch.Tensor:
        """Eval-time pair probabilities with re-sampled latents (the three
        draws, as JAX's), without the adversaries, the BoW heads and the
        decoder, whose outputs evaluation does not read (XLA drops them in
        the JAX package)."""
        out = self.latents(input_ids, attention_mask, token_type_ids,
                           deterministic=True, sample=sample,
                           generator=generator)
        logits = self.pair_classifier(torch.cat([out["z_emotion"],
                                                 out["z_cause"]], dim=-1))
        return torch.sigmoid(logits[:, 0])
