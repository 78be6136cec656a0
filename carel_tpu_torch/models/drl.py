"""DrlModel: the two-latent disentangled VAE pair classifier, port of
carel_tpu/models/drl.py (the reference's DrlClassifier, flagship :149-343).

One module covers the variants. With ``cfg.adapter`` other than none, each
latent reads its own attention adapter over the last hidden state
(``emotion_adapter``, ``cause_adapter``; newsplit :357-376) and the pooled
output is not computed; without one both read the pooled output. The
regularizer-specific sub-networks (GAN
discriminators, CLUB net) are always present, so every checkpoint has one
shape, but the forward never runs them: the gan train step adds the
discriminator outputs (``gan_outputs``) and the vi step the CLUB outputs
(``club_approx_outputs``, then ``club_bound_outputs`` after its club
update), and evaluation and serving run neither. (Under
``jax.jit`` the JAX package computes them on every forward and XLA drops the
unread outputs; run eagerly, they would be launched on every step and every
served batch.) Outputs are raw tensors under the JAX package's keys; the
losses live in carel_tpu_torch.losses. The stop-gradient inputs of the
discriminator and CLUB outputs (``*_sg``) are ``.detach()``-ed latents.

Under a mesh (``self.mesh``, set by ``pipeline.init_state``) the forward is
split at the latent parameters. The ``LOCAL`` modules (the encoder, the
adapters and the four latent projections) run on this rank's rows of the
batch; their outputs are gathered over the mesh's 'data' axis; the rest
(sampling, classifiers, decoder, discriminators, CLUB) runs on the gathered
rows of the global batch, the same on every rank. So every rank computes
the global batch's loss and noise, as one device does. The step sums the
``local_parameters``' gradients over 'data'; the others get the whole
gradient on every rank. A gather passes its input's gradient straight
back, so the backward adds every gradient in the order it does without a
mesh: a mesh of one device gives the bits of no mesh.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
from torch import nn

from carel_tpu_torch.config import AdapterKind, ModelConfig
from carel_tpu_torch.models.deepseek_v2 import DeepseekV2Encoder
from carel_tpu_torch.models.discriminators import ClubNet, LinearDiscriminator
from carel_tpu_torch.models.encoder import TransformerEncoder
from carel_tpu_torch.models.heads import (AttentionAdapter, VaeHeads,
                                          sample_prior)
from carel_tpu_torch.parallel.sharding import gather_rows

# modules run on this rank's rows under a mesh; the rest on gathered rows
LOCAL = ("encoder", "emotion_adapter", "cause_adapter", "heads.emotion_mu",
         "heads.emotion_log_var", "heads.cause_mu", "heads.cause_log_var")


def build_encoder(cfg) -> nn.Module:
    """The encoder of ``cfg.arch``: the DeepSeek-V2 decoder
    (``models/deepseek_v2.py``) for "deepseek_v2", else the BERT/RoBERTa
    ``TransformerEncoder``. Both return (hidden states, pooled)."""
    if cfg.arch == "deepseek_v2":
        return DeepseekV2Encoder(cfg)
    return TransformerEncoder(cfg)


class DrlModel(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        self.encoder = build_encoder(cfg.encoder)
        self.heads = VaeHeads(cfg)
        if cfg.adapter != AdapterKind.NONE:
            d = cfg.encoder.hidden_dim
            self.emotion_adapter = AttentionAdapter(d, cfg.head_number,
                                                    cfg.adapter)
            self.cause_adapter = AttentionAdapter(d, cfg.head_number,
                                                  cfg.adapter)
        # GAN cross adversaries (ec_gan :168-169) and the CLUB net
        # (vi_final :153-161)
        self.ec_disc = LinearDiscriminator(cfg.ec_dim, 1, cfg.dropout)
        self.ce_disc = LinearDiscriminator(cfg.ec_dim, 1, cfg.dropout)
        self.club = ClubNet(cfg.ec_dim)
        self.mesh = None

    def local_parameters(self):
        """The parameters of the ``LOCAL`` modules, which see this rank's
        rows only: their gradients are summed over the mesh's 'data'
        axis."""
        return [p for name, p in self.named_parameters()
                if any(name.startswith(m + ".") for m in LOCAL)]

    def features(self, input_ids, attention_mask, token_type_ids,
                 deterministic: bool = True):
        """Emotion and cause feature vectors from the encoder: both the
        pooled output without adapters (flagship :202-206), each latent's
        own adapter over the last hidden state with them (newsplit
        :357-376); the pooler then does not run."""
        plain = self.cfg.adapter == AdapterKind.NONE
        hidden, pooled = self.encoder(input_ids, attention_mask,
                                      token_type_ids,
                                      deterministic=deterministic,
                                      pool=plain)
        if plain:
            return pooled, pooled
        return (self.emotion_adapter(hidden, attention_mask),
                self.cause_adapter(hidden, attention_mask))

    def forward(
        self,
        input_ids: torch.Tensor,
        attention_mask: torch.Tensor,
        token_type_ids: torch.Tensor,
        deterministic: bool = True,
        sample: bool = True,
        compute_recon: bool = True,
        eps: Optional[Sequence[torch.Tensor]] = None,
        generator: Optional[torch.Generator] = None,
    ) -> Dict[str, torch.Tensor]:
        """``eps`` = (eps_emotion, eps_cause) fixes the sampling noise;
        otherwise it is drawn from ``generator``. compute_recon=False skips
        the decoder product: the fused BoW loss consumes generative_emb and
        the decoder weights directly."""
        cfg = self.cfg
        e_feat, c_feat = self.features(input_ids, attention_mask,
                                       token_type_ids, deterministic)
        e_feat = e_feat.float()
        # without adapters both latents read the one pooled output
        c_feat = e_feat if self.cfg.adapter == AdapterKind.NONE \
            else c_feat.float()
        latents = self.heads.latent_params(e_feat, c_feat)
        if self.mesh is not None:
            # this rank's rows to the global batch's
            latents = [gather_rows(t, self.mesh) for t in latents]
        e_mu, e_lv, c_mu, c_lv = latents

        if sample:
            eps_e, eps_c = eps if eps is not None else (None, None)
            z_e = sample_prior(e_mu, e_lv, cfg.compat_sampling, eps_e,
                               generator)
            z_c = sample_prior(c_mu, c_lv, cfg.compat_sampling, eps_c,
                               generator)
        else:
            z_e, z_c = e_mu, c_mu

        pair_emb = torch.cat([z_e, z_c], dim=-1)
        heads = self.heads
        out = {
            "emotion_mu": e_mu,
            "emotion_log_var": e_lv,
            "cause_mu": c_mu,
            "cause_log_var": c_lv,
            "z_emotion": z_e,
            "z_cause": z_c,
            "generative_emb": pair_emb,
            "emotion_logits": heads.emotion_logits(z_e, deterministic),
            "cause_logits": heads.cause_logits(z_c, deterministic),
            "pair_logits": heads.pair_logits(pair_emb, deterministic),
        }
        if compute_recon:
            out["recon_logits"] = heads.decode(pair_emb)
        return out

    def gan_outputs(self, out: Dict[str, torch.Tensor],
                    deterministic: bool = True) -> Dict[str, torch.Tensor]:
        """The GAN adversaries on the forward's latents: the discriminator
        loss sees detached latents (ec_gan :430-456), the encoder's entropy
        loss the live ones."""
        z_e, z_c = out["z_emotion"], out["z_cause"]
        return {
            "ec_disc_logits_sg": self.ec_disc(z_c.detach(), deterministic),
            "ce_disc_logits_sg": self.ce_disc(z_e.detach(), deterministic),
            "ec_disc_logits": self.ec_disc(z_c, deterministic),
            "ce_disc_logits": self.ce_disc(z_e, deterministic),
        }

    def club_approx_outputs(self, z_c: torch.Tensor
                            ) -> Dict[str, torch.Tensor]:
        """The CLUB net on the detached cause latent, for the approximation
        loss that trains only the club (vi_final :421-426)."""
        mu, lv = self.club(z_c.detach())
        return {"club_mu_sg": mu, "club_lv_sg": lv}

    def club_bound_outputs(self, z_c: torch.Tensor
                           ) -> Dict[str, torch.Tensor]:
        """The CLUB net on the live cause latent, for the upper bound that
        the encoder minimises (vi_final :428-439)."""
        mu, lv = self.club(z_c)
        return {"club_mu": mu, "club_lv": lv}

    def pair_probabilities(self, input_ids, attention_mask, token_type_ids,
                           sample: bool = True,
                           generator: Optional[torch.Generator] = None
                           ) -> torch.Tensor:
        """Eval-time pair probabilities (get_pair_preds, flagship :265-282);
        the reference re-samples the latents at prediction time."""
        out = self(input_ids, attention_mask, token_type_ids,
                   deterministic=True, sample=sample, compute_recon=False,
                   generator=generator)
        return torch.sigmoid(out["pair_logits"][:, 0])
