"""Central configuration, the port's own copy of carel_tpu/config.py.

The reference implements every ablation as a separate file fork (~20 trainer
files differing by a few lines, see SURVEY.md §2.2). Here the full experimental
matrix is a single dataclass tree; each reference file maps to a named preset in
``PRESETS`` (drl_classifier_ec_mmd_final_mul.py:30-58 for the flagship flag set,
drl_classifier_ec_mmd_final_mul_newsplit_emnlp.py:30-70 for the newsplit extras).

The dataclasses and presets are kept field for field with the JAX package so a
preset means the same run in both. The port reads scan_epoch (a captured
CUDA-graph step replayed over the stacked epoch, train/scan_epoch.py),
save_state_every, profile_dir, debug_nans, optim_mu_dtype, num_devices and
mesh_shape (the ``train`` verb; the mesh of parallel/). Fields that only
the JAX package reads (remat, rng_impl, donate) are carried but ignored
here.
"""

from __future__ import annotations

import dataclasses
import enum
from dataclasses import dataclass, field
from typing import Optional


class Regularizer(str, enum.Enum):
    """Disentanglement term between the emotion and cause latents.

    Mirrors the drl_classifier_ec_* family of the reference:
    none (ec_none), mmd (ec_mmd_final_mul), hsic (ec_hsic), gan (ec_gan),
    vi (ec_vi_final, a CLUB-style variational upper bound).
    """

    NONE = "none"
    MMD = "mmd"
    HSIC = "hsic"
    GAN = "gan"
    VI = "vi"


class AdapterKind(str, enum.Enum):
    """Attention adapter over the encoder's last hidden state.

    Reference: drl_classifier_ec_mmd_final_mul_newsplit_emnlp.py:184-331
    (--adapter {false,raw,sparsemax,entmax}).
    """

    NONE = "none"
    RAW = "raw"
    SPARSEMAX = "sparsemax"
    ENTMAX = "entmax"


class SelfStrategy(str, enum.Enum):
    """Self-training pseudo-labelling strategy.

    Reference: drl_classifier_ec_mmd_final_mul.py:768-791 (threshold / random /
    extreme) and newsplit:996-1053 (temporal_order, temporal_order_modification).
    """

    THRESHOLD = "threshold"
    RANDOM = "random"
    EXTREME = "extreme"
    TEMPORAL_ORDER = "temporal_order"
    TEMPORAL_ORDER_MODIFICATION = "temporal_order_modification"


@dataclass(frozen=True)
class EncoderConfig:
    """Transformer encoder (BERT/RoBERTa-style) hyperparameters.

    Defaults give a bert-base-sized encoder (12L/768H/12 heads) matching the
    reference's `hfl/chinese-roberta-wwm-ext` / `roberta-base` architecture
    (drl_classifier_ec_mmd_final_mul.py:186-192). The reference downloads
    pretrained weights from the HF hub; here weights can be randomly initialized
    or ported from a local HF checkpoint (``models/hf_port.py``).
    """

    vocab_size: int = 21128  # chinese-roberta-wwm-ext vocab; en preset overrides
    hidden_dim: int = 768
    num_layers: int = 12
    num_heads: int = 12
    mlp_dim: int = 3072
    max_position: int = 512
    type_vocab_size: int = 2
    dropout: float = 0.1
    layer_norm_eps: float = 1e-12
    # "bert" uses absolute positions from 0 and token types; "roberta" offsets
    # positions by pad_token_id+1 and uses a single token type.
    arch: str = "bert"
    pad_token_id: int = 0
    # compute dtype; params stay float32
    dtype: str = "bfloat16"
    remat: bool = False  # jax.checkpoint the encoder layers
    # attention implementation: "xla" (plain ops: fp32 scores, softmax,
    # dropout on the probabilities) or "flash" (the hand-written flash
    # attention kernels K7-K9 on CUDA, their plain version on the CPU; a
    # segment mask and no dropout on the probabilities)
    attention_impl: str = "xla"


@dataclass(frozen=True)
class DeepseekV2Config(EncoderConfig):
    """A DeepSeek-V2 decoder used as the pair classifier's encoder
    (``models/deepseek_v2.py``; arXiv:2405.04434, the published
    ``config.json`` of deepseek-ai/DeepSeek-V2-Lite for the defaults).

    The inherited fields read: ``mlp_dim`` the dense layers' SwiGLU width
    (``intermediate_size``), ``layer_norm_eps`` RMSNorm's eps,
    ``max_position`` the config's positions (rotary: no table is held),
    ``pad_token_id`` the id that pads rows on the right. The model has no
    dropout and no token types. ``experts_held`` = (first, count) is the
    range of routed experts this device holds, an expert-parallel rank's
    share: every layer routes over ``n_routed_experts`` and computes the
    held experts' part alone; None holds them all."""

    vocab_size: int = 102400
    hidden_dim: int = 2048
    num_layers: int = 27
    num_heads: int = 16
    mlp_dim: int = 10944
    max_position: int = 163840
    type_vocab_size: int = 0
    dropout: float = 0.0
    layer_norm_eps: float = 1e-6
    arch: str = "deepseek_v2"
    pad_token_id: int = 100001
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    moe_intermediate_size: int = 1408
    n_routed_experts: int = 64
    n_shared_experts: int = 2
    num_experts_per_tok: int = 6
    first_k_dense_replace: int = 1
    routed_scaling_factor: float = 1.0
    norm_topk_prob: bool = False
    rope_theta: float = 10000.0
    # YaRN (rope_scaling of the published config)
    rope_factor: float = 40.0
    rope_beta_fast: float = 32.0
    rope_beta_slow: float = 1.0
    rope_mscale: float = 0.707
    rope_mscale_all_dim: float = 0.707
    rope_original_max_position: int = 4096
    experts_held: Optional[tuple] = None

    def held_range(self) -> tuple:
        """(first, count) of the routed experts held here."""
        if self.experts_held is None:
            return 0, self.n_routed_experts
        first, count = self.experts_held
        if not (0 <= first and 1 <= count
                and first + count <= self.n_routed_experts):
            raise ValueError(f"experts_held {self.experts_held} outside the "
                             f"{self.n_routed_experts} routed experts")
        return int(first), int(count)


@dataclass(frozen=True)
class ModelConfig:
    """DrlClassifier-equivalent model (reference flagship :149-182)."""

    encoder: EncoderConfig = field(default_factory=EncoderConfig)
    ec_dim: int = 24  # emotion/cause latent dim (flagship :39)
    e_num_class: int = 6  # emotion classes (flagship :36)
    c_num_class: int = 1
    pair_num_class: int = 1
    bow_dim: int = 0  # set from the BoW vocab at build time
    dropout: float = 0.5  # flagship :50
    adapter: AdapterKind = AdapterKind.NONE
    head_number: int = 4  # adapter heads (newsplit :67)
    # DEAD FLAG, kept for parity: the reference's --confounding is also dead
    # (newsplit :105-108 only prints it; no code path reads it). Documented
    # in PARITY.md; do not wire.
    confounding: bool = False  # newsplit :68
    # GAN variant: emotion/cause treated as binary (ec_num_class=1,
    # drl_classifier_ec_gan.py:31); also used by pre-`_final` variants.
    binary_emotion: bool = False
    # Reference reparameterization quirk (flagship :345-351): one noise vector
    # shared across the batch, std = exp(log_var) (not exp(0.5*log_var)).
    # compat_sampling=True reproduces it exactly; False uses the textbook VAE
    # sampling (per-example noise, exp(0.5*log_var)).
    compat_sampling: bool = True
    # Local HF checkpoint directory (pytorch_model.bin/model.safetensors +
    # config.json) to initialize the encoder from; empty = random init
    # (the no-egress TPU environment cannot download from the hub).
    pretrained_encoder: str = ""


@dataclass(frozen=True)
class LossConfig:
    """Loss weights and schedules (flagship :40-49, :515-534)."""

    regularizer: Regularizer = Regularizer.MMD
    mmd_loss_weight: float = 30.0
    mmd_alphas: tuple = (0.1,)
    hsic_weight: float = 1.0
    hsic_sigma: float = 1.0
    ecce_adv_loss_weight: float = 1.0  # gan entropy weight (ec_gan :45)
    vi_beta_step: float = 0.1  # CLUB beta ramp per epoch (vi_final :772-777)
    emo_mul_loss_weight: float = 10.0
    cau_mul_loss_weight: float = 10.0
    pair_mul_loss_weight: float = 30.0
    ec_kl_lambda: float = 0.03
    kl_ann_iterations: int = 20000
    label_smoothing: float = 0.1
    epsilon: float = 1e-8


@dataclass(frozen=True)
class DataConfig:
    """Ingest configuration (flagship :30-73, newsplit :30-89)."""

    language: str = "zh"  # "zh" | "en"
    source_domain: str = "home"
    target_domain: str = "education"
    # 0 = auto-fit the token window to the data (rounded up to a multiple of
    # 16, capped at the reference's 128). Measured on v5e: the zh corpora fit
    # in 96 tokens with ZERO truncation, a free 1.34x throughput win
    # (RESULTS.md); pass 128 to force the reference's fixed window
    # (flagship :35).
    max_len: int = 0
    bow_file: str = ""  # resolved by presets / CLI
    train_file: str = ""  # explicit override of the resolved train path
    test_file: str = ""  # explicit override of the resolved test path
    bow_optimize: bool = True  # en token-level BoW (newsplit :35)
    predicted_emotion: bool = True  # newsplit test path logic :1212-1227
    data_root: str = ""  # root containing data/, domains/, pair_data/
    newsplit: bool = True  # zh: data/ECPE_new_dataset vs domains/THUCTC_multiple
    # tokenizer: "auto" trains/loads a cached WordPiece from the corpus;
    # may also be a path to an HF tokenizer directory.
    tokenizer: str = "auto"
    # self-chain variant (drl_classifier_ec_mmd_self_chain.py:932-1010):
    # pair construction via read_ECPE_self_chain_data — test mode keeps only
    # documents containing an emotion==cause gold pair, enumerates all
    # (gold emotion x non-cause) negatives, and has no stage-1 reconciliation
    # (num_unpred always 0); both sides read domains/THUCTC_multiple files.
    self_chain: bool = False
    seed: int = 42


@dataclass(frozen=True)
class TrainConfig:
    """Optimization schedule (flagship :41-57)."""

    epochs: int = 20
    batch_size: int = 64
    vae_lr: float = 1e-5
    adv_lr: float = 3e-3  # RMSprop disc lr (ec_gan :51)
    aprx_lr: float = 3e-3  # CLUB aux net Adam lr (vi_final :50)
    self_iteration: int = 50
    self_epochs: int = 10
    self_strategy: SelfStrategy = SelfStrategy.RANDOM
    round_up: bool = True  # newsplit :70
    # beyond-reference: drop a doc's pseudo-pair unless raw P(pos) - P(neg)
    # >= this margin (0.0 = reference-exact; see selftrain/strategies.py)
    self_conf_margin: float = 0.0
    # beyond-reference: keep only this fraction of docs, ranked by raw
    # P(pos) - P(neg) separation (quantile variant of the margin — it
    # self-calibrates to the model's current probability scale; 1.0 =
    # reference-exact)
    self_conf_keep: float = 1.0
    # beyond-reference: pseudo-pairs per document (the reference hard-codes
    # 1 pos + 1 neg, flagship :751-793; k>1 = top-k pos + k sampled negs)
    self_pairs_per_doc: int = 1
    # beyond-reference: locality prior on pseudo-labels — pseudo-positives
    # must sit within this sentence distance |emo - cau|, and beyond-window
    # predicted-positives become hard pseudo-negatives (98% of zh gold pairs
    # are within distance 2; scripts/fp_analysis.py). 0 = reference-exact
    self_max_dist: int = 0
    # beyond-reference: separate learning rate for self-training fine-tunes
    # (0 = vae_lr, reference-exact). The restart-from-best loop is a local
    # search around the anchor; a lower lr keeps each 5-epoch attempt from
    # drifting far below it (measured: at vae_lr 1e-4 attempts land mean
    # 0.12 F1 BELOW a 0.635 anchor)
    self_lr: float = 0.0
    # PRNG implementation for the training stream ("threefry" | "rbg").
    # rbg removes the TPU threefry dropout-mask tax (16.1 ms of the 50.5 ms
    # flagship step at b64xs96 — scripts/step_breakdown.py); threefry is the
    # default so published runs stay bit-reproducible
    rng_impl: str = "threefry"
    # Adam first-moment dtype ("float32" | "bfloat16"). bf16 mu halves one
    # of the three optimizer HBM arrays (102M params -> ~0.8 GB/step less
    # traffic); float32 stays default so published runs are untouched.
    optim_mu_dtype: str = "float32"
    eval_batch_size: int = 512  # reference evals the whole test set in one batch
    seed: int = 42
    # default under runs/ (gitignored) so an invocation that forgets
    # --checkpoint_dir doesn't scatter a checkpoints/ tree at the repo root
    checkpoint_dir: str = "runs/ckpt"
    # full-state snapshot cadence in epochs (0 = only best-F1 params);
    # snapshots restore (params, all optimizer states, step, PRNG) exactly
    save_state_every: int = 0
    log_dir: str = "result_logs"
    debug_nans: bool = False  # torch.autograd.set_detect_anomaly (flagship :837)
    profile_dir: str = ""  # torch.profiler Chrome trace of the base training
    donate: bool = True
    # train each epoch through one captured CUDA-graph step replayed over the
    # device-resident stacked epoch (train/scan_epoch.py), the counterpart of
    # the JAX package's whole-epoch lax.scan; --no_scan_epoch restores the
    # per-step loop (step-level debugging and profiling)
    scan_epoch: bool = True
    # parallelism
    num_devices: int = 0  # 0 = all available
    mesh_shape: Optional[tuple] = None  # (dp, tp), e.g. (4, 2)


@dataclass(frozen=True)
class CarelConfig:
    model: ModelConfig = field(default_factory=ModelConfig)
    loss: LossConfig = field(default_factory=LossConfig)
    data: DataConfig = field(default_factory=DataConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    name: str = "ec_mmd_final_mul_newsplit"

    def replace(self, **kw) -> "CarelConfig":
        return dataclasses.replace(self, **kw)


def _preset(name: str, **sections) -> CarelConfig:
    base = CarelConfig(name=name)
    return dataclasses.replace(base, **{k: v for k, v in sections.items()})


# Every reference trainer fork (SURVEY.md §2.2) as a config preset.
PRESETS: dict = {}


def register_preset(name: str, cfg: CarelConfig) -> CarelConfig:
    PRESETS[name] = cfg
    return cfg


register_preset(
    "ec_mmd_final_mul",
    _preset(
        "ec_mmd_final_mul",
        loss=LossConfig(regularizer=Regularizer.MMD),
        data=DataConfig(language="zh", source_domain="society_num",
                        target_domain="education", newsplit=False,
                        bow_optimize=False, predicted_emotion=False),
    ),
)

register_preset(
    "ec_mmd_final_mul_newsplit_emnlp",
    _preset(
        "ec_mmd_final_mul_newsplit_emnlp",
        loss=LossConfig(regularizer=Regularizer.MMD),
        data=DataConfig(language="zh", source_domain="home",
                        target_domain="education", newsplit=True),
        train=TrainConfig(
            self_strategy=SelfStrategy.TEMPORAL_ORDER_MODIFICATION),
    ),
)

register_preset(
    "ec_none",
    _preset(
        "ec_none",
        loss=LossConfig(regularizer=Regularizer.NONE),
        data=DataConfig(language="zh", source_domain="society_num",
                        target_domain="education", newsplit=False,
                        bow_optimize=False, predicted_emotion=False),
    ),
)

register_preset(
    "ec_final_mul",  # flagship minus the MMD term (drl_classifier_ec_final_mul.py)
    _preset(
        "ec_final_mul",
        loss=LossConfig(regularizer=Regularizer.NONE),
        data=DataConfig(language="zh", source_domain="society_num",
                        target_domain="education", newsplit=False,
                        bow_optimize=False, predicted_emotion=False),
    ),
)

register_preset(
    "ec_hsic",
    _preset(
        "ec_hsic",
        loss=LossConfig(regularizer=Regularizer.HSIC,
                        emo_mul_loss_weight=10.0, cau_mul_loss_weight=10.0),
        model=ModelConfig(binary_emotion=True),
        data=DataConfig(language="zh", source_domain="society_num",
                        target_domain="education", newsplit=False,
                        bow_optimize=False, predicted_emotion=False),
    ),
)

register_preset(
    "ec_gan",
    _preset(
        "ec_gan",
        loss=LossConfig(regularizer=Regularizer.GAN),
        model=ModelConfig(binary_emotion=True),
        data=DataConfig(language="zh", source_domain="society",
                        target_domain="education", newsplit=False,
                        bow_optimize=False, predicted_emotion=False),
    ),
)

register_preset(
    "ec_vi_final",
    _preset(
        "ec_vi_final",
        loss=LossConfig(regularizer=Regularizer.VI),
        data=DataConfig(language="zh", source_domain="society_num",
                        target_domain="education", newsplit=False,
                        bow_optimize=False, predicted_emotion=False),
    ),
)

register_preset(
    "ec_mmd_self_chain",  # drl_classifier_ec_mmd_self_chain.py: ec_mmd +
    # self-chain-aware reading; society -> entertainment, mmd weight 5,
    # 10 base epochs, binary emotion labels (:32,:41,:36,:73)
    _preset(
        "ec_mmd_self_chain",
        loss=LossConfig(regularizer=Regularizer.MMD, mmd_loss_weight=5.0),
        model=ModelConfig(binary_emotion=True),
        data=DataConfig(language="zh", source_domain="society",
                        target_domain="entertainment", newsplit=False,
                        bow_optimize=False, predicted_emotion=False,
                        self_chain=True),
        train=TrainConfig(epochs=10),
    ),
)

register_preset(
    "drl_en",  # drl_classifier_en.py: old-split English flagship
    _preset(
        "drl_en",
        loss=LossConfig(regularizer=Regularizer.MMD),
        data=DataConfig(language="en", source_domain="history_num",
                        target_domain="war_new", newsplit=False,
                        bow_optimize=False, predicted_emotion=False),
    ),
)

register_preset(
    "en_newsplit",
    _preset(
        "en_newsplit",
        loss=LossConfig(regularizer=Regularizer.MMD),
        data=DataConfig(language="en", source_domain="enecpe_num",
                        target_domain="reccon_test", newsplit=True),
    ),
)
