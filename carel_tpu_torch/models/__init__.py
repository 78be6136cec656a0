"""Models: encoder, VAE heads and attention adapters, discriminators, the
DrlModel and the plain pair classifier."""

from carel_tpu_torch.models.encoder import TransformerEncoder  # noqa: F401
from carel_tpu_torch.models.heads import VaeHeads, AttentionAdapter  # noqa: F401
from carel_tpu_torch.models.drl import DrlModel  # noqa: F401
from carel_tpu_torch.models.pair_classifier import PairClassifier  # noqa: F401
from carel_tpu_torch.models.discriminators import (  # noqa: F401
    ClubNet,
    DomainDiscriminator,
    LinearDiscriminator,
    grad_reverse,
)
from carel_tpu_torch.models.stage1 import DocEmotionModel  # noqa: F401
