"""Self-training: pseudo-labelling strategies and the outer loop."""

from carel_tpu_torch.selftrain.driver import self_train  # noqa: F401
from carel_tpu_torch.selftrain.strategies import (  # noqa: F401
    generate_self_train_pairs,
)
