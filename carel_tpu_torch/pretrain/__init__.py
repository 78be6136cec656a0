"""Encoder checkpoints of the port: ``save_encoder`` / ``load_encoder``
(the counterparts of carel_tpu/pretrain/mlm.py's). MLM pretraining itself
is not ported yet."""

from carel_tpu_torch.pretrain.mlm import (is_encoder_dir, load_encoder,  # noqa: F401
                                          save_encoder)
