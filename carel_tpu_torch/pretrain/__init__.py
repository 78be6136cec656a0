"""MLM pretraining of the encoder and the port's encoder and MLM
directories (the counterparts of carel_tpu/pretrain/mlm.py's)."""

from carel_tpu_torch.pretrain.mlm import (MlmConfig, MlmModel,  # noqa: F401
                                          is_encoder_dir, load_encoder,
                                          load_mlm, pretrain_mlm,
                                          save_encoder, save_mlm)
