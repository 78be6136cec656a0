"""Entry points: ``python -m carel_tpu_torch.cli train|presets``."""
