"""The port's encoder directory, counterpart of the orbax directory that
carel_tpu/pretrain/mlm.py:249-263 writes and reads.

A directory holds one file, ``encoder.pt``: the ``TransformerEncoder``
state_dict in fp32, saved with ``torch.save`` and read with
``torch.load(weights_only=True)``. It holds no config: as JAX's orbax
directory, it is read into an encoder built from the configured
``EncoderConfig`` (``models/hf_port.load_encoder_checkpoint`` sizes the
tables to the file's). The ``embed`` verb writes one; ``train``, ``infer``,
``stage1``, ``dann``, ``embed`` and ``cit`` read one through
``--hf_encoder``. A JAX orbax directory is not readable here.
"""

from __future__ import annotations

import os
from typing import Dict

import torch

ENCODER_FILE = "encoder.pt"


def is_encoder_dir(path: str) -> bool:
    """A directory written by ``save_encoder``: it holds encoder.pt."""
    return bool(path) and os.path.exists(os.path.join(path, ENCODER_FILE))


def save_encoder(path: str, encoder_state: Dict[str, torch.Tensor]) -> str:
    """Write the encoder's state_dict (as fp32 CPU tensors) to
    ``path/encoder.pt``; returns the directory's absolute path."""
    path = os.path.abspath(path)
    os.makedirs(path, exist_ok=True)
    state = {k: v.detach().to("cpu", torch.float32).contiguous()
             for k, v in encoder_state.items()}
    tmp = os.path.join(path, ENCODER_FILE + ".tmp")
    torch.save(state, tmp)
    os.replace(tmp, os.path.join(path, ENCODER_FILE))
    return path


def load_encoder(path: str) -> Dict[str, torch.Tensor]:
    """The encoder's state_dict from a ``save_encoder`` directory (CPU,
    fp32)."""
    return torch.load(os.path.join(path, ENCODER_FILE), map_location="cpu",
                      weights_only=True)
