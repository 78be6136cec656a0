"""Port HuggingFace BERT/RoBERTa checkpoints into this package's
TransformerEncoder; counterpart of carel_tpu/models/hf_port.py.

The reference downloads `hfl/chinese-roberta-wwm-ext` / `roberta-base` from
the hub (flagship :63-71, :186-192). Neither machine has network access, so
this module loads a LOCAL checkpoint directory (``model.safetensors`` or
``pytorch_model.bin``, plus ``config.json``). Combined with
``HFTokenizerAdapter`` it gives pretrained parity when the files are there.

There is one mapping: the HF tensors go into the JAX package's Flax layout
(as carel_tpu's port_hf_encoder builds it) and from there through
``convert.jax_params_to_state_dict``, as every other JAX parameter tree
does. Layouts:
- HF Linear weights are [out, in]; Flax Dense kernels are [in, out];
- the fused qkv kernel is [hidden, 3, heads, head_dim];
- the attention out-projection kernel is [heads, head_dim, hidden].

``safetensors`` is imported only when a checkpoint has a
``model.safetensors``; ``pytorch_model.bin`` loads through
``torch.load(weights_only=True)``.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, Tuple

import numpy as np
import torch

from carel_tpu_torch.config import EncoderConfig
from carel_tpu_torch.convert import jax_params_to_state_dict
from carel_tpu_torch.pretrain import is_encoder_dir, load_encoder


def is_hf_dir(path: str) -> bool:
    """A local HF checkpoint directory: it holds a config.json."""
    return bool(path) and os.path.exists(os.path.join(path, "config.json"))


def _load_state_dict(path: str) -> Dict[str, np.ndarray]:
    st_path = os.path.join(path, "model.safetensors")
    if os.path.exists(st_path):
        try:
            from safetensors.torch import load_file
        except ImportError as e:
            raise ImportError(
                f"{st_path} needs the 'safetensors' package, which this "
                f"machine lacks: {e}") from e
        sd = load_file(st_path)
    else:
        bin_path = os.path.join(path, "pytorch_model.bin")
        if not os.path.exists(bin_path):
            raise FileNotFoundError(
                f"no model.safetensors / pytorch_model.bin in {path}")
        sd = torch.load(bin_path, map_location="cpu", weights_only=True)
    return {k: v.float().numpy() for k, v in sd.items()}


def encoder_config_from_hf(path: str, dtype: str = "bfloat16"
                           ) -> EncoderConfig:
    """The encoder's shape from config.json. Like the JAX package's, it
    keeps only ``dtype`` of the configured encoder: every other field
    (``attention_impl`` among them) takes its default."""
    with open(os.path.join(path, "config.json")) as f:
        cfg = json.load(f)
    arch = "roberta" if "roberta" in cfg.get("model_type", "bert") else "bert"
    return EncoderConfig(
        vocab_size=cfg["vocab_size"],
        hidden_dim=cfg["hidden_size"],
        num_layers=cfg["num_hidden_layers"],
        num_heads=cfg["num_attention_heads"],
        mlp_dim=cfg["intermediate_size"],
        max_position=cfg["max_position_embeddings"],
        # RoBERTa keeps a size-1 token-type table added to every position
        type_vocab_size=cfg.get("type_vocab_size", 0),
        dropout=cfg.get("hidden_dropout_prob", 0.1),
        layer_norm_eps=cfg.get("layer_norm_eps", 1e-12),
        arch=arch,
        pad_token_id=cfg.get("pad_token_id", 0 if arch == "bert" else 1),
        dtype=dtype,
    )


def _flax_tree(sd: Dict[str, np.ndarray], cfg: EncoderConfig) -> dict:
    """The HF tensors in the JAX package's Flax layout of the encoder."""
    # strip the model prefix ("bert." / "roberta.")
    pref = next(p for p in ("bert.", "roberta.", "")
                if any(k.startswith(p + "embeddings") for k in sd))

    def g(name: str) -> np.ndarray:
        return sd[pref + name]

    h = cfg.hidden_dim
    nh = cfg.num_heads
    hd = h // nh
    params = {
        "word_embeddings": {
            "embedding": g("embeddings.word_embeddings.weight")},
        "position_embeddings": {
            "embedding": g("embeddings.position_embeddings.weight")},
        "embeddings_ln": {
            "scale": g("embeddings.LayerNorm.weight"),
            "bias": g("embeddings.LayerNorm.bias"),
        },
        "pooler": {
            "kernel": g("pooler.dense.weight").T,
            "bias": g("pooler.dense.bias"),
        },
    }
    if cfg.type_vocab_size > 0:
        params["token_type_embeddings"] = {
            "embedding": g("embeddings.token_type_embeddings.weight")}
    for i in range(cfg.num_layers):
        p = f"encoder.layer.{i}."
        qkv_w = np.stack(
            [g(p + f"attention.self.{n}.weight").T.reshape(h, nh, hd)
             for n in ("query", "key", "value")], axis=1)  # [h, 3, nh, hd]
        qkv_b = np.stack(
            [g(p + f"attention.self.{n}.bias").reshape(nh, hd)
             for n in ("query", "key", "value")], axis=0)  # [3, nh, hd]
        params[f"layer_{i}"] = {
            "attention": {
                "qkv": {"kernel": qkv_w, "bias": qkv_b},
                "out": {
                    "kernel": g(p + "attention.output.dense.weight")
                    .T.reshape(nh, hd, h),
                    "bias": g(p + "attention.output.dense.bias"),
                },
            },
            "attention_ln": {
                "scale": g(p + "attention.output.LayerNorm.weight"),
                "bias": g(p + "attention.output.LayerNorm.bias"),
            },
            "mlp_in": {
                "kernel": g(p + "intermediate.dense.weight").T,
                "bias": g(p + "intermediate.dense.bias"),
            },
            "mlp_out": {
                "kernel": g(p + "output.dense.weight").T,
                "bias": g(p + "output.dense.bias"),
            },
            "mlp_ln": {
                "scale": g(p + "output.LayerNorm.weight"),
                "bias": g(p + "output.LayerNorm.bias"),
            },
        }
    return params


def port_hf_encoder(path: str, cfg: EncoderConfig
                    ) -> Dict[str, torch.Tensor]:
    """TransformerEncoder's state_dict from an HF checkpoint dir, laid out
    by ``cfg``'s heads and layers (fp32)."""
    return jax_params_to_state_dict(_flax_tree(_load_state_dict(path), cfg))


def load_pretrained_encoder(path: str, dtype: str = "bfloat16"
                            ) -> Tuple[EncoderConfig, Dict[str, torch.Tensor]]:
    """(EncoderConfig, TransformerEncoder state_dict) from a local HF
    checkpoint directory."""
    cfg = encoder_config_from_hf(path, dtype)
    return cfg, port_hf_encoder(path, cfg)


def load_encoder_checkpoint(path: str, cfg: EncoderConfig
                            ) -> Tuple[EncoderConfig,
                                       Dict[str, torch.Tensor]]:
    """(``cfg`` sized to the checkpoint's tables, the encoder's state_dict)
    from an HF checkpoint dir, laid out by ``cfg``'s heads and layers, or
    from the port's own encoder dir (``pretrain.save_encoder``: encoder.pt,
    which ``pretrain --out`` and ``embed --out`` write).
    The tables' sizes (vocab, positions and, where ``cfg`` has them, token
    types) come from the checkpoint: the JAX package puts its tables into a
    model built from the configured encoder, and a torch module must be
    built with the sizes it loads. A JAX orbax dir (neither config.json nor
    encoder.pt) raises."""
    if is_hf_dir(path):
        state = port_hf_encoder(path, cfg)
    elif is_encoder_dir(path):
        state = load_encoder(path)
    else:
        raise NotImplementedError(
            f"{path}: an encoder directory with neither config.json nor "
            "encoder.pt is an orbax checkpoint of carel_tpu.pretrain, which "
            "carel_tpu_torch does not read (it imports neither orbax nor "
            "jax); write the port's own encoder dir with `pretrain --out` "
            "or `embed --out` (ROADMAP Queue 3)")
    kw = dict(vocab_size=state["word_embeddings.weight"].shape[0],
              max_position=state["position_embeddings.weight"].shape[0])
    if cfg.type_vocab_size > 0:
        kw["type_vocab_size"] = state["token_type_embeddings.weight"].shape[0]
    return dataclasses.replace(cfg, **kw), state
