"""Port HuggingFace BERT/RoBERTa checkpoints into this package's
TransformerEncoder, the counterpart of carel_tpu/models/hf_port.py, and
DeepSeek-V2 checkpoints (``model_type`` deepseek_v2, which the JAX package
does not read) into its DeepseekV2Encoder (``port_deepseek_v2``).

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

from carel_tpu_torch.config import DeepseekV2Config, EncoderConfig
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
    (``attention_impl`` among them) takes its default. A ``deepseek_v2``
    config gives a ``DeepseekV2Config`` that holds every routed expert."""
    with open(os.path.join(path, "config.json")) as f:
        cfg = json.load(f)
    if cfg.get("model_type") == "deepseek_v2":
        return deepseek_v2_config(cfg, dtype)
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


# the published DeepSeek-V2 settings the port does not implement, with the
# value it does
_DEEPSEEK_FIXED = {"q_lora_rank": None, "topk_method": "greedy",
                   "scoring_func": "softmax", "n_group": 1, "topk_group": 1,
                   "moe_layer_freq": 1, "hidden_act": "silu",
                   "attention_bias": False}


def deepseek_v2_config(cfg: dict, dtype: str = "bfloat16"
                       ) -> DeepseekV2Config:
    """A ``deepseek_v2`` config.json as the port's DeepseekV2Config; raises
    on a setting the port does not implement (q compression, grouped
    routing, another scoring function)."""
    other = {k: cfg[k] for k, v in _DEEPSEEK_FIXED.items()
             if k in cfg and cfg[k] != v}
    if other:
        raise NotImplementedError(f"deepseek_v2 settings the port does not "
                                  f"implement: {other}")
    rs = cfg.get("rope_scaling") or {}
    if rs and rs.get("type") != "yarn":
        raise NotImplementedError(f"rope_scaling {rs.get('type')!r}: the "
                                  "port implements yarn")
    base = DeepseekV2Config()
    yarn = dict(rope_factor=rs.get("factor", 1.0),
                rope_beta_fast=rs.get("beta_fast", base.rope_beta_fast),
                rope_beta_slow=rs.get("beta_slow", base.rope_beta_slow),
                rope_mscale=rs.get("mscale", 1.0),
                rope_mscale_all_dim=rs.get("mscale_all_dim", 0.0),
                rope_original_max_position=rs.get(
                    "original_max_position_embeddings",
                    cfg["max_position_embeddings"]))
    return DeepseekV2Config(
        vocab_size=cfg["vocab_size"], hidden_dim=cfg["hidden_size"],
        num_layers=cfg["num_hidden_layers"],
        num_heads=cfg["num_attention_heads"],
        mlp_dim=cfg["intermediate_size"],
        max_position=cfg["max_position_embeddings"],
        layer_norm_eps=cfg.get("rms_norm_eps", 1e-6),
        pad_token_id=cfg.get("pad_token_id",
                             cfg.get("eos_token_id", base.pad_token_id)),
        dtype=dtype, kv_lora_rank=cfg["kv_lora_rank"],
        qk_nope_head_dim=cfg["qk_nope_head_dim"],
        qk_rope_head_dim=cfg["qk_rope_head_dim"],
        v_head_dim=cfg["v_head_dim"],
        moe_intermediate_size=cfg["moe_intermediate_size"],
        n_routed_experts=cfg["n_routed_experts"],
        n_shared_experts=cfg["n_shared_experts"],
        num_experts_per_tok=cfg["num_experts_per_tok"],
        first_k_dense_replace=cfg["first_k_dense_replace"],
        routed_scaling_factor=float(cfg.get("routed_scaling_factor", 1.0)),
        norm_topk_prob=bool(cfg.get("norm_topk_prob", False)),
        rope_theta=float(cfg.get("rope_theta", 10000.0)), **yarn)


def port_deepseek_v2(sd: Dict[str, np.ndarray], cfg: DeepseekV2Config
                     ) -> Dict[str, torch.Tensor]:
    """The DeepseekV2Encoder's state_dict from a checkpoint's tensors
    (``model.`` names of DeepseekV2Model / ForCausalLM /
    ForSequenceClassification); of each mixture layer's routed experts only
    the held range ``cfg.held_range()`` is read, and its gate and up rows
    are stacked as the port holds them."""
    def g(name: str) -> torch.Tensor:
        return torch.from_numpy(sd["model." + name if "model." + name in sd
                                   else name])

    first, held = cfg.held_range()
    out = {"embed_tokens.weight": g("embed_tokens.weight"),
           "final_ln.weight": g("norm.weight")}
    attn = ("q_proj", "kv_a_proj_with_mqa", "kv_b_proj", "o_proj")
    for i in range(cfg.num_layers):
        p, q = f"layers.{i}.", f"layers.{i}."
        out[q + "input_ln.weight"] = g(p + "input_layernorm.weight")
        out[q + "post_attention_ln.weight"] = g(
            p + "post_attention_layernorm.weight")
        for n in attn:
            out[q + f"self_attn.{n}.weight"] = g(p + f"self_attn.{n}.weight")
        out[q + "self_attn.kv_a_ln.weight"] = g(
            p + "self_attn.kv_a_layernorm.weight")
        proj = ("gate_proj", "up_proj", "down_proj")
        if i < cfg.first_k_dense_replace:
            for n in proj:
                out[q + f"mlp.{n}.weight"] = g(p + f"mlp.{n}.weight")
            continue
        out[q + "mlp.gate"] = g(p + "mlp.gate.weight")
        experts = [p + f"mlp.experts.{e}." for e in range(first,
                                                           first + held)]
        out[q + "mlp.experts.gate_up"] = torch.stack([torch.cat(
            [g(e + "gate_proj.weight"), g(e + "up_proj.weight")])
            for e in experts])
        out[q + "mlp.experts.down"] = torch.stack(
            [g(e + "down_proj.weight") for e in experts])
        for n in proj:
            out[q + f"mlp.shared_experts.{n}.weight"] = g(
                p + f"mlp.shared_experts.{n}.weight")
    return out


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
    by ``cfg``'s heads and layers (fp32); DeepseekV2Encoder's for a
    ``deepseek_v2`` ``cfg``."""
    if cfg.arch == "deepseek_v2":
        return port_deepseek_v2(_load_state_dict(path), cfg)
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
    if cfg.arch == "deepseek_v2":
        return dataclasses.replace(
            cfg, vocab_size=state["embed_tokens.weight"].shape[0]), state
    kw = dict(vocab_size=state["word_embeddings.weight"].shape[0],
              max_position=state["position_embeddings.weight"].shape[0])
    if cfg.type_vocab_size > 0:
        kw["type_vocab_size"] = state["token_type_embeddings.weight"].shape[0]
    return dataclasses.replace(cfg, **kw), state
