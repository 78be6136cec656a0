"""A DeepSeek-V2 checkpoint in the published layout (``config.json`` with
``model_type`` deepseek_v2 and ``model.``-prefixed tensors, each routed
expert's gate, up and down projections apart) read by
``carel_tpu_torch/models/hf_port.py``: a tiny synthetic checkpoint written
to a temporary directory, its config read, its tensors mapped (the held
experts only), the encoder's output against the plain version of
``deepseek_v2_plain.py``, and the ``train`` verb over it on the CPU."""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from carel_tpu_torch.models import deepseek_v2 as ds
from carel_tpu_torch.models import hf_port
from tests import deepseek_v2_plain as plain
from tests.test_torch_deepseek_v2 import hf_keys, inputs, tiny_cfg


def write_checkpoint(path: str, vocab: int = 97, seed: int = 0) -> dict:
    """A random DeepSeek-V2 checkpoint at the tiny widths with every
    expert; returns its tensors by published name."""
    cfg = tiny_cfg(held=None, vocab_size=vocab)
    c = dict(hf_keys(cfg), bos_token_id=1, eos_token_id=2)
    c.pop("pad_token_id")
    g = torch.Generator().manual_seed(seed)

    def mat(out, inp):
        return torch.randn(out, inp, generator=g) / inp ** 0.5

    def norm(n):
        return 1.0 + 0.02 * torch.randn(n, generator=g)

    d, h, mi = cfg.hidden_dim, cfg.num_heads, cfg.moe_intermediate_size
    sd = {"model.embed_tokens.weight": mat(vocab, d),
          "model.norm.weight": norm(d)}
    for i in range(cfg.num_layers):
        p = f"model.layers.{i}."
        sd.update({
            p + "input_layernorm.weight": norm(d),
            p + "post_attention_layernorm.weight": norm(d),
            p + "self_attn.q_proj.weight": mat(h * 24, d),
            p + "self_attn.kv_a_proj_with_mqa.weight": mat(32 + 8, d),
            p + "self_attn.kv_a_layernorm.weight": norm(32),
            p + "self_attn.kv_b_proj.weight": mat(h * 32, 32),
            p + "self_attn.o_proj.weight": mat(d, h * 16)})
        if i < cfg.first_k_dense_replace:
            sd.update({p + "mlp.gate_proj.weight": mat(cfg.mlp_dim, d),
                       p + "mlp.up_proj.weight": mat(cfg.mlp_dim, d),
                       p + "mlp.down_proj.weight": mat(d, cfg.mlp_dim)})
            continue
        sd[p + "mlp.gate.weight"] = mat(cfg.n_routed_experts, d)
        for e in range(cfg.n_routed_experts):
            q = p + f"mlp.experts.{e}."
            sd.update({q + "gate_proj.weight": mat(mi, d),
                       q + "up_proj.weight": mat(mi, d),
                       q + "down_proj.weight": mat(d, mi)})
        s = mi * cfg.n_shared_experts
        sd.update({p + "mlp.shared_experts.gate_proj.weight": mat(s, d),
                   p + "mlp.shared_experts.up_proj.weight": mat(s, d),
                   p + "mlp.shared_experts.down_proj.weight": mat(d, s)})
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(c, f)
    torch.save(sd, os.path.join(path, "pytorch_model.bin"))
    return sd


def plain_weights(sd: dict, cfg, held) -> dict:
    """The published tensors under the plain version's names, written out
    here apart from the port's mapping."""
    first, n = held
    P = {"encoder.embed_tokens.weight": sd["model.embed_tokens.weight"],
         "encoder.final_ln.weight": sd["model.norm.weight"]}
    for i in range(cfg.num_layers):
        p, q = f"model.layers.{i}.", f"encoder.layers.{i}."
        P[q + "input_ln.weight"] = sd[p + "input_layernorm.weight"]
        P[q + "post_attention_ln.weight"] = sd[
            p + "post_attention_layernorm.weight"]
        P[q + "self_attn.kv_a_ln.weight"] = sd[
            p + "self_attn.kv_a_layernorm.weight"]
        for name in ("q_proj", "kv_a_proj_with_mqa", "kv_b_proj", "o_proj"):
            P[q + f"self_attn.{name}.weight"] = sd[
                p + f"self_attn.{name}.weight"]
        if i < cfg.first_k_dense_replace:
            for name in ("gate_proj", "up_proj", "down_proj"):
                P[q + f"mlp.{name}.weight"] = sd[p + f"mlp.{name}.weight"]
            continue
        P[q + "mlp.gate"] = sd[p + "mlp.gate.weight"]
        ex = [p + f"mlp.experts.{e}." for e in range(first, first + n)]
        P[q + "mlp.experts.gate_up"] = torch.cat(
            [torch.cat([sd[e + "gate_proj.weight"], sd[e + "up_proj.weight"]])
             for e in ex])
        P[q + "mlp.experts.down"] = torch.cat([sd[e + "down_proj.weight"]
                                               for e in ex])
        for name in ("gate_proj", "up_proj", "down_proj"):
            P[q + f"mlp.shared_experts.{name}.weight"] = sd[
                p + f"mlp.shared_experts.{name}.weight"]
    return P


@pytest.mark.parametrize("held", [None, (2, 4)], ids=["all", "held_2_6"])
def test_checkpoint_config_and_names(held, tmp_path):
    """config.json gives the port's config (pad from eos); the loader maps
    every published name it needs (the held experts only) and the encoder
    over it equals the plain version over the same tensors (atol 2e-5, as
    in test_torch_deepseek_v2)."""
    path = str(tmp_path / "dsv2")
    sd = write_checkpoint(path)
    cfg, state = hf_port.load_pretrained_encoder(path, dtype="float32")
    want = tiny_cfg(held=None, pad_token_id=2)
    assert cfg == want
    if held is not None:
        cfg = dataclasses.replace(cfg, experts_held=held)
        cfg2, state = hf_port.load_encoder_checkpoint(path, cfg)
        assert cfg2 == cfg
    enc = ds.DeepseekV2Encoder(cfg)
    enc.load_state_dict(state)
    ids, mask = inputs()
    first_held = cfg.held_range()
    with torch.no_grad():
        _, pooled = enc(ids, mask)
        _, ref = plain.encode(plain_weights(sd, cfg, first_held),
                              hf_keys(cfg), ids, mask, first_held)
    torch.testing.assert_close(pooled, ref, atol=2e-5, rtol=0)


def test_unsupported_settings_raise(tmp_path):
    c = dict(hf_keys(tiny_cfg(held=None)), q_lora_rank=16)
    with pytest.raises(NotImplementedError, match="q_lora_rank"):
        hf_port.deepseek_v2_config(c)


def test_train_verb_over_a_deepseek_v2_checkpoint(tmp_path, capsys):
    """``train --hf_encoder DIR`` with a deepseek_v2 config.json on the CPU:
    the checkpoint sizes the encoder (its vocabulary is the tokenizer's
    beside it), one base epoch runs through the epoch step, and the log's
    train event holds the epoch's MoE counters."""
    from carel_tpu_torch.cli.main import main
    from carel_tpu_torch.data.tokenizer import WordPieceTokenizer
    from tests.test_torch_data import write_en_corpus
    from tests.test_torch_tokenizer_en import hf_tokenizer_dir

    corpus = str(tmp_path / "corpus")
    write_en_corpus(corpus)
    texts = [line for root, _, files in os.walk(corpus) for name in files
             for line in open(os.path.join(root, name), encoding="utf8")]
    wp = WordPieceTokenizer.train_from_corpus(texts[:400])
    path = str(tmp_path / "dsv2")
    write_checkpoint(path, vocab=wp.vocab_size)
    hf_tokenizer_dir(wp, path)
    logs = tmp_path / "logs"
    assert main(["train", "--preset", "en_newsplit", "--data_root", corpus,
                 "--encoder", "tiny", "--device", "cpu", "--hf_encoder",
                 path, "--cache_dir", str(tmp_path / "cache"),
                 "--checkpoint_dir", str(tmp_path / "ckpt"), "--log_dir",
                 str(logs), "--epochs", "1", "--self_iteration", "0",
                 "--batch_size", "8"]) == 0
    events = [json.loads(line) for f in logs.rglob("*.jsonl")
              for line in open(f)]
    train = [e for e in events if e.get("event") == "train"]
    assert train and train[0]["moe"]["layers"] == 2
    assert train[0]["moe"]["held_rows"] > 0
    assert np.isfinite(train[0]["loss"])
