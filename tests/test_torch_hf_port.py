"""The port's HF checkpoint import (carel_tpu_torch.models.hf_port) against
HF's own forward and against carel_tpu's port, on the CPU in float32, with
no download: a randomly initialised tiny BertModel / RobertaModel is saved
locally, as tests/test_hf_port.py does, once as model.safetensors and once
as pytorch_model.bin.

Tolerances: hidden states (at real positions) and the pooler output rtol
1e-5 against HF's forward and against JAX's TransformerEncoder after
carel_tpu's port, with an atol of 1e-6 for entries near 0 (fp32 on all
sides, sums in other orders). The ported configs must be equal field for
field."""

import dataclasses
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")

from carel_tpu.models.encoder import TransformerEncoder as JEncoder
from carel_tpu.models.hf_port import \
    encoder_config_from_hf as j_encoder_config_from_hf
from carel_tpu.models.hf_port import \
    load_pretrained_encoder as j_load_pretrained_encoder

from carel_tpu_torch.config import EncoderConfig
from carel_tpu_torch.models import hf_port
from carel_tpu_torch.models.encoder import TransformerEncoder

# roberta-base's published config.json (the model card's), the shape the
# GPU smoke run's checkpoint carries
ROBERTA_BASE = dict(
    model_type="roberta", architectures=["RobertaForMaskedLM"],
    vocab_size=50265, hidden_size=768, num_hidden_layers=12,
    num_attention_heads=12, intermediate_size=3072,
    max_position_embeddings=514, type_vocab_size=1, layer_norm_eps=1e-5,
    pad_token_id=1, bos_token_id=0, eos_token_id=2, hidden_act="gelu",
    hidden_dropout_prob=0.1, attention_probs_dropout_prob=0.1)


def tiny_hf(arch: str, path: str, safe: bool = True, vocab: int = 120,
            hidden: int = 32, layers: int = 2, heads: int = 4, mlp: int = 64,
            max_pos: int = 40, pad_id: int = 1, seed: int = 0):
    """A randomly initialised tiny HF BertModel or RobertaModel (RoBERTa's
    token-type table of one row, as roberta-base has) saved under ``path``
    as model.safetensors (``safe``) or pytorch_model.bin."""
    torch.manual_seed(seed)
    kw = dict(vocab_size=vocab, hidden_size=hidden, num_hidden_layers=layers,
              num_attention_heads=heads, intermediate_size=mlp,
              max_position_embeddings=max_pos)
    if arch == "bert":
        model = transformers.BertModel(transformers.BertConfig(
            type_vocab_size=2, **kw))
    else:
        model = transformers.RobertaModel(transformers.RobertaConfig(
            type_vocab_size=1, pad_token_id=pad_id, layer_norm_eps=1e-5,
            **kw))
    model.eval()
    model.save_pretrained(path, safe_serialization=safe)
    return model


def _inputs(pad_id: int):
    rng = np.random.default_rng(0)
    B, L = 3, 12
    ids = rng.integers(5, 100, (B, L)).astype(np.int64)
    mask = np.ones((B, L), np.int64)
    mask[:, 9:] = 0
    mask[1, 5:] = 0
    ids[mask == 0] = pad_id
    return ids, mask


@pytest.mark.parametrize("safe", [True, False],
                         ids=["safetensors", "pytorch_model_bin"])
@pytest.mark.parametrize("arch", ["bert", "roberta"])
def test_ported_encoder_matches_hf_and_jax(arch, safe, tmp_path):
    path = str(tmp_path / arch)
    hf_model = tiny_hf(arch, path, safe)
    weights = "model.safetensors" if safe else "pytorch_model.bin"
    assert os.path.exists(os.path.join(path, weights))
    other = "pytorch_model.bin" if safe else "model.safetensors"
    assert not os.path.exists(os.path.join(path, other))

    cfg, state = hf_port.load_pretrained_encoder(path, dtype="float32")
    jcfg, jparams = j_load_pretrained_encoder(path, dtype="float32")
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert cfg.arch == arch and cfg.num_layers == 2
    assert cfg.type_vocab_size == (2 if arch == "bert" else 1)
    enc = TransformerEncoder(cfg)
    enc.load_state_dict(state)
    enc.eval()

    ids, mask = _inputs(cfg.pad_token_id)
    types = np.zeros_like(ids)
    with torch.no_grad():
        out = hf_model(input_ids=torch.tensor(ids),
                       attention_mask=torch.tensor(mask),
                       token_type_ids=torch.tensor(types))
        hidden, pooled = enc(torch.tensor(ids), torch.tensor(mask),
                             torch.tensor(types))
    j_hidden, j_pooled = JEncoder(jcfg).apply(
        {"params": jparams}, jnp.asarray(ids, jnp.int32),
        jnp.asarray(mask, jnp.int32), jnp.asarray(types, jnp.int32))
    m = mask.astype(bool)
    for want_h, want_p in ((out.last_hidden_state.numpy(),
                            out.pooler_output.numpy()),
                           (np.asarray(j_hidden), np.asarray(j_pooled))):
        np.testing.assert_allclose(hidden.numpy()[m], want_h[m], rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(pooled.numpy(), want_p, rtol=1e-5,
                                   atol=1e-6)


def test_roberta_base_config_and_only_dtype_kept(tmp_path):
    """roberta-base's published config gives its shape (vocab 50,265, 514
    positions, one token type, eps 1e-5, pad id 1), as JAX's reads it; and
    like JAX's, encoder_config_from_hf keeps only the dtype of the
    configured encoder, so an --hf_encoder run is back on the default
    attention (attention_impl "xla") whatever was configured."""
    (tmp_path / "config.json").write_text(json.dumps(ROBERTA_BASE))
    cfg = hf_port.encoder_config_from_hf(str(tmp_path), "bfloat16")
    jcfg = j_encoder_config_from_hf(str(tmp_path), "bfloat16")
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert (cfg.arch, cfg.vocab_size, cfg.max_position, cfg.type_vocab_size,
            cfg.layer_norm_eps, cfg.pad_token_id, cfg.hidden_dim,
            cfg.num_layers, cfg.num_heads, cfg.mlp_dim) == (
        "roberta", 50265, 514, 1, 1e-5, 1, 768, 12, 12, 3072)
    assert cfg.attention_impl == jcfg.attention_impl == "xla"
    assert EncoderConfig(attention_impl="flash").attention_impl == "flash"


def test_checkpoint_sizes_the_tables_and_orbax_raises(tmp_path):
    """A checkpoint loaded into a configured encoder (stage 1 and the DANN)
    keeps the configured heads, layers and arch and takes the checkpoint's
    table sizes; a directory without config.json (an orbax checkpoint of
    carel_tpu.pretrain) raises, naming ROADMAP Queue 3."""
    path = str(tmp_path / "roberta")
    tiny_hf("roberta", path, vocab=90, hidden=64, mlp=128, max_pos=70)
    want = EncoderConfig(vocab_size=300, hidden_dim=64, num_layers=2,
                         num_heads=4, mlp_dim=128, max_position=160,
                         type_vocab_size=2, dtype="float32")
    cfg, state = hf_port.load_encoder_checkpoint(path, want)
    assert cfg == dataclasses.replace(want, vocab_size=90, max_position=70,
                                      type_vocab_size=1)
    TransformerEncoder(cfg).load_state_dict(state)
    assert hf_port.is_hf_dir(path) and not hf_port.is_hf_dir("")
    os.makedirs(tmp_path / "orbax")
    with pytest.raises(NotImplementedError, match="Queue 3"):
        hf_port.load_encoder_checkpoint(str(tmp_path / "orbax"), want)
    os.makedirs(tmp_path / "no_weights")
    (tmp_path / "no_weights" / "config.json").write_text(
        (tmp_path / "roberta" / "config.json").read_text())
    with pytest.raises(FileNotFoundError, match="pytorch_model.bin"):
        hf_port.load_pretrained_encoder(str(tmp_path / "no_weights"))
