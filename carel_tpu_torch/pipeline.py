"""End-to-end pipeline assembly: config -> datasets -> sized config -> train
state. Port of carel_tpu/pipeline.py.

Resolves corpus paths exactly like the reference entry points
(drl_classifier_ec_mmd_final_mul.py:939-948 for the old split,
newsplit :1205-1227 for the new split + predicted-emotion test files), builds
the tokenizer/BoW/arrays, and sizes the model config to them: zh and en,
the self-chain pair construction, and a local HF checkpoint as the
encoder (its config.json sets the encoder's shape, its weights replace the
random ones in ``init_state``), or the port's own encoder directory
(``pretrain.save_encoder``, which the ``embed`` verb writes: the configured
encoder takes its weights; ``pretrain --out`` writes one too). An orbax
encoder directory (the JAX package's pretraining output) raises: the port
reads neither orbax nor jax.
"""

from __future__ import annotations

import dataclasses
import os
import random
import uuid
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from carel_tpu_torch.config import CarelConfig, EncoderConfig
from carel_tpu_torch.data.batching import PairArrays, encode_pairs
from carel_tpu_torch.data.bow import (BowVocab, build_bow_vocab_en,
                                      build_bow_vocab_zh, open_segmentation)
from carel_tpu_torch.data.ecpe_format import parse_ecpe_file
from carel_tpu_torch.data.pairs import PairSet, build_pairs
from carel_tpu_torch.data.self_chain import build_pairs_self_chain
from carel_tpu_torch.data.tokenizer import BaseTokenizer, build_tokenizer
from carel_tpu_torch.device import resolve_device
from carel_tpu_torch.models.drl import DrlModel
from carel_tpu_torch.models.encoder import init_flax_
from carel_tpu_torch.models.hf_port import (encoder_config_from_hf, is_hf_dir,
                                            load_encoder_checkpoint)
from carel_tpu_torch.parallel.sharding import shard_params
from carel_tpu_torch.parallel.tp import shard_params_tp
from carel_tpu_torch.train.state import TrainState, create_train_state


def resolve_paths(cfg: CarelConfig) -> Tuple[str, str, str]:
    """(train_path, test_path, bow_path) per language/split flags; explicit
    data.train_file / data.test_file override the convention."""
    d = cfg.data
    root = d.data_root

    def j(*parts):
        return os.path.join(root, *parts)

    if d.train_file and d.test_file:
        default_bow = ("data/all_data_pair_zh.txt" if d.language == "zh"
                       else "data/all_data_pair_en.txt")
        return (d.train_file, d.test_file, d.bow_file or j(default_bow))

    if d.language == "zh":
        train_dir = "data/ECPE_new_dataset" if d.newsplit else "domains/THUCTC_multiple"
        train_path = j(train_dir, f"{d.source_domain}.txt")
        if d.self_chain:
            # self-chain trainer reads both sides from THUCTC_multiple
            # (drl_classifier_ec_mmd_self_chain.py:1028-1031)
            test_path = j("domains/THUCTC_multiple", f"{d.target_domain}.txt")
        elif d.newsplit:
            if d.predicted_emotion:
                test_path = j("pair_data/predicted_emotion",
                              f"source_{d.source_domain}",
                              f"{d.target_domain}.txt")
            else:
                test_path = j("data/ECPE_new_dataset",
                              f"{d.target_domain}_test.txt")
        else:
            test_path = j("pair_data/emotion", f"{d.target_domain}.txt")
        bow_path = d.bow_file or j("data/all_data_pair_zh.txt")
    else:
        train_path = j("domains/Englishnovel_multiple", f"{d.source_domain}.txt")
        if d.predicted_emotion:
            test_path = j("pair_data/predicted_emotion",
                          f"source_{d.source_domain}", f"{d.target_domain}.txt")
        elif d.bow_optimize:
            test_path = j("pair_data/emotion", f"{d.target_domain}_optimize.txt")
        else:
            test_path = j("pair_data/emotion", f"{d.target_domain}.txt")
        default_bow = ("data/ecpe_and_reccon_all_data_pair_en.txt"
                       if d.newsplit else "data/all_data_pair_en.txt")
        bow_path = d.bow_file or j(default_bow)
    return (d.train_file or train_path, d.test_file or test_path, bow_path)


@dataclass
class Pipeline:
    cfg: CarelConfig  # sized: vocab, bow_dim and max_len set from the data
    model_id: str
    tokenizer: BaseTokenizer
    bow: BowVocab
    train_pairs: PairSet
    test_pairs: PairSet
    train_arrays: PairArrays
    test_arrays: PairArrays
    num_unpred_pairs: int

    def encode(self, pair_set: PairSet) -> PairArrays:
        return encode_pairs(pair_set, self.tokenizer, self.bow,
                            self.cfg.data.max_len)


def fit_max_len(tokenizer, texts, cap: int = 128, floor: int = 32) -> int:
    """Smallest multiple-of-16 window covering every text, in [floor, cap]
    (zero truncation relative to the reference's fixed 128-token window,
    flagship :35)."""
    probe = tokenizer.encode_batch(list(texts), cap)
    observed = int(probe.attention_mask.sum(axis=1).max())
    return min(cap, max(floor, -(-observed // 16) * 16))


def _spaced_sep(cfg: CarelConfig) -> bool:
    return cfg.data.language == "en" and cfg.data.bow_optimize


def build_pipeline(
    cfg: CarelConfig,
    cache_dir: str = ".carel_cache",
    encoder_cfg: Optional[EncoderConfig] = None,
    max_train_docs: int = 0,
    max_test_docs: int = 0,
) -> Pipeline:
    train_path, test_path, bow_path = resolve_paths(cfg)

    train_docs = parse_ecpe_file(train_path)
    test_docs = parse_ecpe_file(test_path)
    if max_train_docs:
        train_docs = train_docs[:max_train_docs]
    if max_test_docs:
        test_docs = test_docs[:max_test_docs]

    rng = random.Random(cfg.data.seed)
    spaced = _spaced_sep(cfg)
    make_pairs = (build_pairs_self_chain if cfg.data.self_chain
                  else build_pairs)
    train_pairs = make_pairs(train_docs, test=False, spaced_sep=spaced,
                             rng=rng)
    test_pairs = make_pairs(test_docs, test=True, spaced_sep=spaced, rng=rng)

    os.makedirs(cache_dir, exist_ok=True)
    segmenter = None
    if cfg.data.language == "zh":
        # jieba's words of the vocabulary build and of every pair string,
        # through the cache of these three files (written with jieba, read
        # without it)
        segmenter = open_segmentation(cache_dir,
                                      (train_path, test_path, bow_path))
        bow = build_bow_vocab_zh(bow_path, segmenter)
    else:
        bow = build_bow_vocab_en(bow_path, bow_optimize=cfg.data.bow_optimize)

    # tokenizer: an HF dir (data.tokenizer), else the cache, else built from
    # the BoW corpus and cached (no network)
    tok_cache = os.path.join(cache_dir,
                             f"tokenizer_{cfg.data.language}.json")
    hf = cfg.data.tokenizer if cfg.data.tokenizer not in ("auto", "") \
        else None
    corpus = None
    if hf is None and not os.path.exists(tok_cache):
        bow_docs = parse_ecpe_file(bow_path)
        corpus = [c.text for doc in bow_docs for c in doc.clauses]
    tokenizer = build_tokenizer(cfg.data.language, corpus, tok_cache, hf)

    # a local HF checkpoint dictates the encoder's shape (and keeps only the
    # configured dtype, as in the JAX package); otherwise the configured
    # encoder takes the tokenizer's vocab
    if is_hf_dir(cfg.model.pretrained_encoder):
        enc = encoder_config_from_hf(cfg.model.pretrained_encoder,
                                     (encoder_cfg or cfg.model.encoder).dtype)
    else:
        enc = dataclasses.replace(encoder_cfg or cfg.model.encoder,
                                  vocab_size=tokenizer.vocab_size)
    model_cfg = dataclasses.replace(cfg.model, encoder=enc, bow_dim=len(bow))
    cfg = dataclasses.replace(cfg, model=model_cfg)

    # max_len=0 -> fit the window to the data
    if cfg.data.max_len == 0:
        auto_len = fit_max_len(tokenizer,
                               train_pairs.pairs + test_pairs.pairs)
        cfg = dataclasses.replace(
            cfg, data=dataclasses.replace(cfg.data, max_len=auto_len))

    pipe = Pipeline(
        cfg=cfg,
        model_id=str(uuid.uuid4()),
        tokenizer=tokenizer,
        bow=bow,
        train_pairs=train_pairs,
        test_pairs=test_pairs,
        train_arrays=encode_pairs(train_pairs, tokenizer, bow,
                                  cfg.data.max_len),
        test_arrays=encode_pairs(test_pairs, tokenizer, bow,
                                 cfg.data.max_len),
        num_unpred_pairs=test_pairs.num_unpred_emotions,
    )
    if segmenter is not None:
        segmenter.save()
    return pipe


def init_state(cfg: CarelConfig, device="cuda",
               compat_frozen_latent_heads: bool = True,
               mesh=None) -> TrainState:
    """Model with Flax-style random init on ``device``, plus its optimizer.

    Seeds, all from cfg.train.seed: the parameters come from a CPU generator
    (so they do not depend on the device), dropout draws from the device's
    default generator (seeded here), and the sampling noise from a generator
    on the device seeded with seed + 1. When ``cfg.model.pretrained_encoder``
    is an HF checkpoint dir or the port's encoder dir, its weights then
    replace the encoder's; an orbax dir raises.

    Under a ``mesh`` (``parallel/mesh.py``) every rank seeds alike, the
    parameters are placed as JAX places them (carel_tpu/pipeline.py:
    240-248): split over 'model' when it has more than one rank
    (``shard_params_tp``), else replicated (``shard_params``); both check
    that the ranks hold rank 0's values. The model then gathers its latents
    over 'data'.
    """
    device = resolve_device(device)
    seed = cfg.train.seed
    torch.manual_seed(seed)
    model = DrlModel(cfg.model)
    init_flax_(model, torch.Generator().manual_seed(seed))
    if cfg.model.pretrained_encoder:
        model.encoder.load_state_dict(load_encoder_checkpoint(
            cfg.model.pretrained_encoder, cfg.model.encoder)[1])
    model.to(device)
    if mesh is not None:
        if mesh.tp > 1:
            shard_params_tp(mesh, model)
        else:
            shard_params(mesh, model)
        model.mesh = mesh
    sample_gen = torch.Generator(device=device).manual_seed(seed + 1)
    return create_train_state(cfg, model, sample_gen,
                              compat_frozen_latent_heads)
