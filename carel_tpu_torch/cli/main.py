"""Command-line entry points of the port: ``train`` and ``presets``.

    python -m carel_tpu_torch.cli train --preset ec_mmd_final_mul_newsplit_emnlp \\
        --data_root /path/to/corpora --self_iteration 0 [--device cuda]
    python -m carel_tpu_torch.cli presets

``train`` runs on the GPU unless ``--device cpu`` is given, and raises when
no GPU is there. Self-training is not ported yet, so ``train`` with
``--self_iteration`` > 0 (the presets' default is 50) raises and says so.
The last line of ``train`` is the JSON summary the JAX CLI prints.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from typing import Optional

from carel_tpu_torch.config import (
    PRESETS,
    CarelConfig,
    EncoderConfig,
    Regularizer,
)


def _encoder_preset(name: str, language: str) -> EncoderConfig:
    from carel_tpu_torch.models.encoder import tiny_encoder_config

    arch = "bert" if language == "zh" else "roberta"
    if name == "tiny":
        return tiny_encoder_config()
    if name == "base":
        return EncoderConfig(arch=arch, dtype="bfloat16")
    if name == "base_f32":
        return EncoderConfig(arch=arch, dtype="float32")
    raise SystemExit(f"unknown encoder preset: {name}")


def _apply_overrides(cfg: CarelConfig, args) -> CarelConfig:
    data, loss, train = cfg.data, cfg.loss, cfg.train
    dkw = {f: getattr(args, f) for f in
           ("data_root", "language", "source_domain", "target_domain",
            "train_file", "test_file", "max_len") if getattr(args, f)}
    if args.seed is not None:
        dkw["seed"] = args.seed
    data = dataclasses.replace(data, **dkw)
    if args.regularizer:
        loss = dataclasses.replace(loss,
                                   regularizer=Regularizer(args.regularizer))
    if args.mmd_loss_weight is not None:
        loss = dataclasses.replace(loss, mmd_loss_weight=args.mmd_loss_weight)
    tkw = {f: getattr(args, f) for f in
           ("epochs", "batch_size", "vae_lr", "self_iteration",
            "checkpoint_dir", "log_dir", "seed")
           if getattr(args, f) is not None}
    train = dataclasses.replace(train, **tkw)
    return dataclasses.replace(cfg, data=data, loss=loss, train=train)


def _add_train_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--preset", default="ec_mmd_final_mul_newsplit_emnlp",
                   choices=sorted(PRESETS))
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="run on the GPU (default) or, when asked, the CPU")
    p.add_argument("--data_root", default="")
    p.add_argument("--language", default="")
    p.add_argument("--source_domain", default="")
    p.add_argument("--target_domain", default="")
    p.add_argument("--train_file", default="",
                   help="explicit train-corpus path (overrides conventions)")
    p.add_argument("--test_file", default="")
    p.add_argument("--max_len", type=int, default=0)
    p.add_argument("--seed", type=int, default=None,
                   help="override the data/train seed (default 42)")
    p.add_argument("--regularizer", default="",
                   choices=["", "none", "mmd", "hsic", "gan", "vi"])
    p.add_argument("--mmd_loss_weight", type=float, default=None)
    p.add_argument("--encoder", default="base",
                   help="tiny | base (bf16) | base_f32")
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--batch_size", type=int, default=None)
    p.add_argument("--vae_lr", type=float, default=None)
    p.add_argument("--self_iteration", type=int, default=None)
    p.add_argument("--checkpoint_dir", default=None)
    p.add_argument("--log_dir", default=None)
    p.add_argument("--cache_dir", default=".carel_cache")
    p.add_argument("--max_train_docs", type=int, default=0)
    p.add_argument("--max_test_docs", type=int, default=0)


def cmd_train(args) -> int:
    from carel_tpu_torch.device import resolve_device

    device = resolve_device(args.device)
    cfg = _apply_overrides(PRESETS[args.preset], args)
    if cfg.train.self_iteration > 0:
        raise NotImplementedError(
            f"self-training (self_iteration={cfg.train.self_iteration}) is not "
            "ported to carel_tpu_torch yet; pass --self_iteration 0")

    from carel_tpu_torch.pipeline import build_pipeline, init_state
    from carel_tpu_torch.train.logging import JsonlLogger
    from carel_tpu_torch.train.loop import train_epochs
    from carel_tpu_torch.train.steps import make_eval_step, make_train_step

    enc = _encoder_preset(args.encoder, cfg.data.language)
    train_step = make_train_step(cfg)  # raises for unported regularizers
    pipe = build_pipeline(cfg, cache_dir=args.cache_dir, encoder_cfg=enc,
                          max_train_docs=args.max_train_docs,
                          max_test_docs=args.max_test_docs)
    cfg = pipe.cfg
    logger = JsonlLogger(cfg.train.log_dir,
                         f"{args.preset}_{pipe.model_id[:8]}")
    logger.log({"event": "config", "preset": args.preset,
                "model_id": pipe.model_id, "device": str(device),
                "train_pairs": len(pipe.train_arrays),
                "test_pairs": len(pipe.test_arrays),
                "num_unpred": pipe.num_unpred_pairs,
                "bow_dim": cfg.model.bow_dim,
                "vocab": cfg.model.encoder.vocab_size})

    state = init_state(cfg, device)
    state, best = train_epochs(
        cfg, state, train_step, make_eval_step(), pipe.train_arrays,
        pipe.test_arrays, pipe.num_unpred_pairs, pipe.model_id,
        logger=logger, best_cache={})
    logger.log({"event": "base_done", "p": best[0], "r": best[1],
                "f1": best[2]})
    logger.close()
    # best_f1 is the run's headline; without self-training it is the base
    print(json.dumps({"model_id": pipe.model_id, "best_f1": best[2],
                      "base_f1": best[2]}))
    return 0


def cmd_presets(_args) -> int:
    for name, cfg in sorted(PRESETS.items()):
        print(f"{name}: regularizer={cfg.loss.regularizer.value}, "
              f"language={cfg.data.language}, "
              f"{cfg.data.source_domain}->{cfg.data.target_domain}")
    return 0


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="carel_tpu_torch")
    sub = parser.add_subparsers(dest="command", required=True)
    p_train = sub.add_parser("train", help="stage-2 DRL pair classifier")
    _add_train_args(p_train)
    p_train.set_defaults(fn=cmd_train)
    p_pre = sub.add_parser("presets", help="list presets")
    p_pre.set_defaults(fn=cmd_presets)
    return parser


def main(argv: Optional[list] = None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
