"""Command-line entry points of the port: ``train``, ``infer``, ``stage1``,
``dann``, ``pair``, ``embed``, ``cit``, ``original``, ``pretrain``,
``case_analysis``, ``hpo``, ``ordering``, ``convert``, ``vis``,
``presets`` and ``bench``.

    python -m carel_tpu_torch.cli train --preset ec_mmd_final_mul_newsplit_emnlp \\
        --data_root /path/to/corpora [--device cuda] \\
        [--adapter raw|sparsemax|entmax --head_number 4] \\
        [--optim_mu_dtype bfloat16]
    python -m carel_tpu_torch.cli train --preset ec_hsic --data_root ...
    python -m carel_tpu_torch.cli train ... [--num_devices N] \\
        [--mesh_shape dp,tp]
    python -m carel_tpu_torch.cli train --preset en_newsplit --data_root ... \\
        [--hf_encoder /path/to/local/roberta-base]
    python -m carel_tpu_torch.cli infer --preset ... --data_root ... \\
        --model_id <id printed by train> [--output_dir pair_data/ec_pair]
    python -m carel_tpu_torch.cli stage1 --data_root ... [--language en]
        [--clause_mixer transformer] [--carried_adam] [--save_dir DIR]
    python -m carel_tpu_torch.cli dann --data_root ... [--no_domain_loss]
    python -m carel_tpu_torch.cli pair --data_root ... [--sentence_pair]
        [--self_chain] [--self_iteration N]
    python -m carel_tpu_torch.cli embed --files a.txt b.txt --out ENC_DIR \
        [--level doc|clause] [--dump_embeddings emb.npz]
    python -m carel_tpu_torch.cli cit --data_root ... --pred_pkl P --true_pkl T
        [--hf_encoder ENC_DIR]
    python -m carel_tpu_torch.cli original --data_root ... [--bow_loss]
    python -m carel_tpu_torch.cli pretrain --data_root ... --out ENC_DIR \\
        [--save_mlm MLM_DIR] [--steps N --scan_size K] [--init_encoder DIR]
    python -m carel_tpu_torch.cli ordering --file f.txt \\
        [--mlm_model MLM_DIR --encoder ... --cache_dir ...]
    python -m carel_tpu_torch.cli case_analysis --data_root ... \\
        --model_id_a A --model_id_b B [--out_csv c.csv]
    python -m carel_tpu_torch.cli hpo --data_root ... [--n_trials N]
    python -m carel_tpu_torch.cli convert reccon|train_to_test|json_split|\\
        bow_concat --source ... --target ...
    python -m carel_tpu_torch.cli vis --files a.txt b.txt [--method pca]
    python -m carel_tpu_torch.cli presets
    python -m carel_tpu_torch.cli bench [--device cuda]

``train`` runs the base epochs with per-epoch evaluation and best
checkpointing, then ``--self_iteration`` self-training iterations (the
presets' default is 50; 0 skips them). Each epoch trains through one
captured CUDA-graph step replayed over the stacked epoch (the counterpart
of the JAX package's whole-epoch scan) unless ``--no_scan_epoch`` or
``--debug_nans`` asks for the per-step loop; ``--save_state_every`` and
``--resume`` save and restore the full train state, ``--profile_dir``
traces the base training. ``--num_devices N`` (0: every device) and
``--mesh_shape dp,tp`` train over a mesh (``parallel/``): the verb starts
one worker process a device (a TCP rendezvous on 127.0.0.1, NCCL on the
cards, gloo under ``--device cpu``), splits each batch over 'data' and,
with tp over 1, the encoder's heads and MLP columns over 'model'; every
rank computes the global batch's loss, as JAX's single controller does, and
rank 0 logs, writes the checkpoints and prints the last line. ``infer``
loads the best checkpoint of ``--model_id`` (random weights without it),
scores every pair of the test file in fixed-size batches and, with
``--output_dir``, writes the true/pred pickles. ``stage1`` trains the document-level emotion model on the source
domain, self-trains on the target and writes the stage-1 pair file that the
``predicted_emotion`` presets test on; ``dann`` runs the clause-level DANN
emotion classifier with its self-training; ``pair`` trains the plain pair
classifier (encoder pooler, dropout, one logit) with threshold
self-training. ``embed`` fine-tunes the encoder with the batch-all
triplet loss on domain labels and writes it as the port's encoder dir
(``encoder.pt``, pretrain/mlm.py); ``cit`` trains the CIT triple classifier
as a filter over ``infer --output_dir``'s predictions; ``original`` runs the
original 3-latent DRL trainer (society -> finance). ``pretrain`` trains
the encoder as a masked LM on the local corpora and writes the port's
encoder dir (``--save_mlm``: the whole MLM too, which ``ordering
--mlm_model`` scores with); ``case_analysis`` compares two best checkpoints
on the test set; ``hpo`` searches the loss weights and lr; ``ordering``,
``convert`` and ``vis`` run on the host, except the MLM scorer. ``bench``
times the flagship's train step at b64 x s96 on random ids and prints
pairs/s, ms a step (captured and eager) and the share of the H100's bf16
peak (``bench.py``).
``--adapter`` (train and infer) reads each latent's features
through its own attention adapter over the last hidden state, and
``--optim_mu_dtype bfloat16`` stores the main Adam's first moment in bf16;
``--track_memorization`` also writes ``memorization.png`` beside the log
where matplotlib imports. ``--hf_encoder`` takes a local HF
BERT/RoBERTa checkpoint directory: under ``train`` and ``infer`` its
config.json sets the encoder's shape and the directory is also the
tokenizer, under ``stage1``, ``dann``, ``embed``, ``cit`` and ``original``
its weights replace the configured encoder's, as in the JAX CLI; every verb
that takes it also reads the port's encoder dir that ``embed`` and
``pretrain`` write (the configured encoder and the corpus tokenizer take
its weights). All of them run on the GPU
unless ``--device cpu`` is given, and raise when no GPU is there. The last
line of each is the JSON summary the JAX CLI prints.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
from typing import Optional

from carel_tpu_torch.config import (
    PRESETS,
    CarelConfig,
    AdapterKind,
    EncoderConfig,
    Regularizer,
    SelfStrategy,
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
    data, loss, model, train = cfg.data, cfg.loss, cfg.model, cfg.train
    dkw = {f: getattr(args, f) for f in
           ("data_root", "language", "source_domain", "target_domain",
            "train_file", "test_file", "max_len") if getattr(args, f)}
    if args.seed is not None:
        dkw["seed"] = args.seed
    if args.self_chain:
        dkw["self_chain"] = True
    data = dataclasses.replace(data, **dkw)
    if args.regularizer:
        loss = dataclasses.replace(loss,
                                   regularizer=Regularizer(args.regularizer))
    if args.mmd_loss_weight is not None:
        loss = dataclasses.replace(loss, mmd_loss_weight=args.mmd_loss_weight)
    if args.adapter:
        model = dataclasses.replace(model, adapter=AdapterKind(args.adapter))
    if args.head_number:
        model = dataclasses.replace(model, head_number=args.head_number)
    if args.hf_encoder:
        from carel_tpu_torch.models.hf_port import is_hf_dir

        model = dataclasses.replace(model, pretrained_encoder=args.hf_encoder)
        # an HF checkpoint dir also supplies the tokenizer; the port's
        # encoder dir keeps the corpus-built one (an orbax dir too, and
        # raises at init_state)
        if is_hf_dir(args.hf_encoder):
            data = dataclasses.replace(data, tokenizer=args.hf_encoder)
    tkw = {f: getattr(args, f) for f in
           ("epochs", "batch_size", "vae_lr", "self_iteration", "self_epochs",
            "checkpoint_dir", "log_dir", "seed")
           if getattr(args, f) is not None}
    if args.self_strategy:
        tkw["self_strategy"] = SelfStrategy(args.self_strategy)
    # the beyond-reference knobs override the preset only when set away from
    # their reference-exact values, as in the JAX CLI
    if args.self_conf_margin:
        tkw["self_conf_margin"] = args.self_conf_margin
    if args.self_conf_keep < 1.0:
        tkw["self_conf_keep"] = args.self_conf_keep
    if args.self_pairs_per_doc > 1:
        tkw["self_pairs_per_doc"] = args.self_pairs_per_doc
    if args.self_lr:
        tkw["self_lr"] = args.self_lr
    if args.self_max_dist > 0:
        tkw["self_max_dist"] = args.self_max_dist
    if args.no_round_up:
        tkw["round_up"] = False
    elif args.round_up:
        tkw["round_up"] = True
    # the train verb's flags; infer has none of them
    if getattr(args, "optim_mu_dtype", None):
        tkw["optim_mu_dtype"] = args.optim_mu_dtype
    if getattr(args, "save_state_every", 0):
        tkw["save_state_every"] = args.save_state_every
    if getattr(args, "profile_dir", ""):
        tkw["profile_dir"] = args.profile_dir
    if getattr(args, "debug_nans", False):
        tkw["debug_nans"] = True
    if getattr(args, "num_devices", None) is not None:
        tkw["num_devices"] = args.num_devices
    if getattr(args, "mesh_shape", ""):
        try:
            parts = [int(x) for x in args.mesh_shape.split(",")]
        except ValueError:
            parts = []
        if len(parts) != 2:
            raise SystemExit("--mesh_shape expects 'dp,tp', e.g. 4,2")
        tkw["mesh_shape"] = tuple(parts)
    if getattr(args, "scan_epoch", False):
        tkw["scan_epoch"] = True
    if getattr(args, "no_scan_epoch", False):
        tkw["scan_epoch"] = False
    train = dataclasses.replace(train, **tkw)
    return dataclasses.replace(cfg, data=data, loss=loss, model=model,
                               train=train)


def _nonneg_float(value: str) -> float:
    v = float(value)
    if v < 0:
        raise argparse.ArgumentTypeError(f"must be >= 0, got {value}")
    return v


def _keep_fraction(value: str) -> float:
    v = float(value)
    if not 0.0 < v <= 1.0:
        raise argparse.ArgumentTypeError(f"must be in (0, 1], got {value}")
    return v


def _add_common_args(p: argparse.ArgumentParser) -> None:
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
    p.add_argument("--adapter", default="",
                   choices=["", "none", "raw", "sparsemax", "entmax"],
                   help="attention adapter over the last hidden state for "
                        "each latent (newsplit's --adapter)")
    p.add_argument("--head_number", type=int, default=0,
                   help="heads of the raw adapter (0 = the preset's, 4)")
    p.add_argument("--encoder", default="base",
                   help="tiny | base (bf16) | base_f32")
    p.add_argument("--hf_encoder", default="",
                   help="local HF checkpoint dir to init the encoder from")
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--batch_size", type=int, default=None)
    p.add_argument("--vae_lr", type=float, default=None)
    p.add_argument("--self_iteration", type=int, default=None)
    p.add_argument("--self_epochs", type=int, default=None)
    p.add_argument("--self_strategy", default="",
                   choices=["", "threshold", "random", "extreme",
                            "temporal_order", "temporal_order_modification"])
    p.add_argument("--self_conf_margin", type=_nonneg_float, default=0.0,
                   help="drop a doc's pseudo-pair unless P(pos)-P(neg) >= "
                        "margin (0 = reference-exact self-training)")
    p.add_argument("--self_conf_keep", type=_keep_fraction, default=1.0,
                   help="keep only this fraction of docs per iteration, "
                        "ranked by P(pos)-P(neg) separation (1.0 = "
                        "reference)")
    p.add_argument("--self_pairs_per_doc", type=int, default=1,
                   help="pseudo-pairs per document (top-k pos + k sampled "
                        "negs; 1 = reference-exact)")
    p.add_argument("--self_lr", type=_nonneg_float, default=0.0,
                   help="separate lr for the self-training fine-tunes (0 = "
                        "vae_lr, reference-exact)")
    p.add_argument("--self_max_dist", type=int, default=0,
                   help="locality prior on pseudo-labels: positives within "
                        "this |emo-cau| sentence distance, beyond-window "
                        "predicted-positives become hard negatives (0 = "
                        "reference-exact)")
    p.add_argument("--self_chain", action="store_true",
                   help="self-chain pair construction (read_ECPE_self_chain_"
                        "data: test keeps only emotion==cause docs; see "
                        "preset ec_mmd_self_chain)")
    p.add_argument("--round_up", action="store_true",
                   help="rank rounded 0/1 predictions in self-training "
                        "(the reference default)")
    p.add_argument("--no_round_up", action="store_true",
                   help="rank raw probabilities in self-training")
    p.add_argument("--self_anchor_base", action="store_true",
                   help="seed the self-training best from the base metrics "
                        "(the reference zero-inits it, flagship :967)")
    p.add_argument("--self_fallback_base", action="store_true",
                   help="report the base metrics as best_f1 when "
                        "self-training never produces a non-empty pseudo "
                        "set (default: the reference's zero-initialized "
                        "self metrics)")
    p.add_argument("--track_memorization", action="store_true",
                   help="log per-iteration pseudo-positive churn as "
                        "'memorization' events")
    p.add_argument("--checkpoint_dir", default=None)
    p.add_argument("--log_dir", default=None)
    p.add_argument("--cache_dir", default=".carel_cache")
    p.add_argument("--max_train_docs", type=int, default=0)
    p.add_argument("--max_test_docs", type=int, default=0)


def _add_train_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--scan_epoch", action="store_true",
                   help="train each epoch through one captured CUDA-graph "
                        "step replayed over the stacked epoch (the default)")
    p.add_argument("--no_scan_epoch", action="store_true",
                   help="per-step training loop (step-level debugging)")
    p.add_argument("--save_state_every", type=int, default=0,
                   help="full resumable-state snapshot cadence (epochs)")
    p.add_argument("--resume", default="",
                   help="model_id whose state snapshot to resume from")
    p.add_argument("--profile_dir", default="",
                   help="write a torch.profiler trace of the base training "
                        "here")
    p.add_argument("--optim_mu_dtype", choices=["float32", "bfloat16"],
                   default=None,
                   help="the main Adam's first-moment dtype (bfloat16 "
                        "halves one of its three state arrays; float32 "
                        "default)")
    p.add_argument("--debug_nans", action="store_true",
                   help="torch.autograd.set_detect_anomaly (the reference's "
                        "anomaly detection); it reads values back to the "
                        "host and cannot be captured, so the per-step loop "
                        "runs")
    p.add_argument("--num_devices", type=int, default=None,
                   help="devices for the data mesh (0 = all; none = no "
                        "mesh)")
    p.add_argument("--mesh_shape", default="",
                   help="dp,tp mesh, e.g. 4,2 = dp4 x tp2 (Megatron-split "
                        "encoder weights on the model axis)")


def cmd_train(args) -> int:
    from carel_tpu_torch.device import resolve_device

    device = resolve_device(args.device)
    cfg = _apply_overrides(PRESETS[args.preset], args)
    shape = _mesh_shape(args, cfg, device)
    if shape is not None:
        return _train_on_mesh(args, cfg, device, shape)

    import torch

    with torch.autograd.set_detect_anomaly(cfg.train.debug_nans):
        return _train(args, cfg, device)


def _mesh_shape(args, cfg: CarelConfig, device):
    """(dp, tp) of the mesh the flags ask for, or None: ``--mesh_shape``
    gives it, ``--num_devices N`` is (N, 1) (0: every device), no flag no
    mesh, as in the JAX CLI."""
    from carel_tpu_torch.parallel.mesh import local_device_count

    if cfg.train.mesh_shape is not None:
        return tuple(cfg.train.mesh_shape)
    if args.num_devices is None:
        return None
    return (args.num_devices or local_device_count(device), 1)


def _train_on_mesh(args, cfg: CarelConfig, device, shape) -> int:
    """Train over a (dp, tp) mesh: one worker a device, started here (a
    world of one runs in this process)."""
    from carel_tpu_torch.parallel.mesh import free_port, local_device_count

    world = shape[0] * shape[1]
    if world < 1:
        raise SystemExit(f"mesh shape {shape} holds no device")
    if device.type == "cuda" and world > local_device_count(device):
        raise SystemExit(f"mesh shape {shape} needs {world} cards, this "
                         f"machine has {local_device_count(device)}")
    port = free_port()
    if world == 1:
        return _mesh_worker(0, args, cfg, device.type, port, shape)
    import torch.multiprocessing as mp

    mp.spawn(_mesh_worker, args=(args, cfg, device.type, port, shape),
             nprocs=world, join=True)
    return 0


def _mesh_worker(rank: int, args, cfg: CarelConfig, device_type: str,
                 port: int, shape) -> int:
    import torch
    import torch.distributed as dist

    from carel_tpu_torch.parallel.mesh import init_distributed, make_mesh

    world = shape[0] * shape[1]
    device = torch.device(device_type, rank) if device_type == "cuda" \
        else torch.device("cpu")
    if device_type == "cpu":
        # the ranks share the machine's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    init_distributed(rank, world, port, device)
    try:
        axes = ("data", "model") if cfg.train.mesh_shape is not None \
            else ("data",)
        mesh = make_mesh(world, axes, shape if len(axes) == 2
                         else shape[:1])
        with torch.autograd.set_detect_anomaly(cfg.train.debug_nans):
            return _train(args, cfg, device, mesh)
    finally:
        dist.destroy_process_group()


def _train(args, cfg: CarelConfig, device, mesh=None) -> int:
    from carel_tpu_torch.pipeline import build_pipeline, init_state
    from carel_tpu_torch.selftrain import self_train
    from carel_tpu_torch.train import checkpoint as ckpt
    from carel_tpu_torch.train.logging import JsonlLogger
    from carel_tpu_torch.train.loop import train_epochs
    from carel_tpu_torch.train.scan_epoch import make_epoch_step
    from carel_tpu_torch.train.state import set_lr
    from carel_tpu_torch.train.steps import make_eval_step, make_train_step
    from carel_tpu_torch.utils.profiling import trace

    enc = _encoder_preset(args.encoder, cfg.data.language)

    def pipeline():
        return build_pipeline(cfg, cache_dir=args.cache_dir, encoder_cfg=enc,
                              max_train_docs=args.max_train_docs,
                              max_test_docs=args.max_test_docs)

    lead = mesh is None or mesh.rank == 0
    if lead:
        pipe = pipeline()
    if mesh is not None:
        # rank 0 writes the caches (tokenizer, segmentation) that the
        # others then read, and every rank takes its model id
        import torch.distributed as dist

        dist.barrier(group=mesh.group)
        if not lead:
            pipe = pipeline()
        ids = [pipe.model_id]
        dist.broadcast_object_list(ids, src=0, group=mesh.group)
        pipe.model_id = ids[0]
    cfg = pipe.cfg
    # anomaly mode reads values back to the host, which a captured step
    # cannot do: under --debug_nans the per-step loop runs
    epoch_step = cfg.train.scan_epoch and not cfg.train.debug_nans
    train_step = make_epoch_step(cfg) if epoch_step else make_train_step(cfg)
    logger = JsonlLogger(cfg.train.log_dir if lead else "",
                         f"{args.preset}_{pipe.model_id[:8]}", echo=lead)
    segmenter = pipe.bow.segmenter
    logger.log({"event": "config", "preset": args.preset,
                "model_id": pipe.model_id, "device": str(device),
                "epoch_step": epoch_step,
                "mesh_shape": list(mesh.shape) if mesh else None,
                "segmentation": segmenter.source if segmenter else None,
                "train_pairs": len(pipe.train_arrays),
                "test_pairs": len(pipe.test_arrays),
                "num_unpred": pipe.num_unpred_pairs,
                "bow_dim": cfg.model.bow_dim,
                "vocab": cfg.model.encoder.vocab_size})

    state = init_state(cfg, device, mesh=mesh)
    if args.resume:
        state = ckpt.load_state(cfg.train.checkpoint_dir, args.resume, state,
                                mesh)
        logger.log({"event": "resumed", "from": args.resume,
                    "step": state.step})
    eval_step = make_eval_step()
    best_cache: dict = {}
    with trace(cfg.train.profile_dir if lead else ""):
        state, best = train_epochs(
            cfg, state, train_step, eval_step, pipe.train_arrays,
            pipe.test_arrays, pipe.num_unpred_pairs, pipe.model_id,
            logger=logger, best_cache=best_cache, mesh=mesh)
    self_training = cfg.train.self_iteration > 0
    logger.log({"event": "base_done", "p": best[0], "r": best[1],
                "f1": best[2],
                **({} if self_training else _run_record(train_step))})

    final_best = best
    if self_training:
        if cfg.train.self_lr > 0.0:
            # the fine-tunes' main Adam takes self_lr (its state does not
            # depend on lr); the disc and club optimizers keep adv_lr and
            # aprx_lr, as JAX's self_cfg replaces only vae_lr. The JAX CLI
            # rebuilds only the step, so there the new lr never reaches its
            # optimizer; the port applies it, as JAX's comment says it does.
            # set_lr writes the lr in place, so the captured step replays
            # with it
            set_lr(state.optimizer, cfg.train.self_lr)
        # the same step serves every fine-tune: its capture holds for a
        # pseudo set of any size (the JAX CLI's switch to the per-step loop
        # when the size varies spares a compile per size; the port has none)
        state, sbest = self_train(
            cfg, state, train_step, eval_step, pipe.test_pairs,
            pipe.test_arrays, pipe.num_unpred_pairs, pipe.encode,
            pipe.model_id, logger=logger,
            track_memorization=args.track_memorization,
            best_cache=best_cache,
            initial_best=best if args.self_anchor_base else None,
            mesh=mesh)
        if args.track_memorization and logger.path:
            _plot_memorization(logger, cfg.train.log_dir)
        logger.log({"event": "self_done", "p": sbest[0], "r": sbest[1],
                    "f1": sbest[2], **_run_record(train_step)})
        # reference-exact default: when self-training never produces a
        # non-empty pseudo set, sbest stays at the (0, 0, 0) the reference's
        # zero-initialised self metrics report (flagship :967);
        # --self_fallback_base reports the base metrics instead
        if sbest[2] > 0.0 or not args.self_fallback_base:
            final_best = sbest
        else:
            logger.log({"event": "selftrain_no_improvement",
                        "fallback": "base", "base_f1": best[2]})
    logger.close()
    # best_f1 is the run's headline (the self-training best when it ran, the
    # reference's reported number); base_f1 is the best before it
    if lead:
        print(json.dumps({"model_id": pipe.model_id,
                          "best_f1": final_best[2], "base_f1": best[2]}))
    return 0


def _run_record(train_step) -> dict:
    """What the run did, on its last summary event: the epoch step's
    captures and replays, every kernel's launches in this process, and
    whether jieba was imported."""
    from carel_tpu_torch import ops

    return {"captures": getattr(train_step, "captures", None),
            "replays": getattr(train_step, "replays", None),
            "launches": ops.launch_counts(),
            "jieba_imported": "jieba" in sys.modules}


def _plot_memorization(logger, log_dir: str) -> None:
    """memorization.png from the run's log, logged as 'memorization_plot'
    (carel_tpu/cli/main.py:404-414); where matplotlib does not import, the
    event says so instead."""
    from carel_tpu_torch.tools.memorization_plot import plot_memorization

    try:
        png = plot_memorization(logger.path, os.path.join(
            log_dir or ".", "memorization.png"))
    except ImportError as e:
        logger.log({"event": "memorization_plot", "path": None,
                    "skipped": f"matplotlib does not import: {e}"})
        return
    if png:
        logger.log({"event": "memorization_plot", "path": png})


def cmd_infer(args) -> int:
    from carel_tpu_torch.device import resolve_device

    device = resolve_device(args.device)
    cfg = _apply_overrides(PRESETS[args.preset], args)

    import torch

    from carel_tpu_torch.infer import run_pair_inference
    from carel_tpu_torch.pipeline import build_pipeline, init_state
    from carel_tpu_torch.train import checkpoint as ckpt
    from carel_tpu_torch.train.steps import make_eval_step

    enc = _encoder_preset(args.encoder, cfg.data.language)
    pipe = build_pipeline(cfg, cache_dir=args.cache_dir, encoder_cfg=enc,
                          max_test_docs=args.max_test_docs)
    cfg = pipe.cfg
    model = init_state(cfg, device).model
    if args.model_id:
        model.load_state_dict(ckpt.load_best(cfg.train.checkpoint_dir,
                                             args.model_id, device))
    res = run_pair_inference(
        make_eval_step(), model, pipe.test_pairs, pipe.test_arrays,
        torch.Generator(device=device).manual_seed(0),
        cfg.train.eval_batch_size, output_dir=args.output_dir,
        model_id=args.model_id or pipe.model_id)
    print(json.dumps({
        "precision": res.precision, "recall": res.recall, "f1": res.f1,
        "p50_batch_ms": res.p50_batch_ms, "p95_batch_ms": res.p95_batch_ms,
        "pairs_per_sec": res.pairs_per_sec,
    }))
    return 0


def cmd_stage1(args) -> int:
    from carel_tpu_torch.data.ecpe_format import parse_ecpe_file
    from carel_tpu_torch.data.tokenizer import build_tokenizer
    from carel_tpu_torch.device import resolve_device
    from carel_tpu_torch.stage1 import build_doc_arrays
    from carel_tpu_torch.stage1.trainer import Stage1Config, train_stage1
    from carel_tpu_torch.train.logging import JsonlLogger

    device = resolve_device(args.device)
    language = args.language or "zh"
    s1 = Stage1Config(
        language=language,
        source_domain=args.source_domain or "home",
        target_domain=args.target_domain or "education",
        training_epoch=args.epochs if args.epochs is not None else 10,
        batch_size=args.batch_size or 4,
        clause_mixer=args.clause_mixer,
        fresh_adam=not args.carried_adam,
        save_dir=args.save_dir,
    )
    d = os.path.join(args.data_root, args.doc_dir or (
        "data/ECPE_new_dataset" if language == "zh"
        else "domains/Englishnovel_multiple"))
    train_docs = parse_ecpe_file(os.path.join(d, f"{s1.source_domain}.txt"))
    test_docs = parse_ecpe_file(os.path.join(d, f"{s1.target_domain}.txt"))
    if args.max_train_docs:
        train_docs = train_docs[: args.max_train_docs]
    if args.max_test_docs:
        test_docs = test_docs[: args.max_test_docs]

    corpus = [c.text for doc in train_docs + test_docs for c in doc.clauses]
    os.makedirs(args.cache_dir, exist_ok=True)
    tokenizer = build_tokenizer(
        language, corpus,
        os.path.join(args.cache_dir, f"tokenizer_{language}.json"))
    # zh clauses lose their spaces; en clauses keep them
    strip = language == "zh"
    train_arr = build_doc_arrays(train_docs, tokenizer, s1.max_doc_len,
                                 s1.max_sen_len, strip)
    test_arr = build_doc_arrays(test_docs, tokenizer, s1.max_doc_len,
                                s1.max_sen_len, strip)

    enc = dataclasses.replace(_encoder_preset(args.encoder, language),
                              vocab_size=tokenizer.vocab_size)
    logger = JsonlLogger(args.log_dir or "emotion_logs", "stage1")
    _, best, pair_file = train_stage1(s1, enc, train_arr, test_arr,
                                      tokenizer, logger, device=device,
                                      encoder_ckpt=args.hf_encoder)
    logger.close()
    print(json.dumps({"best_f1": best[2], "pair_file": pair_file}))
    return 0


def cmd_dann(args) -> int:
    """Clause-level DANN emotion classifier (emotion_classifier.py:448-553):
    imbalanced-sampled source training + full-set pseudo-label
    self-training, with the gradient-reversal domain loss on by default
    (--no_domain_loss reproduces the reference's shipped recipe)."""
    from carel_tpu_torch.data.tokenizer import build_tokenizer
    from carel_tpu_torch.device import resolve_device
    from carel_tpu_torch.stage1.dann_driver import (DannConfig,
                                                    read_clause_data,
                                                    run_dann)
    from carel_tpu_torch.train.logging import JsonlLogger

    device = resolve_device(args.device)
    language = args.language or "zh"
    cfg = DannConfig(
        source_domain=args.source_domain or "society",
        target_domain=args.target_domain or "finance",
        doc_dir=args.doc_dir or "domains/THUCTC_multiple",
        epochs=args.epochs if args.epochs is not None else 20,
        self_iteration=(args.self_iteration
                        if args.self_iteration is not None else 5),
        self_epochs=(args.self_epochs
                     if args.self_epochs is not None else 10),
        batch_size=args.batch_size or 32,
        learning_rate=args.vae_lr if args.vae_lr is not None else 1e-5,
        domain_weight=args.domain_weight,
        max_len=args.max_len or 128,
        use_domain_loss=not args.no_domain_loss,
    )
    src, tgt = (os.path.join(args.data_root, cfg.doc_dir, f"{dom}.txt")
                for dom in (cfg.source_domain, cfg.target_domain))
    corpus = read_clause_data(src)[0] + read_clause_data(tgt)[0]
    os.makedirs(args.cache_dir, exist_ok=True)
    tokenizer = build_tokenizer(
        language, corpus,
        os.path.join(args.cache_dir, f"tokenizer_{language}.json"))
    enc = dataclasses.replace(_encoder_preset(args.encoder, language),
                              vocab_size=tokenizer.vocab_size)
    logger = JsonlLogger(args.log_dir or "emotion_logs", "dann")
    res = run_dann(cfg, enc, tokenizer, args.data_root, logger,
                   device=device, max_clauses=args.max_test_docs,
                   encoder_ckpt=args.hf_encoder)
    logger.close()
    print(json.dumps({"base": res["base"], "best": res["best"]}))
    return 0


def cmd_pair(args) -> int:
    """Plain pair classifier (pair_classifier.py / _self_chain.py), as the
    JAX CLI's ``pair`` verb: the preset's data, batch size, epochs and seed;
    threshold self-training for ``--self_iteration`` iterations (default
    0); prints {"p", "r", "f1"} of the best epoch."""
    import random

    from carel_tpu_torch.data.batching import encode_pairs
    from carel_tpu_torch.data.bow import BowVocab
    from carel_tpu_torch.data.ecpe_format import parse_ecpe_file
    from carel_tpu_torch.data.pairs import build_pairs
    from carel_tpu_torch.data.self_chain import build_pairs_self_chain
    from carel_tpu_torch.data.tokenizer import build_tokenizer
    from carel_tpu_torch.device import resolve_device
    from carel_tpu_torch.pipeline import fit_max_len, resolve_paths
    from carel_tpu_torch.train.logging import JsonlLogger
    from carel_tpu_torch.train.pair_trainer import (PairTrainerConfig,
                                                    train_pair_classifier)

    device = resolve_device(args.device)
    cfg = _apply_overrides(PRESETS[args.preset], args)
    train_path, test_path, _ = resolve_paths(cfg)
    train_docs = parse_ecpe_file(train_path)
    test_docs = parse_ecpe_file(test_path)
    if args.max_train_docs:
        train_docs = train_docs[: args.max_train_docs]
    if args.max_test_docs:
        test_docs = test_docs[: args.max_test_docs]
    builder = build_pairs_self_chain if args.self_chain else build_pairs
    train_pairs = builder(train_docs, test=False,
                          rng=random.Random(cfg.data.seed))
    test_pairs = builder(test_docs, test=True)

    corpus = [c.text for d in train_docs + test_docs for c in d.clauses]
    os.makedirs(args.cache_dir, exist_ok=True)
    tok = build_tokenizer(
        cfg.data.language, corpus,
        os.path.join(args.cache_dir, f"tokenizer_{cfg.data.language}.json"))
    bow = BowVocab.from_words([], cfg.data.language)  # unused by this model
    max_len = cfg.data.max_len or fit_max_len(
        tok, train_pairs.pairs + test_pairs.pairs)

    def enc_arrays(pair_set):
        return encode_pairs(pair_set, tok, bow, max_len,
                            sentence_pair=args.sentence_pair)

    pcfg = PairTrainerConfig(
        max_len=max_len,
        batch_size=cfg.train.batch_size,
        epochs=cfg.train.epochs,
        self_epochs=cfg.train.self_epochs,
        self_iteration=(args.self_iteration
                        if args.self_iteration is not None else 0),
        self_strategy=SelfStrategy.THRESHOLD,
        seed=cfg.train.seed)
    enc = dataclasses.replace(_encoder_preset(args.encoder, cfg.data.language),
                              vocab_size=tok.vocab_size)
    logger = JsonlLogger(cfg.train.log_dir, "pair")
    _, best = train_pair_classifier(
        pcfg, enc, enc_arrays(train_pairs), enc_arrays(test_pairs),
        test_pairs.num_unpred_emotions, test_pairs, enc_arrays, logger,
        device=device)
    logger.close()
    print(json.dumps({"p": best[0], "r": best[1], "f1": best[2]}))
    return 0


def cmd_embed(args) -> int:
    """Contrastive domain-embedder fine-tuning (the sentence-transformer
    scripts: chi/en[_ec]_sentence_transformer.py): batch-all triplet loss on
    domain labels over whole docs (--level doc) or single clauses (--level
    clause); writes the fine-tuned encoder as the port's encoder dir
    (--out), which --hf_encoder takes wherever it is accepted, and
    optionally dumps the corpus embeddings."""
    import numpy as np

    from carel_tpu_torch.data.ecpe_format import parse_ecpe_file
    from carel_tpu_torch.data.tokenizer import build_tokenizer
    from carel_tpu_torch.device import resolve_device
    from carel_tpu_torch.embeddings import (EmbedderTrainConfig,
                                            EncoderEmbedder,
                                            load_domain_docs,
                                            save_embeddings,
                                            train_domain_embedder)
    from carel_tpu_torch.models.hf_port import load_encoder_checkpoint
    from carel_tpu_torch.pretrain import save_encoder
    from carel_tpu_torch.train.logging import JsonlLogger

    device = resolve_device(args.device)
    language = args.language or "zh"
    paths = {os.path.splitext(os.path.basename(p))[0]: p
             for p in args.files}
    if args.level == "doc":
        texts, labels = load_domain_docs(paths)
    else:  # clause-level (the _ec_ script variants)
        texts, labels = [], []
        for label, (name, p) in enumerate(sorted(paths.items())):
            for doc in parse_ecpe_file(p):
                for cl in doc.clauses:
                    texts.append(
                        (cl.text_field3 or cl.text).replace(" ", "")
                        if language == "zh" else (cl.text_field3 or cl.text))
                    labels.append(label)
    if args.max_texts:
        texts, labels = texts[: args.max_texts], labels[: args.max_texts]

    os.makedirs(args.cache_dir, exist_ok=True)
    tok = build_tokenizer(
        language, texts,
        os.path.join(args.cache_dir, f"tokenizer_{language}.json"))
    enc = dataclasses.replace(_encoder_preset(args.encoder, language),
                              vocab_size=tok.vocab_size)
    ecfg = EmbedderTrainConfig(
        batch_size=args.batch_size or 32,
        epochs=args.epochs if args.epochs is not None else 9,
        max_len=args.max_len or 200)
    logger = JsonlLogger(args.log_dir or "result_logs", "embed")
    init_params = None
    if args.hf_encoder:
        enc, init_params = load_encoder_checkpoint(args.hf_encoder, enc)
    params = train_domain_embedder(ecfg, enc, tok, texts, labels,
                                   init_params=init_params, logger=logger,
                                   device=device)
    out = save_encoder(args.out, params)
    emb_path = ""
    if args.dump_embeddings:
        embedder = EncoderEmbedder(enc, params, tok, max_len=ecfg.max_len,
                                   device=device)
        emb_path = save_embeddings(args.dump_embeddings, embedder(texts),
                                   np.asarray(labels))
    logger.close()
    print(json.dumps({"encoder_ckpt": out, "texts": len(texts),
                      "embeddings": emb_path}))
    return 0


def cmd_cit(args) -> int:
    """CIT triple classifier chained onto pair-inference outputs
    (mc_classifier.py:442-547): gold triples with KNN negatives from the
    source domain, prediction-filtering evaluation on the target candidates,
    per-document KNN self-training. Reads ``infer --output_dir``'s pickles
    (pandas is imported here)."""
    import random

    import numpy as np
    import pandas as pd

    from carel_tpu_torch.data.ecpe_format import parse_ecpe_file
    from carel_tpu_torch.data.pairs import build_pairs
    from carel_tpu_torch.data.tokenizer import build_tokenizer
    from carel_tpu_torch.data.triples import build_cit_triples
    from carel_tpu_torch.device import resolve_device
    from carel_tpu_torch.embeddings import EncoderEmbedder
    from carel_tpu_torch.models.hf_port import load_encoder_checkpoint
    from carel_tpu_torch.pipeline import _spaced_sep, fit_max_len, resolve_paths
    from carel_tpu_torch.train.cit_trainer import CitConfig, run_cit
    from carel_tpu_torch.train.logging import JsonlLogger

    device = resolve_device(args.device)
    cfg = _apply_overrides(PRESETS[args.preset], args)
    train_path, test_path, _ = resolve_paths(cfg)
    train_docs = parse_ecpe_file(train_path)
    test_docs = parse_ecpe_file(test_path)
    if args.max_train_docs:
        train_docs = train_docs[: args.max_train_docs]
    if args.max_test_docs:
        test_docs = test_docs[: args.max_test_docs]
    test_pairs = build_pairs(test_docs, test=True,
                             spaced_sep=_spaced_sep(cfg),
                             rng=random.Random(cfg.data.seed))

    # prediction/true tables from `infer --output_dir` (the reference reads
    # pair_data/ec_pair/{id}_{true,pred}.pkl, mc_classifier.py:462-470)
    pred_df = pd.read_pickle(args.pred_pkl)
    true_df = pd.read_pickle(args.true_pkl)
    pair_texts = [str(t) for t in pred_df["pair"]]
    pred_labels = np.asarray(pred_df["label"], np.float32)
    true_labels = np.asarray(true_df["label"], np.float32)
    if len(pred_labels) != sum(test_pairs.docs_pair_size):
        raise SystemExit(
            f"prediction table has {len(pred_labels)} rows but the test "
            f"candidate enumeration has {sum(test_pairs.docs_pair_size)}: "
            "pass the same --preset/--test_file/--max_test_docs used for "
            "`infer`")

    corpus = [c.text for d in train_docs + test_docs for c in d.clauses]
    os.makedirs(args.cache_dir, exist_ok=True)
    tok = build_tokenizer(
        cfg.data.language, corpus,
        os.path.join(args.cache_dir, f"tokenizer_{cfg.data.language}.json"))
    enc = dataclasses.replace(_encoder_preset(args.encoder, cfg.data.language),
                              vocab_size=tok.vocab_size)

    # embedder for the KNN negatives: the port's encoder (the checkpoint's
    # when given, else random weights from seed 0) in place of the
    # reference's downloaded SimCSE (mc_classifier.py:120-144)
    enc_params = None
    if args.hf_encoder:
        enc, enc_params = load_encoder_checkpoint(args.hf_encoder, enc)
    embedder = EncoderEmbedder(enc, enc_params, tok, max_len=64,
                               device=device)

    max_len = cfg.data.max_len or fit_max_len(tok, pair_texts)
    ccfg = CitConfig(
        max_len=max_len,
        batch_size=args.batch_size or 32,
        epochs=args.epochs if args.epochs is not None else 1,
        self_epochs=(args.self_epochs
                     if args.self_epochs is not None else 5),
        self_iteration=(args.self_iteration
                        if args.self_iteration is not None else 10),
        learning_rate=args.vae_lr if args.vae_lr is not None else 1e-5,
        seed=cfg.train.seed)
    logger = JsonlLogger(args.log_dir or "result_logs", "cit")
    train_triples = build_cit_triples(train_docs, embedder)
    res = run_cit(ccfg, enc, tok, train_triples, test_docs,
                  test_pairs.docs_pair_size, pair_texts, pred_labels,
                  true_labels, embedder, logger, encoder_params=enc_params,
                  device=device)
    logger.close()
    print(json.dumps({"base": res["base"], "best": res["best"]}))
    return 0


def cmd_original(args) -> int:
    """Original 3-latent DRL trainer end to end (drl_classifier.py:802-1041;
    --bow_loss = drl_classifier_bow_loss.py's learned BoW re-weighting), on
    the old split's zh defaults (society -> pair_data/emotion/finance.txt,
    drl_classifier.py:995-999)."""
    import uuid

    from carel_tpu_torch.device import resolve_device
    from carel_tpu_torch.train.logging import JsonlLogger
    from carel_tpu_torch.train.original_driver import run_original
    from carel_tpu_torch.train.steps_original import OriginalLossConfig

    device = resolve_device(args.device)
    base = PRESETS["ec_mmd_final_mul"]
    base = dataclasses.replace(base, data=dataclasses.replace(
        base.data, source_domain="society", target_domain="finance"))
    cfg = _apply_overrides(base, args)
    loss_cfg = OriginalLossConfig(
        learned_bow_weights=args.bow_loss,
        con_mul_loss_weight=args.con_mul_loss_weight,
        pair_mul_loss_weight=args.pair_mul_loss_weight,
        vae_lr=cfg.train.vae_lr,
    )
    enc = _encoder_preset(args.encoder, cfg.data.language)
    model_id = str(uuid.uuid4())
    logger = JsonlLogger(cfg.train.log_dir, f"drl_original_{model_id[:8]}")
    _, base_best, self_best = run_original(
        cfg, loss_cfg, enc, model_id, cache_dir=args.cache_dir,
        logger=logger, max_train_docs=args.max_train_docs,
        max_test_docs=args.max_test_docs, device=device)
    logger.close()
    final = self_best if self_best[2] > 0.0 else base_best
    print(json.dumps({"model_id": model_id, "best_f1": final[2],
                      "base_f1": base_best[2]}))
    return 0


def cmd_pretrain(args) -> int:
    """MLM pretraining (pretrain/mlm.py): an encoder from the local corpora
    where the reference's hub downloads are impossible; ``--out`` is the
    port's encoder dir, which every ``--hf_encoder`` reads (with the same
    ``--cache_dir``, so the corpus tokenizer matches). ``--save_mlm`` also
    writes the whole MLM (for ``ordering --mlm_model``) and pins its
    tokenizer beside it as ``<dir>.tokenizer.json``."""
    from carel_tpu_torch.data.ecpe_format import (parse_ecpe_file,
                                                  split_raw_corpus)
    from carel_tpu_torch.data.tokenizer import build_tokenizer
    from carel_tpu_torch.device import resolve_device
    from carel_tpu_torch.pipeline import resolve_paths
    from carel_tpu_torch.pretrain import (MlmConfig, load_encoder,
                                          pretrain_mlm, save_encoder)
    from carel_tpu_torch.train.logging import JsonlLogger

    device = resolve_device(args.device)
    cfg = _apply_overrides(PRESETS[args.preset], args)
    _, _, bow_path = resolve_paths(cfg)
    corpus_paths = list(args.corpus) if args.corpus else [bow_path]
    texts = []
    for cp in corpus_paths:
        for d in parse_ecpe_file(cp):
            texts.extend(c.text for c in d.clauses)
    if cfg.data.language == "zh":
        texts = [t.strip().replace(" ", "") for t in texts]
    for rp in (args.raw_corpus or []):
        texts.extend(split_raw_corpus(rp, cfg.data.language))
    os.makedirs(args.cache_dir, exist_ok=True)
    tok = build_tokenizer(
        cfg.data.language, texts,
        os.path.join(args.cache_dir, f"tokenizer_{cfg.data.language}.json"))
    if args.save_mlm:
        # the tokenizer the MLM was trained with, beside its dir, so that
        # `ordering --mlm_model` never pairs it with another vocabulary
        if os.path.dirname(args.save_mlm):
            os.makedirs(os.path.dirname(args.save_mlm), exist_ok=True)
        tok.save(args.save_mlm.rstrip("/") + ".tokenizer.json")
    enc = dataclasses.replace(_encoder_preset(args.encoder,
                                              cfg.data.language),
                              vocab_size=tok.vocab_size)
    logger = JsonlLogger(cfg.train.log_dir, "pretrain")
    logger.log({"event": "pretrain_config", "corpus": corpus_paths,
                "raw_corpus": list(args.raw_corpus or []),
                "clauses": len(texts), "vocab": tok.vocab_size,
                "steps": args.steps})
    mlm_cfg = MlmConfig(batch_size=args.mlm_batch, seq_len=args.seq_len,
                        steps=args.steps, learning_rate=args.mlm_lr,
                        seed=cfg.train.seed, scan_size=args.scan_size,
                        mask_prob=args.mask_prob,
                        whole_word=args.whole_word,
                        language=cfg.data.language,
                        lr_decay=args.lr_decay,
                        warmup_steps=args.warmup_steps,
                        save_every=args.save_every, save_path=args.out,
                        save_full_path=args.save_mlm)
    # resume from an encoder dir of this corpus (same tokenizer, same
    # shapes; a mismatch raises in load_state_dict)
    init_params = load_encoder(args.init_encoder) if args.init_encoder \
        else None
    segmenter = None
    if args.whole_word and cfg.data.language == "zh":
        # jieba's words of the corpus files, through their cache
        from carel_tpu_torch.data.bow import open_segmentation

        segmenter = open_segmentation(
            args.cache_dir, corpus_paths + list(args.raw_corpus or []))
    params = pretrain_mlm(enc, tok, texts, mlm_cfg, logger,
                          init_params=init_params, device=device,
                          segmenter=segmenter)
    if segmenter is not None:
        segmenter.save()
    path = save_encoder(args.out, params)
    logger.close()
    print(json.dumps({"encoder_ckpt": path, "clauses": len(texts)}))
    return 0


def cmd_case_analysis(args) -> int:
    """Two best checkpoints of one preset scored on its test set and split
    by self-chain (mmd_wommd_case_analysis.py); writes ``--out_csv``."""
    import torch

    from carel_tpu_torch.data.ecpe_format import parse_ecpe_file
    from carel_tpu_torch.device import resolve_device
    from carel_tpu_torch.pipeline import (build_pipeline, init_state,
                                          resolve_paths)
    from carel_tpu_torch.tools.case_analysis import compare_checkpoints
    from carel_tpu_torch.train import checkpoint as ckpt
    from carel_tpu_torch.train.steps import make_eval_step

    device = resolve_device(args.device)
    cfg = _apply_overrides(PRESETS[args.preset], args)
    enc = _encoder_preset(args.encoder, cfg.data.language)
    pipe = build_pipeline(cfg, cache_dir=args.cache_dir, encoder_cfg=enc,
                          max_test_docs=args.max_test_docs)
    cfg = pipe.cfg
    model = init_state(cfg, device).model
    pa = ckpt.load_best(cfg.train.checkpoint_dir, args.model_id_a, device)
    pb = ckpt.load_best(cfg.train.checkpoint_dir, args.model_id_b, device)
    _, test_path, _ = resolve_paths(cfg)
    docs = parse_ecpe_file(test_path)
    if args.max_test_docs:
        docs = docs[: args.max_test_docs]
    res = compare_checkpoints(
        make_eval_step(), model, pa, pb, pipe.test_pairs, pipe.test_arrays,
        docs, args.out_csv, torch.Generator(device=device).manual_seed(0),
        cfg.train.eval_batch_size)
    print(json.dumps({
        "model_a_f1": res.model_a_f1, "model_b_f1": res.model_b_f1,
        "csv": res.csv_path,
        "self_chain": res.self_chain_counts, "normal": res.normal_counts,
        "split_f1": res.split_f1,
    }))
    return 0


def hpo_objective(pipe, device, logger=None):
    """The ``hpo`` verb's objective: a trial's config (with the pipeline's
    model) trains from a fresh ``init_state`` through ``train_epochs`` one
    epoch at a time, the state and the shuffle carried from epoch to
    epoch, and reports its best pair-F1 after each epoch. (JAX's objective
    hands every epoch the initial state again, ROADMAP Queue 3.) Each trial
    starts without the last trial's best checkpoint."""
    import numpy as np

    from carel_tpu_torch.pipeline import init_state
    from carel_tpu_torch.train import checkpoint as ckpt
    from carel_tpu_torch.train.loop import train_epochs
    from carel_tpu_torch.train.scan_epoch import make_epoch_step
    from carel_tpu_torch.train.steps import make_eval_step, make_train_step

    def objective(cfg, report):
        cfg = dataclasses.replace(cfg, model=pipe.cfg.model)
        best_path = ckpt.best_path(cfg.train.checkpoint_dir, pipe.model_id)
        if os.path.exists(best_path):
            os.remove(best_path)
        state = init_state(cfg, device)
        train_step = (make_epoch_step(cfg) if cfg.train.scan_epoch
                      else make_train_step(cfg))
        eval_step = make_eval_step()
        data_rng = np.random.default_rng(cfg.train.seed)
        best_cache: dict = {}
        best_f1 = 0.0
        for epoch in range(cfg.train.epochs):
            state, best = train_epochs(
                cfg, state, train_step, eval_step, pipe.train_arrays,
                pipe.test_arrays, pipe.num_unpred_pairs, pipe.model_id,
                epochs=1, logger=logger, data_rng=data_rng,
                best_f1_so_far=best_f1, best_cache=best_cache)
            best_f1 = max(best_f1, best[2])
            report(epoch, best_f1)
        return best_f1

    return objective


def cmd_hpo(args) -> int:
    """Random search with median pruning over the loss weights and vae_lr
    (tools/hpo.py), the objective the best pair-F1 of a short training run
    (drl_classifier_search.py's search with a working engine)."""
    from carel_tpu_torch.device import resolve_device
    from carel_tpu_torch.pipeline import build_pipeline
    from carel_tpu_torch.tools.hpo import DEFAULT_SPACE, search
    from carel_tpu_torch.train.logging import JsonlLogger

    device = resolve_device(args.device)
    base = _apply_overrides(PRESETS[args.preset], args)
    enc = _encoder_preset(args.encoder, base.data.language)
    pipe = build_pipeline(base, cache_dir=args.cache_dir, encoder_cfg=enc,
                          max_train_docs=args.max_train_docs,
                          max_test_docs=args.max_test_docs)
    logger = JsonlLogger(base.train.log_dir or "result_logs", "hpo")
    best, trials = search(hpo_objective(pipe, device, logger), base,
                          DEFAULT_SPACE, args.n_trials, logger=logger)
    logger.close()
    print(json.dumps({"best_value": best.value if best else None,
                      "best_params": best.params if best else None,
                      "trials": len(trials)}))
    return 0


def cmd_convert(args) -> int:
    """Dataset conversion (tools/convert.py), on the host."""
    from carel_tpu_torch.tools import convert as cv

    if args.kind == "reccon":
        cv.reccon_to_ecpe(args.source[0], args.target,
                          minusone=args.minusone,
                          bow_optimize=args.bow_optimize)
    elif args.kind == "train_to_test":
        cv.convert_train_to_test(args.source[0], args.target,
                                 args.bow_optimize)
    elif args.kind == "json_split":
        cv.json_to_ecpe_split(args.source[0], args.target)
    elif args.kind == "bow_concat":
        cv.concat_bow_corpus(list(args.source), args.target)
    print(json.dumps({"written": args.target}))
    return 0


def cmd_ordering(args) -> int:
    """Temporal-order statistics of a file's gold pairs and, with
    ``--mlm_model``, the directional comparison by the MLM scorer
    (tools/mlm_scorer.py) on ``--device`` (``--cpu`` as in JAX)."""
    from carel_tpu_torch.data.ecpe_format import parse_ecpe_file
    from carel_tpu_torch.tools.ordering import ordering_probe

    scorer = None
    if args.mlm_model:
        from carel_tpu_torch.data.tokenizer import build_tokenizer
        from carel_tpu_torch.tools.mlm_scorer import MlmScorer

        # the tokenizer must be the one the MLM was trained with: a rebuilt
        # one can share the vocab size yet permute the ids. The copy pinned
        # beside the dir by `pretrain --save_mlm`, else the training cache;
        # never a rebuild
        tok_candidates = [
            args.mlm_model.rstrip("/") + ".tokenizer.json",
            os.path.join(args.cache_dir, f"tokenizer_{args.language}.json"),
        ]
        tok_path = next((p for p in tok_candidates if os.path.exists(p)),
                        None)
        if tok_path is None:
            raise SystemExit(
                "ordering --mlm_model: no tokenizer found at "
                f"{tok_candidates}; pass --cache_dir pointing at the cache "
                "the MLM was pretrained with (rebuilding from the probe "
                "file would silently mis-map token ids)")
        tok = build_tokenizer(args.language, None, tok_path)
        enc = dataclasses.replace(_encoder_preset(args.encoder,
                                                  args.language),
                                  vocab_size=tok.vocab_size)
        scorer = MlmScorer(args.mlm_model, tok, enc,
                           device="cpu" if args.cpu else args.device)

    stats = ordering_probe(parse_ecpe_file(args.file),
                           entailment_scorer=scorer)
    print(json.dumps(ordering_summary(stats, scorer is not None)))
    return 0


def ordering_summary(stats, scored: bool) -> dict:
    """The ordering verb's JSON of an ``OrderingStats``; ``scored`` adds
    the directional comparison's counts."""
    out = {
        "total_pairs": stats.total_pairs,
        "cause_before": stats.cause_before,
        "cause_equal": stats.cause_equal,
        "cause_after": stats.cause_after,
        "temporal_order_rate": stats.temporal_order_rate,
    }
    if scored:
        out.update({"scored_pairs": stats.scored_pairs,
                    "forward_wins": stats.forward_wins,
                    "backward_wins": stats.backward_wins})
    return out


def cmd_vis(args) -> int:
    """Domain-shift scatter plot of ECPE files (tools/vis.py), one domain
    label a file; sklearn and matplotlib are imported here."""
    from carel_tpu_torch.data.ecpe_format import parse_ecpe_file
    from carel_tpu_torch.tools.vis import visualize_domain_shift

    texts, labels = [], []
    for path in args.files:
        name = os.path.splitext(os.path.basename(path))[0]
        for doc in parse_ecpe_file(path):
            texts.append(" ".join(c.text.strip() for c in doc.clauses))
            labels.append(name)
    out = visualize_domain_shift(texts, labels, args.out, method=args.method)
    print(json.dumps({"written": out, "docs": len(texts)}))
    return 0


def cmd_bench(args) -> int:
    """The flagship's train-step throughput on ``--device``
    (``carel_tpu_torch/bench.py``): one JSON line."""
    from carel_tpu_torch import bench

    bench.main(device=args.device)
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
    _add_common_args(p_train)
    _add_train_args(p_train)
    p_train.set_defaults(fn=cmd_train)
    p_inf = sub.add_parser("infer", help="batched pair inference")
    _add_common_args(p_inf)
    p_inf.add_argument("--model_id", default="")
    p_inf.add_argument("--output_dir", default="")
    p_inf.set_defaults(fn=cmd_infer)
    p_s1 = sub.add_parser("stage1", help="doc-level emotion + pair files")
    _add_common_args(p_s1)
    p_s1.add_argument("--clause_mixer", default="bilstm",
                      choices=["bilstm", "transformer"])
    p_s1.add_argument("--carried_adam", action="store_true",
                      help="use a standard carried Adam instead of the "
                           "reference's fresh-Adam-per-step quirk")
    p_s1.add_argument("--save_dir", default="",
                      help="pair-file directory (default pair_data/"
                           "predicted_emotion/source_<source_domain>)")
    p_s1.add_argument("--doc_dir", default="",
                      help="override the doc-file directory (e.g. "
                           "domains/THUCTC_multiple for the zh old split)")
    p_s1.set_defaults(fn=cmd_stage1)
    p_dann = sub.add_parser(
        "dann", help="clause-level DANN emotion classifier "
                     "(emotion_classifier.py)")
    _add_common_args(p_dann)
    p_dann.add_argument("--doc_dir", default="",
                        help="domain-file dir under data_root "
                             "(default domains/THUCTC_multiple)")
    p_dann.add_argument("--domain_weight", type=float, default=3.0,
                        help="GRL lambda (reference default 3)")
    p_dann.add_argument("--no_domain_loss", action="store_true",
                        help="drop the adversarial domain term, exactly "
                             "like the reference's shipped train loop")
    p_dann.set_defaults(fn=cmd_dann)
    p_pair = sub.add_parser("pair", help="plain (non-VAE) pair classifier")
    _add_common_args(p_pair)
    p_pair.add_argument("--sentence_pair", action="store_true",
                        help="two-segment encoding (self-chain variant)")
    p_pair.set_defaults(fn=cmd_pair)
    p_emb = sub.add_parser(
        "embed", help="contrastive domain-embedder fine-tuning "
                      "(sentence-transformer scripts)")
    _add_common_args(p_emb)
    p_emb.add_argument("--files", required=True, nargs="+",
                       help="ECPE domain files; each file = one domain label")
    p_emb.add_argument("--level", default="doc", choices=["doc", "clause"],
                       help="doc = chi/en_sentence_transformer, clause = "
                            "the _ec_ variants")
    p_emb.add_argument("--out", required=True,
                       help="output dir for the fine-tuned encoder "
                            "(encoder.pt)")
    p_emb.add_argument("--dump_embeddings", default="",
                       help="optional .npz path for the corpus embeddings")
    p_emb.add_argument("--max_texts", type=int, default=0)
    p_emb.set_defaults(fn=cmd_embed)
    p_cit = sub.add_parser(
        "cit", help="CIT triple classifier over pair-inference outputs "
                    "(mc_classifier.py)")
    _add_common_args(p_cit)
    p_cit.add_argument("--pred_pkl", required=True,
                       help="{id}_pred.pkl from `infer --output_dir`")
    p_cit.add_argument("--true_pkl", required=True,
                       help="{id}_true.pkl from `infer --output_dir`")
    p_cit.set_defaults(fn=cmd_cit)
    p_orig = sub.add_parser(
        "original", help="original 3-latent DRL trainer (drl_classifier.py; "
                         "--bow_loss = drl_classifier_bow_loss.py)")
    _add_common_args(p_orig)
    p_orig.add_argument("--bow_loss", action="store_true",
                        help="learned BoW re-weighting (content classifier "
                             "sigmoid as detached per-word BCE weights)")
    p_orig.add_argument("--con_mul_loss_weight", type=float, default=3.0,
                        help="content multitask loss weight "
                             "(drl_classifier.py:46; sweep axis of the "
                             "bow_loss variant)")
    p_orig.add_argument("--pair_mul_loss_weight", type=float, default=30.0,
                        help="pair loss weight (the weights=[...] sweep at "
                             "drl_classifier.py:966)")
    p_orig.set_defaults(fn=cmd_original)
    p_mlm = sub.add_parser("pretrain",
                           help="MLM-pretrain the encoder on a corpus")
    _add_common_args(p_mlm)
    p_mlm.add_argument("--corpus", default="", nargs="*",
                       help="ECPE corpus paths (default: the preset's bow "
                            "corpus)")
    p_mlm.add_argument("--raw_corpus", default="", nargs="*",
                       help="plain-text corpus paths, split into sentence "
                            "segments")
    p_mlm.add_argument("--scan_size", type=int, default=50,
                       help="steps a dispatch (a captured step replayed)")
    p_mlm.add_argument("--out", required=True,
                       help="output dir for the encoder (encoder.pt)")
    p_mlm.add_argument("--steps", type=int, default=2000)
    p_mlm.add_argument("--seq_len", type=int, default=64)
    p_mlm.add_argument("--mlm_batch", type=int, default=256)
    p_mlm.add_argument("--mlm_lr", type=float, default=1e-4)
    p_mlm.add_argument("--mask_prob", type=float, default=0.15,
                       help="MLM masking ratio")
    p_mlm.add_argument("--whole_word", action="store_true",
                       help="whole-word masking (jieba words for zh, "
                            "WordPiece words for en)")
    p_mlm.add_argument("--lr_decay", action="store_true",
                       help="cosine decay to 10%% of peak over --steps")
    p_mlm.add_argument("--warmup_steps", type=int, default=200)
    p_mlm.add_argument("--init_encoder", default="",
                       help="encoder dir (encoder.pt) to resume from")
    p_mlm.add_argument("--save_every", type=int, default=0,
                       help="snapshot the encoder every N steps")
    p_mlm.add_argument("--save_mlm", default="",
                       help="also save the full MLM (encoder + head) here, "
                            "for `ordering --mlm_model`")
    p_mlm.set_defaults(fn=cmd_pretrain)
    p_case = sub.add_parser("case_analysis",
                            help="compare two checkpoints (mmd vs ablation)")
    _add_common_args(p_case)
    p_case.add_argument("--model_id_a", required=True)
    p_case.add_argument("--model_id_b", required=True)
    p_case.add_argument("--out_csv", default="wommd_mmd_fin.csv")
    p_case.set_defaults(fn=cmd_case_analysis)
    p_hpo = sub.add_parser("hpo", help="hyperparameter search")
    _add_common_args(p_hpo)
    p_hpo.add_argument("--n_trials", type=int, default=20)
    p_hpo.set_defaults(fn=cmd_hpo)
    p_conv = sub.add_parser("convert", help="dataset conversion tools")
    p_conv.add_argument("kind", choices=["reccon", "train_to_test",
                                         "json_split", "bow_concat"])
    p_conv.add_argument("--source", required=True, nargs="+")
    p_conv.add_argument("--target", required=True)
    p_conv.add_argument("--bow_optimize", action="store_true")
    p_conv.add_argument("--minusone", action="store_true")
    p_conv.set_defaults(fn=cmd_convert)
    p_ord = sub.add_parser("ordering", help="temporal-order probe")
    p_ord.add_argument("--file", required=True)
    p_ord.add_argument("--mlm_model", default="",
                       help="MLM dir (pretrain --save_mlm) enabling the "
                            "directional entailment comparison")
    p_ord.add_argument("--encoder", default="base")
    p_ord.add_argument("--language", default="zh")
    p_ord.add_argument("--cache_dir", default="cache")
    p_ord.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                       help="where the MLM scores (the GPU by default)")
    p_ord.add_argument("--cpu", action="store_true",
                       help="score on the CPU (--device cpu)")
    p_ord.set_defaults(fn=cmd_ordering)
    p_vis = sub.add_parser("vis", help="domain-shift visualization")
    p_vis.add_argument("--files", required=True, nargs="+",
                       help="ECPE files; one domain label per file")
    p_vis.add_argument("--out", default="domains.png")
    p_vis.add_argument("--method", default="pca",
                       choices=["pca", "tsne", "lda"],
                       help="lda = supervised LinearDiscriminant projection "
                            "by domain")
    p_vis.set_defaults(fn=cmd_vis)
    p_pre = sub.add_parser("presets", help="list presets")
    p_pre.set_defaults(fn=cmd_presets)
    p_bench = sub.add_parser("bench", help="train-step throughput")
    p_bench.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                         help="run on the GPU (default) or, when asked, "
                              "the CPU")
    p_bench.set_defaults(fn=cmd_bench)
    return parser


def main(argv: Optional[list] = None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
