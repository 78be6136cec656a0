"""The port's host loop and CLI: metrics against the JAX package, CPU runs
of ``python -m carel_tpu_torch.cli train`` on synthetic zh corpora (the
flagship in the newsplit layout, ec_hsic in the old-split layout), through
base training, evaluation and self-training with the default epoch step,
--no_scan_epoch and --debug_nans, train_epochs giving the same bits with
either kind of step, and the entry points' refusal to fall back to the
CPU."""

import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from carel_tpu.train.metrics import prf_with_forced_misses as j_prf

from carel_tpu_torch.cli.main import main
from carel_tpu_torch.config import CarelConfig, DataConfig, ModelConfig
from carel_tpu_torch.config import TrainConfig
from carel_tpu_torch.data.batching import PairArrays
from carel_tpu_torch.models.encoder import tiny_encoder_config
from carel_tpu_torch.pipeline import init_state
from carel_tpu_torch.train.loop import train_epochs
from carel_tpu_torch.train.metrics import prf_with_forced_misses
from carel_tpu_torch.train.steps import make_eval_step, make_train_step
from tests.test_torch_data import write_newsplit_corpus, write_oldsplit_corpus

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("num_unpred", [0, 7])
def test_prf_with_forced_misses_matches_jax(num_unpred):
    rng = np.random.default_rng(num_unpred)
    labels = rng.integers(0, 2, 200).astype(np.float32)
    probs = rng.random(200).astype(np.float32)
    probs[:20] = 0.5  # half-to-even rounding sends these to 0
    probs[20:30] = np.float32(0.5) + np.finfo(np.float32).eps
    assert prf_with_forced_misses(labels, probs, num_unpred) == \
        j_prf(labels, probs, num_unpred)


def _train_args(root, tmp):
    return ["train", "--preset", "ec_mmd_final_mul_newsplit_emnlp",
            "--data_root", str(root), "--encoder", "tiny", "--epochs", "1",
            "--batch_size", "16", "--self_iteration", "0",
            "--cache_dir", str(tmp / "cache"),
            "--checkpoint_dir", str(tmp / "ckpt"),
            "--log_dir", str(tmp / "logs")]


def test_cli_train_runs_on_cpu(tmp_path):
    root = tmp_path / "corpus"
    write_newsplit_corpus(str(root))
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run(
        [sys.executable, "-m", "carel_tpu_torch.cli",
         *_train_args(root, tmp_path), "--device", "cpu"],
        cwd=str(tmp_path), env=env, capture_output=True, text=True,
        timeout=600)
    assert res.returncode == 0, res.stdout + res.stderr
    summary = json.loads(res.stdout.strip().splitlines()[-1])
    assert 0.0 <= summary["best_f1"] <= 1.0
    assert summary["base_f1"] == summary["best_f1"]
    logs = list((tmp_path / "logs").glob("*.jsonl"))
    events = [json.loads(line)["event"] for line in logs[0].read_text()
              .splitlines()]
    assert "eval" in events and events[-1] == "base_done"
    if summary["best_f1"] > 0:
        assert (tmp_path / "ckpt" / f"{summary['model_id']}_best.pt").exists()


@pytest.mark.parametrize("preset", ["ec_mmd_final_mul_newsplit_emnlp",
                                    "ec_hsic"])
def test_train_without_device_flag_needs_a_gpu(tmp_path, monkeypatch,
                                               preset):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = _train_args(tmp_path / "corpus", tmp_path)
    args[args.index("--preset") + 1] = preset
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(args)
    assert not (tmp_path / "cache").exists()  # raised before any work


def _self_train_run(tmp_path, capsys, preset, write_corpus, iterations,
                    extra=()):
    """train --self_iteration N in this process; returns the JSON summary
    and the logged events."""
    root = tmp_path / "corpus"
    write_corpus(str(root))
    args = _train_args(root, tmp_path)
    args[args.index("--preset") + 1] = preset
    args[args.index("--self_iteration") + 1] = str(iterations)
    assert main(args + ["--self_epochs", "1", "--device", "cpu",
                        "--track_memorization", *extra]) == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    logs = list((tmp_path / "logs").glob("*.jsonl"))
    assert len(logs) == 1
    events = [json.loads(line) for line in logs[0].read_text().splitlines()]
    names = [e["event"] for e in events]
    base = names.index("base_done")
    assert names[0] == "config" and "eval" in names[:base]
    assert names.count("selftrain_iter") == iterations
    assert names.count("selftrain_best") == iterations
    assert names.count("memorization") == iterations
    assert names[-1] == "self_done"
    # one fine-tune epoch per iteration, each with its own evaluation
    assert names[base:].count("eval") == iterations
    for e in events:
        if e["event"] == "selftrain_iter":
            assert e["pseudo_pairs"] > 0 and e["pseudo_pairs"] % 2 == 0
    assert 0.0 <= summary["base_f1"] <= 1.0
    assert summary["best_f1"] == events[-1]["f1"]
    return summary, events


def test_cli_train_hsic_self_trains_on_cpu(tmp_path, capsys):
    """ec_hsic: zh old split (society_num -> education), binary emotion,
    HSIC regularizer, random strategy; two self-training iterations."""
    _, events = _self_train_run(tmp_path, capsys, "ec_hsic",
                                write_oldsplit_corpus, 2)
    config = events[0]
    assert config["test_pairs"] > 0 and config["num_unpred"] > 0


def test_cli_train_flagship_self_trains_on_cpu(tmp_path, capsys):
    """The flagship with temporal_order_modification, one iteration, with
    --self_lr and --self_anchor_base: the best then starts from the base."""
    summary, _ = _self_train_run(
        tmp_path, capsys, "ec_mmd_final_mul_newsplit_emnlp",
        write_newsplit_corpus, 1, ("--self_lr", "5e-4", "--self_anchor_base"))
    assert summary["best_f1"] >= summary["base_f1"]


def test_presets_lists_all(capsys):
    assert main(["presets"]) == 0
    out = capsys.readouterr().out
    for name in ["ec_mmd_final_mul_newsplit_emnlp", "ec_gan", "ec_vi_final",
                 "ec_hsic", "ec_none", "drl_en", "en_newsplit"]:
        assert name in out


def _pair_arrays(rng, n, L=12, vocab=64, bow_dim=40):
    mask = np.ones((n, L), np.int32)
    idx = rng.integers(0, bow_dim, (n, 4)).astype(np.int32)
    return PairArrays(
        input_ids=rng.integers(2, vocab, (n, L)).astype(np.int32),
        attention_mask=mask, token_type_ids=np.zeros((n, L), np.int32),
        pair_labels=(np.arange(n) % 2).astype(np.float32),
        emotion_labels=rng.integers(0, 6, n).astype(np.int32),
        temporal_order=np.zeros(n, bool), bow_indices=idx,
        bow_weights=np.full((n, 4), 0.25, np.float32))


@pytest.mark.parametrize("use_cache", [True, False])
def test_train_epochs_reloads_the_best_params(tmp_path, use_cache):
    """Epoch 2 of 3 scores best; after the loop the model holds exactly the
    params that epoch 2 evaluated, from the in-memory cache or from disk."""
    cfg = CarelConfig(
        model=ModelConfig(encoder=tiny_encoder_config(vocab_size=64),
                          ec_dim=8, bow_dim=40),
        data=DataConfig(max_len=12),
        train=TrainConfig(batch_size=8, epochs=3, vae_lr=1e-3,
                          checkpoint_dir=str(tmp_path / "ckpt")))
    rng = np.random.default_rng(0)
    train, test = _pair_arrays(rng, 20), _pair_arrays(rng, 10)
    state = init_state(cfg, "cpu")
    seen = []

    def scripted_eval(model, batch, generator):
        seen.append({k: v.clone() for k, v in model.state_dict().items()})
        labels = batch["pair_labels"]
        return [torch.ones_like(labels), labels,
                torch.zeros_like(labels)][len(seen) - 1]

    state, best = train_epochs(cfg, state, make_train_step(cfg),
                               scripted_eval, train, test, 0, "m",
                               best_cache={} if use_cache else None)
    assert best == (1.0, 1.0, 1.0)
    final = state.model.state_dict()
    for k, v in seen[1].items():
        assert torch.equal(final[k], v), k
    assert any(not torch.equal(seen[2][k], v) for k, v in seen[1].items())
    assert (tmp_path / "ckpt" / "m_best.pt").exists()


@pytest.mark.parametrize("flag", ["", "--no_scan_epoch", "--debug_nans"])
def test_cli_trains_with_either_step(tmp_path, capsys, flag):
    """ec_hsic trains and self-trains through the epoch step by default and
    through the per-step loop under --no_scan_epoch or --debug_nans: the
    epoch step logs one train record an epoch, of all its batches."""
    _, events = _self_train_run(tmp_path, capsys, "ec_hsic",
                                write_oldsplit_corpus, 2,
                                (flag,) if flag else ())
    assert events[0]["epoch_step"] == (flag == "")
    train = [e for e in events if e["event"] == "train"]
    if flag == "":
        pairs = [events[0]["train_pairs"]] + [
            e["pseudo_pairs"] for e in events
            if e["event"] == "selftrain_iter"]
        assert [e["it"] for e in train] == [-(-n // 16) for n in pairs]
    else:
        assert all(e["it"] % 10 == 0 for e in train)


@pytest.mark.parametrize("reg", ["mmd", "vi"])
def test_train_epochs_takes_either_step(tmp_path, reg):
    """Two epochs of train_epochs (vi_beta ramps between them, the KL
    weight within them) through the epoch step and through the prefetched
    per-step loop give the same bits and the same evaluations."""
    from carel_tpu_torch.config import LossConfig, Regularizer
    from carel_tpu_torch.train.scan_epoch import make_epoch_step

    cfg = CarelConfig(
        model=ModelConfig(encoder=tiny_encoder_config(vocab_size=64),
                          ec_dim=8, bow_dim=40),
        loss=LossConfig(regularizer=Regularizer(reg), kl_ann_iterations=4,
                        vi_beta_step=0.25),
        data=DataConfig(max_len=12),
        train=TrainConfig(batch_size=8, epochs=2, vae_lr=1e-3,
                          checkpoint_dir=str(tmp_path / "ckpt")))
    rng = np.random.default_rng(0)
    train, test = _pair_arrays(rng, 45), _pair_arrays(rng, 10)
    runs = []
    for step in (make_epoch_step(cfg), make_train_step(cfg)):
        records = []

        class Logger:
            def log(self, record):
                records.append(record)

        state = init_state(cfg, "cpu")
        evals = []

        def eval_step(model, batch, generator):
            probs = make_eval_step()(model, batch, generator)
            evals.append(probs)
            return probs

        state, best = train_epochs(cfg, state, step, eval_step, train, test,
                                   0, f"m{len(runs)}", logger=Logger())
        runs.append((state, best, evals, records))
    (a, best_a, evals_a, rec_a), (b, best_b, evals_b, rec_b) = runs
    assert best_a == best_b and a.step == b.step == 12
    assert all(torch.equal(x, y) for x, y in zip(evals_a, evals_b))
    for k, v in b.model.state_dict().items():
        assert torch.equal(a.model.state_dict()[k], v), k
    assert [(r["epoch"], r["it"]) for r in rec_a if r["event"] == "train"] \
        == [(1, 6), (2, 6)]
    assert [r["it"] for r in rec_b if r["event"] == "train"] == []
    for r_a, r_b in zip([r for r in rec_a if r["event"] == "eval"],
                        [r for r in rec_b if r["event"] == "eval"]):
        assert (r_a["f1"], r_a["precision"]) == (r_b["f1"], r_b["precision"])
