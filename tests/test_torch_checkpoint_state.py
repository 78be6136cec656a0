"""Full-state snapshots of the port (train/checkpoint.py: save_state,
load_state) and the train verb's --save_state_every, --resume and
--profile_dir, on the CPU at tiny widths.

A snapshot after 2 steps, loaded into a fresh state (other seed, so other
params and generators), then 2 more steps, must give the bits of 4 steps
without the interruption: the model, the main Adam's, the disc RMSprop's
and the club Adam's moments, ``step`` and both generators (sampling noise
and dropout), under gan (main + disc) and vi (club + main), with dropout on
and the noise and vi permutation drawn from the generators.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from carel_tpu_torch.cli.main import main
from carel_tpu_torch.data.batching import PairArrays
from carel_tpu_torch.pipeline import init_state
from carel_tpu_torch.train import checkpoint as ckpt
from carel_tpu_torch.train.scan_epoch import stack_epoch
from carel_tpu_torch.train.steps import make_train_step
from tests.test_torch_data import write_oldsplit_corpus
from tests.test_torch_loop import _train_args
from tests.test_torch_scan_epoch import B, VI_BETA, _arrays, _seeded_cfg


def _batches(n_batches=4):
    stacked = stack_epoch(PairArrays(**_arrays(n=B * n_batches)), B,
                          np.random.default_rng(9))
    return [{k: torch.from_numpy(v[i]) for k, v in stacked.items()}
            for i in range(n_batches)]


def _run(state, step, batches, start):
    return [step(state, batch, start + i, VI_BETA)["loss"]
            for i, batch in enumerate(batches)]


def _optimizer_state(state):
    return {name: getattr(state, name).state_dict()["state"]
            for name in ("optimizer", "disc_optimizer", "club_optimizer")}


@pytest.mark.parametrize("reg", ["gan", "vi"])
def test_snapshot_resumes_bit_exactly(tmp_path, reg):
    cfg = _seeded_cfg(reg)
    step = make_train_step(cfg)
    batches = _batches()

    whole = init_state(cfg, "cpu")
    want_losses = _run(whole, step, batches, 0)
    want_gens = (whole.generator.get_state(), torch.get_rng_state())

    first = init_state(cfg, "cpu")
    got_losses = _run(first, step, batches[:2], 0)
    ckpt.save_state(str(tmp_path), "m", first)
    fresh = init_state(dataclasses.replace(
        cfg, train=dataclasses.replace(cfg.train, seed=cfg.train.seed + 1)),
        "cpu")
    assert not torch.equal(fresh.model.encoder.pooler.weight,
                           first.model.encoder.pooler.weight)
    resumed = ckpt.load_state(str(tmp_path), "m", fresh)
    assert resumed is fresh and resumed.step == 2
    got_losses += _run(resumed, step, batches[2:], 2)

    assert torch.equal(torch.stack(got_losses), torch.stack(want_losses))
    for k, v in whole.model.state_dict().items():
        assert torch.equal(resumed.model.state_dict()[k], v), k
    want, got = _optimizer_state(whole), _optimizer_state(resumed)
    updated = {"gan": ("optimizer", "disc_optimizer"),
               "vi": ("optimizer", "club_optimizer")}[reg]
    for name in want:
        assert bool(want[name]) == (name in updated), name
        assert want[name].keys() == got[name].keys()
        for idx, entry in want[name].items():
            for key, value in entry.items():
                assert torch.equal(got[name][idx][key], value), (name, key)
    assert resumed.step == whole.step == 4
    assert torch.equal(resumed.generator.get_state(), want_gens[0])
    assert torch.equal(torch.get_rng_state(), want_gens[1])
    # the optimizers keep this run's hyper-parameters
    assert resumed.optimizer.param_groups[0]["lr"] == cfg.train.vae_lr


def _events(tmp_path):
    logs = sorted((tmp_path / "logs").glob("*.jsonl"))
    return [[json.loads(line) for line in log.read_text().splitlines()]
            for log in logs]


def _summary(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_cli_saves_state_and_resumes(tmp_path, capsys):
    """train --save_state_every 1 writes the snapshot after each epoch;
    train --resume <id> starts from it: its first snapshot counts the
    resumed steps too."""
    root = tmp_path / "corpus"
    write_oldsplit_corpus(str(root))
    args = _train_args(root, tmp_path)
    args[args.index("--preset") + 1] = "ec_hsic"
    args += ["--device", "cpu", "--save_state_every", "1"]
    assert main(args) == 0
    first = _summary(capsys)["model_id"]
    assert (tmp_path / "ckpt" / f"{first}_state.pt").exists()
    (events,) = _events(tmp_path)
    snaps = [e for e in events if e["event"] == "state_snapshot"]
    assert [e["epoch"] for e in snaps] == [1]
    steps = snaps[0]["step"]
    train = [e for e in events if e["event"] == "train"]
    assert steps == train[0]["it"] > 0

    assert main(args + ["--resume", first]) == 0
    second = _summary(capsys)["model_id"]
    events = [ev for ev in _events(tmp_path) if ev[0]["model_id"] == second]
    (events,) = events
    resumed = [e for e in events if e["event"] == "resumed"]
    assert resumed == [dict(resumed[0], **{"from": first, "step": steps})]
    snaps = [e for e in events if e["event"] == "state_snapshot"]
    assert [e["step"] for e in snaps] == [2 * steps]
    saved = torch.load(tmp_path / "ckpt" / f"{second}_state.pt",
                       weights_only=True)
    assert saved["step"] == 2 * steps
    assert {"model", "optimizer", "disc_optimizer", "club_optimizer",
            "generator", "dropout_generator"} <= saved.keys()


def _profiled_trace(tmp_path, capsys) -> dict:
    """The Chrome trace that ``train --profile_dir`` writes of a tiny base
    training on the CPU."""
    root = tmp_path / "corpus"
    write_oldsplit_corpus(str(root))
    args = _train_args(root, tmp_path)
    args[args.index("--preset") + 1] = "ec_hsic"
    prof = tmp_path / "prof"
    assert main(args + ["--device", "cpu", "--profile_dir", str(prof)]) == 0
    _summary(capsys)
    traces = list(prof.glob("trace_*.json"))
    assert len(traces) == 1
    return json.loads(traces[0].read_text())


def test_cli_profile_dir_writes_a_trace(tmp_path, capsys):
    trace = _profiled_trace(tmp_path, capsys)
    names = {e.get("name", "") for e in trace["traceEvents"]}
    assert any("aten::" in n for n in names)


def test_cli_profile_dir_writes_the_program_spans(tmp_path, capsys):
    """The trace holds a "program spans" row: the epoch's spans and the
    evaluation's, each inside the time range of the profiler's own
    records."""
    from carel_tpu_torch.utils.profiling import SPAN_ROW

    events = _profiled_trace(tmp_path, capsys)["traceEvents"]
    mine = [e for e in events if e.get("pid") == SPAN_ROW and e["ph"] == "X"]
    theirs = [e for e in events if e.get("pid") != SPAN_ROW
              and e.get("ph") == "X"]
    assert any(e["ph"] == "M" and e["args"]["name"] == SPAN_ROW
               for e in events if e.get("pid") == SPAN_ROW)
    assert {"stack_epoch", "epoch_step", "epoch_step.pack",
            "evaluate"} <= {e["name"] for e in mine}
    lo = min(e["ts"] for e in theirs)
    hi = max(e["ts"] + e["dur"] for e in theirs)
    for e in mine:
        assert lo <= e["ts"] and e["ts"] + e["dur"] <= hi, e
    ids = {e["args"]["id"] for e in mine if e["name"] == "epoch_step"}
    assert all(e["args"]["parent"] in ids for e in mine
               if e["name"] == "epoch_step.pack")


def test_step_timer_and_trace():
    """The port's utils/profiling.py as tests/test_tools.py holds JAX's."""
    import time

    from carel_tpu_torch.utils.profiling import StepTimer, trace

    t = StepTimer(window=3)
    for _ in range(5):
        with t:
            time.sleep(0.001)
    s = t.summary()
    assert s["steps"] == 3  # window bound
    assert s["p50_ms"] >= 1.0
    assert StepTimer().summary() == {}
    with trace(""):  # no-op
        pass
