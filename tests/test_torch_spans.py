"""The port's span recorder (carel_tpu_torch/utils/profiling.py: span,
spans, reset_spans, and the row it adds to a Chrome trace) and the spans
of the epoch step, the scorer, the MLM dispatch and the evaluation, on the
CPU at tiny widths; on the card
(``cuda``), the spans against the profiler's own device records and the
captured paths' spans.

A span records only while a torch profiler runs on the calling thread, so
each test that expects spans runs its work under one. This file imports
no JAX: the ``cuda`` cases run where JAX is not installed.
"""

import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from carel_tpu_torch.config import CarelConfig, DataConfig, LossConfig
from carel_tpu_torch.config import ModelConfig, Regularizer, TrainConfig
from carel_tpu_torch.data.batching import PairArrays, cut_batch
from carel_tpu_torch.infer.pair_inference import score_pairs
from carel_tpu_torch.models.encoder import tiny_encoder_config
from carel_tpu_torch.pipeline import init_state
from carel_tpu_torch.pretrain import mlm
from carel_tpu_torch.train.loop import evaluate
from carel_tpu_torch.train.scan_epoch import make_epoch_step, stack_epoch
from carel_tpu_torch.train.steps import make_eval_step
from carel_tpu_torch.utils.profiling import reset_spans, span, spans

VOCAB, BOW, B, L = 128, 300, 8, 16


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the device records come from the "
                    "card")
    return torch.device("cuda")


@pytest.fixture
def recording():
    """Runs the test's work under a CPU profiler with the spans reset."""
    reset_spans()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        yield prof
    reset_spans()


def _cfg(dropout=0.0):
    return CarelConfig(
        model=ModelConfig(encoder=tiny_encoder_config(
            vocab_size=VOCAB, dropout=dropout), ec_dim=8,
            bow_dim=BOW, dropout=dropout),
        loss=LossConfig(regularizer=Regularizer("mmd")),
        data=DataConfig(max_len=L),
        train=TrainConfig(batch_size=B, seed=11))


def _arrays(n, seed=0):
    rng = np.random.default_rng(seed)
    mask = np.ones((n, L), np.int32)
    mask[::3, L // 2:] = 0
    idx = rng.integers(0, BOW, (n, 6)).astype(np.int32)
    idx[:, -2:] = -1
    return PairArrays(
        input_ids=(rng.integers(2, VOCAB, (n, L)) * mask).astype(np.int32),
        attention_mask=mask,
        token_type_ids=np.zeros((n, L), np.int32),
        pair_labels=(rng.random(n) < 0.4).astype(np.float32),
        emotion_labels=rng.integers(0, 6, n).astype(np.int32),
        temporal_order=rng.random(n) < 0.5,
        bow_indices=idx,
        bow_weights=np.where(idx >= 0, 0.25, 0.0).astype(np.float32))


def _trainer(device, n=32, seed=0):
    enc = tiny_encoder_config(vocab_size=VOCAB, dropout=0.0)
    cfg = mlm.MlmConfig(batch_size=8, seq_len=24, warmup_steps=4,
                        learning_rate=1e-3)
    rng = np.random.default_rng(seed)
    lengths = rng.integers(6, cfg.seq_len + 1, n)
    mask = (np.arange(cfg.seq_len)[None, :] < lengths[:, None]).astype(
        np.int32)
    ids = (rng.integers(5, VOCAB, (n, cfg.seq_len)) * mask).astype(np.int32)
    ids[:, 0] = 2
    model = mlm.build_mlm(enc, seed=0).to(device)
    return mlm.MlmTrainer(model, cfg, ids, mask, None, 4, device)


def _by_name(records):
    out = {}
    for s in records:
        out.setdefault(s.name, []).append(s)
    return out


@pytest.mark.parametrize("counts", [{}, {"copies": 8, "bytes": 5}])
def test_off_records_nothing(counts):
    """Without a profiler a span is one shared no-op and records
    nothing, nested or not."""
    reset_spans()
    assert not torch.autograd._profiler_enabled()
    with span("outer", **counts):
        with span("inner"):
            torch.ones(4).sum()
    assert span("a") is span("b", **counts)
    assert spans() == []


@pytest.mark.parametrize("calls", [1, 3])
def test_on_parents_ids_and_threads(recording, monkeypatch, calls):
    """Under a CPU profiler: each call's children carry its top-level
    span's id as parent, ids are unique, counts are kept, and the parent
    is the innermost span open on the same thread, whatever another thread
    has open meanwhile. (A Python thread does not inherit the profiler's
    thread-local state, so the worker forces the probe on.)"""
    for i in range(calls):
        with span("call", unit=i):
            with span("call.a", rows=i):
                pass
            with span("call.b"):
                pass
    got = _by_name(spans())
    assert len(got["call"]) == calls
    for i, top in enumerate(got["call"]):
        assert top.parent is None and top.counts == {"unit": i}
        kids = [s for s in spans() if s.parent == top.id]
        assert [s.name for s in kids] == ["call.a", "call.b"]
        assert kids[0].counts == {"rows": i}
        assert top.start_ns <= kids[0].start_ns <= kids[0].end_ns \
            <= kids[1].start_ns <= kids[1].end_ns <= top.end_ns
    assert len({s.id for s in spans()}) == len(spans())

    reset_spans()
    monkeypatch.setattr(torch.autograd, "_profiler_enabled", lambda: True)
    opened, inner_done = threading.Event(), threading.Event()

    def worker():
        with span("worker"):
            with span("worker.child"):
                opened.set()
                assert inner_done.wait(10)

    t = threading.Thread(target=worker)
    with span("main"):
        t.start()
        assert opened.wait(10)
        with span("main.child"):
            pass
        inner_done.set()
        t.join(10)
    assert not t.is_alive()
    got = {s.name: s for s in spans()}
    assert got["main.child"].parent == got["main"].id
    assert got["worker.child"].parent == got["worker"].id
    assert got["worker"].parent is None and got["main"].parent is None
    assert got["worker"].thread != got["main"].thread
    assert got["main.child"].thread == got["main"].thread


def test_threads_lose_no_span(monkeypatch):
    """More threads than cores record spans at a short switch interval:
    no span is lost, no id repeats, and every child names its own
    thread's parent. (The probe is forced on: threads do not inherit the
    profiler's state.)"""
    import os
    import sys

    monkeypatch.setattr(torch.autograd, "_profiler_enabled", lambda: True)
    threads, each = 2 * (os.cpu_count() or 2) + 2, 200
    reset_spans()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(each):
                with span("outer"):
                    with span("inner"):
                        pass

        pool = [threading.Thread(target=work) for _ in range(threads)]
        for t in pool:
            t.start()
        for t in pool:
            t.join(60)
        assert not any(t.is_alive() for t in pool)
    finally:
        sys.setswitchinterval(interval)
    got = spans()
    reset_spans()
    assert len(got) == 2 * threads * each
    assert len({s.id for s in got}) == len(got)
    outer = {s.id: s.thread for s in got if s.name == "outer"}
    assert all(outer[s.parent] == s.thread for s in got if s.name == "inner")


@pytest.mark.parametrize("n", [64, 256])
def test_span_holds_the_profilers_record_of_its_work(n):
    """A span around ``a @ a`` holds kineto's ``aten::mm`` record, in every
    one of ten tries, and within 50 us at each edge in the closest try
    (the others may take a preemption of this thread between an edge and
    the work): the spans and the profiler's records share one clock. One
    intra-op thread: a pool's wake-ups would stretch the edges, not the
    clocks."""
    a = torch.randn(n, n)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        for _ in range(3):
            a @ a
        reset_spans()
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            for _ in range(3):
                a @ a
            for _ in range(10):
                with span("mm"):
                    a @ a
    finally:
        torch.set_num_threads(threads)
    got = spans()
    mms = sorted((e for e in prof.profiler.kineto_results.events()
                  if e.name() == "aten::mm"), key=lambda e: e.start_ns())
    edges = []
    for s, e in zip(got, mms[-len(got):]):
        start, end = e.start_ns(), e.start_ns() + e.duration_ns()
        assert s.start_ns <= start and end <= s.end_ns
        edges.append(max(start - s.start_ns, s.end_ns - end))
    assert len(edges) == 10 and min(edges) <= 50_000, edges


@pytest.mark.parametrize("batches", [1, 3])
def test_epoch_step_records_its_spans(recording, batches):
    """The CPU epoch step records ``epoch_step`` and, under it,
    ``epoch_step.pack``; ``stack_epoch`` its batches."""
    cfg = _cfg()
    state = init_state(cfg, "cpu")
    step = make_epoch_step(cfg)
    stacked = stack_epoch(_arrays(B * batches - 3), B,
                          np.random.default_rng(1))
    step(state, stacked, 0.0)
    got = _by_name(spans())
    assert sorted(got) == ["epoch_step", "epoch_step.pack", "stack_epoch"]
    assert got["stack_epoch"][0].counts == {"batches": batches}
    (top,), (pack,) = got["epoch_step"], got["epoch_step.pack"]
    assert pack.parent == top.id and top.parent is None


@pytest.mark.parametrize("n", [B, 2 * B + 3])
def test_score_pairs_records_four_children_per_batch(recording, n):
    """``score_pairs`` records, per batch and in order, its cut, copy
    (with the number of arrays it copies), forward and fetch, each at top
    level; ``evaluate`` its pairs."""
    cfg = _cfg()
    state = init_state(cfg, "cpu")
    state.model.eval()
    arrays = _arrays(n)
    gen = torch.Generator().manual_seed(0)
    score_pairs(make_eval_step(), state.model, arrays, gen, B)
    got = sorted(spans(), key=lambda s: s.start_ns)
    nb = -(-n // B)
    assert [s.name for s in got] == nb * [
        "score_pairs.cut_batch", "score_pairs.to_device",
        "score_pairs.forward", "score_pairs.fetch"]
    assert all(s.parent is None for s in got)
    keys = len(cut_batch(arrays, np.arange(B), B).as_dict())
    assert [s.counts for s in got[1::4]] == nb * [{"copies": keys}]
    assert all(s.counts == {} for i, s in enumerate(got) if i % 4 != 1)

    reset_spans()
    evaluate(make_eval_step(), state.model, arrays, 0, gen, B)
    (ev,) = spans()
    assert ev.name == "evaluate" and ev.counts == {"pairs": n}


@pytest.mark.parametrize("n", [1, 2])
def test_mlm_dispatch_records_no_span_on_the_cpu(recording, n):
    """The CPU dispatch runs eager steps and records no span: only the
    captured dispatch's draws and replays (``mlm.draws``,
    ``mlm.replays``, a ``cuda`` case below) have a reader."""
    trainer = _trainer("cpu")
    trainer.dispatch(n)
    assert spans() == []


def _kineto_trace(path):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        torch.ones(8).sum()
    prof.export_chrome_trace(str(path))
    return path.read_bytes()


@pytest.mark.parametrize("tail", ["kineto", "no events", "unknown"])
def test_write_spans_adds_a_row_without_parsing_the_trace(tmp_path, tail):
    """``_write_spans`` puts the spans in before the ``]`` that closes
    ``traceEvents`` and leaves every byte before it as it was, in kineto's
    own file and in one with no events; a tail of another form leaves the
    trace alone and gets a file of its own beside it."""
    import json

    from carel_tpu_torch.utils.profiling import SPAN_ROW, Span, _write_spans

    path = tmp_path / "trace.json"
    base = 1_000_000_000_000_000_000
    if tail == "kineto":
        before = _kineto_trace(path)
        base = json.loads(before)["baseTimeNanoseconds"]
    elif tail == "no events":
        before = (f'{{"baseTimeNanoseconds": {base}, "traceEvents": [\n  ],'
                  f'"traceName": "{path}" }}').encode()
    else:
        before = (f'{{"baseTimeNanoseconds": {base}, "traceEvents": [], '
                  '"other": [1, 2]}\n').encode()
    if tail != "kineto":
        path.write_bytes(before)
    records = [Span("a", base + 5_000, base + 9_000, 1, None, 7, {}),
               Span("a.b", base + 6_000, base + 8_000, 2, 1, 7,
                    {"copies": 3})]
    _write_spans(str(path), records)
    if tail == "unknown":
        assert path.read_bytes() == before
        path = tmp_path / "trace.json.spans.json"
    doc = json.loads(path.read_text())
    mine = [e for e in doc["traceEvents"] if e.get("pid") == SPAN_ROW]
    assert mine[0]["ph"] == "M" and mine[0]["args"]["name"] == SPAN_ROW
    assert [(e["name"], e["ts"], e["dur"], e["args"]) for e in mine[1:]] == [
        ("a", 5.0, 4.0, {"id": 1, "parent": None, "thread": 7}),
        ("a.b", 6.0, 2.0, {"id": 2, "parent": 1, "thread": 7,
                           "copies": 3})]
    if tail != "unknown":
        close = before.rindex(b"]")
        assert path.read_bytes()[:close].rstrip() == before[:close].rstrip()
        assert path.read_bytes().endswith(before[close:])


def _spin_guard():
    """Spin kernels and a synchronize, as the benchmark's traced window
    opens and closes: the profiler has lost a window's edge records and
    delivered a previous window's late ones, and the guards take that."""
    for _ in range(200):
        torch.cuda._sleep(100_000)
    torch.cuda.synchronize()


def _copies_in_spans(cuda, acts):
    """One profiler run of ten tries: a pinned host-to-card copy into
    a buffer already on the card, synchronized, inside one span, and a
    ``.cpu()`` fetch of a small tensor inside another. Returns the failures
    of the run (empty when it holds) and its offsets: per measured
    try, how long the span starts before its memcpy record and ends after
    it, in us."""
    from torch.autograd import DeviceType

    host = torch.randn(4 << 20).pin_memory()
    dst = torch.empty_like(host, device=cuda)
    small = torch.randn(256, device=cuda)
    for _ in range(3):
        dst.copy_(host, non_blocking=True)
        small.cpu()
    torch.cuda.synchronize()
    reset_spans()
    with profile(activities=acts) as prof:
        assert torch.autograd._profiler_enabled()
        _spin_guard()
        for _ in range(10):
            with span("h2d"):
                dst.copy_(host, non_blocking=True)
                torch.cuda.synchronize()
            with span("d2h"):
                small.cpu()
        _spin_guard()
    got = sorted(spans(), key=lambda s: s.start_ns)
    reset_spans()
    assert [s.name for s in got] == 10 * ["h2d", "d2h"]
    # records of this window only: a late one of an earlier window lies ms
    # before it
    lo, hi = got[0].start_ns - 100_000, got[-1].end_ns + 100_000
    records = sorted((e for e in prof.profiler.kineto_results.events()
                      if e.device_type() == DeviceType.CUDA
                      and "memcpy" in e.name().lower()
                      and lo <= e.start_ns() <= hi),
                     key=lambda e: e.start_ns())
    faults, offsets = [], []
    for name, kind in (("h2d", "HtoD"), ("d2h", "DtoH")):
        mine = [s for s in got if s.name == name]
        copies = [e for e in records if kind in e.name()]
        if len(copies) != len(mine):
            faults.append(f"{name}: {len(copies)} records for {len(mine)} "
                          "spans")
            continue
        edges = []
        for s, e in list(zip(mine, copies))[2:]:
            lead = (e.start_ns() - s.start_ns) / 1e3
            tail = (s.end_ns - e.start_ns() - e.duration_ns()) / 1e3
            offsets.append((name, round(lead, 2), round(tail, 2)))
            if lead < -20 or tail < -20:
                faults.append(f"{name}: record outside its span by more "
                              f"than 20 us ({lead:.2f}, {tail:.2f})")
            edges.append(max(lead, tail))
        if min(edges) > 50:
            faults.append(f"{name}: closest try {min(edges):.2f} us")
    return faults, offsets


@pytest.mark.cuda
@pytest.mark.parametrize("activities", ["cuda", "cpu+cuda"])
def test_spans_hold_the_cards_copies(cuda, activities):
    """Under a CUDA profiler (the CUDA activity alone, as the benchmark's
    traced window runs, or with the CPU activity, as ``--profile_dir``
    does), a run of ``_copies_in_spans``: after two warm-up tries each
    memcpy record lies inside its span within 20 us at each edge in every
    try (the device's stamps reach the Unix clock with an offset that
    differs by profiler run, by up to ~20 us), and in the closest try of each
    copy the span's edges lie within 50 us of the record (the host's own
    work at each edge is 3-30 us; the other tries may take a preemption).
    A profiler run on the card has been seen to lose most of its records or
    to place them ~190 us off, so up to three runs are made and one must
    hold. Prints every run's faults and offsets."""
    acts = [ProfilerActivity.CUDA] + (
        [ProfilerActivity.CPU] if activities == "cpu+cuda" else [])
    runs = []
    for _ in range(3):
        faults, offsets = _copies_in_spans(cuda, acts)
        print(activities, "faults", faults, "offsets", offsets)
        runs.append(faults)
        if not faults:
            break
    assert not runs[-1], runs


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["epoch_step", "mlm"])
def test_captured_paths_record_their_spans(cuda, path):
    """On the card the epoch step records its copy, capture (the first call
    only) and replays, with the counts the operator's trace reads, and the
    MLM dispatch its draws, with the rows masked, the rows the head ran
    over and the steps past its capacity, and its replays."""
    reset_spans()
    with profile(activities=[ProfilerActivity.CUDA]):
        if path == "epoch_step":
            cfg = _cfg()
            state = init_state(cfg, cuda)
            step = make_epoch_step(cfg)
            for _ in range(2):
                step(state, stack_epoch(_arrays(3 * B), B), 0.0).cpu()
        else:
            trainer = _trainer(cuda)
            for _ in range(2):
                float(trainer.dispatch(3))
    got = _by_name(spans())
    reset_spans()
    if path == "epoch_step":
        assert sorted(got) == [
            "epoch_step", "epoch_step.capture", "epoch_step.copy",
            "epoch_step.pack", "epoch_step.replays", "stack_epoch"]
        assert len(got["epoch_step"]) == 2
        assert len(got["epoch_step.capture"]) == 1
        assert [s.counts for s in got["epoch_step.replays"]] == 2 * [
            {"replays": 3}]
        assert all(s.counts["bytes"] > 0 for s in got["epoch_step.copy"])
        tops = {s.id for s in got["epoch_step"]}
        assert all(s.parent in tops for k, v in got.items()
                   if k.startswith("epoch_step.") for s in v)
    else:
        assert sorted(got) == ["mlm.draws", "mlm.replays"]
        assert [s.counts for s in got["mlm.replays"]] == 2 * [{}]
        draws = [s.counts for s in got["mlm.draws"]]
        assert [sorted(c) for c in draws] == 2 * [
            ["full_steps", "head_rows", "masked"]]
        # the tiny corpus masks ~17 rows a step, far under its capacity
        assert sum(c["masked"] for c in draws) == trainer.masked > 0
        assert draws == [dict(c, head_rows=3 * trainer.capacity,
                              full_steps=0) for c in draws]
        assert all(d.end_ns <= r.start_ns for d, r in
                   zip(got["mlm.draws"], got["mlm.replays"]))
