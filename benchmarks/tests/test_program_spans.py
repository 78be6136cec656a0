"""The readers of the program's spans (``harness/program_spans.py`` and the
four metrics over it) on a hand-made trace and span list whose device-idle
time is known, spans crossing the window's edges included, on runs that
have no spans, and on windows whose records cannot be placed against the
spans."""

import pytest

import tiny  # noqa: F401  (puts benchmarks/ on the path)
from carel_tpu_torch.utils import profiling
from harness import program_spans
from harness.catalog import Catalog
from harness.trace import Trace

# busy (us): 10-30, 50-60, 95-100 inside the window 0-100; each copy
# span below holds the start of its host-to-card record
KERNELS = [("a", 10.0, 20.0), ("b", 15.0, 30.0), ("c", 50.0, 60.0),
           ("d", 95.0, 120.0),
           ("Memcpy HtoD (Pageable -> Device)", 10.5, 11.5),
           ("Memcpy HtoD (Pinned -> Device)", 50.0, 52.0)]
# (name, start us, end us): stack_epoch crosses the window's start and
# the replays its end; the last span lies after the window
SPANS = [("stack_epoch", -20.0, 40.0), ("epoch_step", 40.0, 110.0),
         ("epoch_step.pack", 40.0, 45.0), ("epoch_step.copy", 45.0, 55.0),
         ("epoch_step.replays", 55.0, 110.0),
         ("score_pairs.cut_batch", 0.0, 10.0),
         ("score_pairs.to_device", 10.0, 12.0),
         ("score_pairs.forward", 12.0, 50.0),
         ("score_pairs.fetch", 60.0, 90.0), ("mlm.replays", 0.0, 100.0),
         ("stack_epoch", 200.0, 300.0)]
WORK = {"steps": 2.0, "requests": 4.0}


def _records(spans):
    """Span records of (name, start us, end us[, counts])."""
    return [profiling.Span(sp[0], int(sp[1] * 1e3), int(sp[2] * 1e3), i + 1,
                           None, 0, sp[3] if len(sp) > 3 else {})
            for i, sp in enumerate(spans)]


def _run(trace=True, kernels=KERNELS, guards_lost=0):
    tr = Trace(kernels, (0.0, 100.0), [], 1, WORK, guards_lost) \
        if trace else None
    return type("Run", (), {"trace": tr, "notes": []})()


@pytest.fixture
def recorded(monkeypatch):
    def use(spans):
        monkeypatch.setattr(profiling, "spans", lambda: _records(spans))
    use(SPANS)
    return use


@pytest.mark.parametrize("metric, want", [
    # replays clipped to 55-100: 45 us, busy 55-60 and 95-100
    ("graph_idle_pct.train", 100.0 * 35.0 / 45.0),
    # stack_epoch clipped to 0-40: idle 0-10, 30-40; pack 5; copy 45-50
    ("prep_idle_ms_per_step.train", (20.0 + 5.0 + 5.0) / 1e3 / 2),
    # the whole window: 100 us, busy 35
    ("graph_idle_pct.pretrain", 65.0),
    # cut_batch 10, to_device 0, forward 30-50: 20, fetch 60-90: 30
    ("host_idle_ms_per_request.score", (10.0 + 20.0 + 30.0) / 1e3 / 4),
])
def test_metric_reads_idle_inside_its_spans(recorded, metric, want):
    got = Catalog().module("metrics", metric).read(_run())
    assert got == pytest.approx(want)


def test_spans_are_clipped_to_the_window_and_united(recorded):
    assert [n for n, _, _ in program_spans.window_spans(_run())] == [
        n for n, _, _ in SPANS[:-1]]
    recorded([("x", -5.0, 40.0), ("x", 20.0, 50.0), ("y", 0.0, 100.0)])
    # x: 0-50 once, busy 10-30 and none of 50-60
    assert program_spans.idle_inside(_run(), ("x",)) == (30.0, 50.0)


METRICS = ["graph_idle_pct.train", "prep_idle_ms_per_step.train",
           "graph_idle_pct.pretrain", "host_idle_ms_per_request.score"]


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("case", ["no spans", "no trace", "no recorder",
                                  "spans outside the window"])
def test_nothing_to_read_reads_none(monkeypatch, recorded, metric, case):
    run = _run(trace=case != "no trace")
    if case == "no spans":
        recorded([])
    elif case == "no recorder":
        monkeypatch.delattr(profiling, "spans")
    elif case == "spans outside the window":
        recorded([(n, s + 500.0, e + 500.0) for n, s, e in SPANS])
    assert Catalog().module("metrics", metric).read(run) is None



@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("case", ["guard records lost",
                                  "a record 185 us before its span",
                                  "a record 25 us after its span",
                                  "fewer records than copies"])
def test_unsound_window_reads_none_with_a_note(recorded, metric, case):
    """A window that lost guard records, or whose copy spans do not hold
    the starts of all their host-to-card records within 20 us of their
    edges, reads None and says why."""
    kernels, lost = list(KERNELS), 0
    if case == "guard records lost":
        lost = 3
    elif case == "a record 185 us before its span":
        kernels[-1] = ("Memcpy HtoD (Pinned -> Device)", -140.0, -138.0)
    elif case == "a record 25 us after its span":
        kernels[-2] = ("Memcpy HtoD (Pageable -> Device)", 37.0, 38.0)
    else:
        recorded([(n, s, e, {"copies": 2}) if n == "score_pairs.to_device"
                  else (n, s, e) for n, s, e in SPANS])
    run = _run(kernels=kernels, guards_lost=lost)
    assert Catalog().module("metrics", metric).read(run) is None
    assert len(run.notes) == 1 and run.notes[0].startswith(
        "program spans not read: ")


@pytest.mark.parametrize("metric", METRICS)
def test_records_within_the_slack_still_read(recorded, metric):
    """Records that start up to 20 us outside their copy spans, the offset
    a sound session shows, leave every reading as it was."""
    want = Catalog().module("metrics", metric).read(_run())
    kernels = KERNELS[:-2] + [
        ("Memcpy HtoD (Pageable -> Device)", 12.0 + 17.0, 29.5),
        ("Memcpy HtoD (Pinned -> Device)", 45.0 - 19.0, 28.0)]
    run = _run(kernels=kernels)
    assert Catalog().module("metrics", metric).read(run) == \
        pytest.approx(want)
    assert run.notes == []
