"""``head_fill_pct.pretrain`` on hand-made spans: the rows masked over the
rows the MLM head ran over, in the ``mlm.draws`` spans that overlap the
traced window; nothing to read without such spans, without a trace or
without the recorder."""

import pytest

import tiny  # noqa: F401  (puts benchmarks/ on the path)
from carel_tpu_torch.utils import profiling
from harness.catalog import Catalog
from harness.trace import Trace

# (name, start us, end us, counts) in a window of 0-100 us; the last
# draws span lies after the window
SPANS = [("mlm.draws", -5.0, 10.0,
          {"masked": 900, "head_rows": 1152, "full_steps": 0}),
         ("mlm.replays", 10.0, 60.0, {}),
         ("mlm.draws", 60.0, 70.0,
          {"masked": 1300, "head_rows": 1300, "full_steps": 1}),
         ("mlm.draws", 150.0, 160.0,
          {"masked": 1, "head_rows": 1152, "full_steps": 0})]


def _run(trace=True):
    tr = Trace([("k", 10.0, 60.0)], (0.0, 100.0), [], 1, {"steps": 2.0}) \
        if trace else None
    return type("Run", (), {"trace": tr, "notes": []})()


def _read(run):
    return Catalog().module("metrics", "head_fill_pct.pretrain").read(run)


def _use(monkeypatch, spans):
    monkeypatch.setattr(profiling, "spans", lambda: [
        profiling.Span(n, int(s * 1e3), int(e * 1e3), i + 1, None, 0, c)
        for i, (n, s, e, c) in enumerate(spans)])


@pytest.mark.parametrize("case", ["read", "no spans", "no draws spans",
                                  "no trace", "no recorder"])
def test_head_fill_reads_the_draws_spans(monkeypatch, case):
    _use(monkeypatch, {"no spans": [],
                       "no draws spans": SPANS[1:2]}.get(case, SPANS))
    if case == "no recorder":
        monkeypatch.delattr(profiling, "spans")
    got = _read(_run(trace=case != "no trace"))
    if case == "read":
        assert got == pytest.approx(100.0 * 2200 / 2452)
    else:
        assert got is None
