"""The share of the MLM head's rows that held a masked position: 100 x
the rows masked over the rows the head ran over, summed over the
program's ``mlm.draws`` spans in the traced window (their counts
``masked`` and ``head_rows``). None where the program records no such
span."""


def read(run):
    if run.trace is None:
        return None
    try:
        from carel_tpu_torch.utils.profiling import spans
    except ImportError:
        return None
    lo, hi = run.trace.window
    masked = rows = 0
    for s in spans():
        if s.name == "mlm.draws" and s.end_ns / 1e3 > lo \
                and s.start_ns / 1e3 < hi:
            masked += s.counts.get("masked", 0)
            rows += s.counts.get("head_rows", 0)
    return 100.0 * masked / rows if rows else None
