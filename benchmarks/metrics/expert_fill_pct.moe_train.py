"""The share of the permuted-row buffers that held routed rows: 100 x the
rows routed to held experts over the rows the grouped kernels were sized
for (the worst case, every token's min(k, held) choices and a tile of
padding an expert), summed over the program's ``epoch_step.moe`` spans in
the traced window (their counts ``held_rows`` and ``buffer_rows``). None
where the program records no such span."""


def read(run):
    if run.trace is None:
        return None
    try:
        from carel_tpu_torch.utils.profiling import spans
    except ImportError:
        return None
    lo, hi = run.trace.window
    held = rows = 0
    for s in spans():
        if s.name == "epoch_step.moe" and s.end_ns / 1e3 > lo \
                and s.start_ns / 1e3 < hi:
            held += s.counts.get("held_rows", 0)
            rows += s.counts.get("buffer_rows", 0)
    return 100.0 * held / rows if rows else None
