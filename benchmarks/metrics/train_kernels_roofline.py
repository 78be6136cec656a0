"""The hand-written kernels' share of their roofline in the traced window:
the sum over the ops of kernels/ of calls x least-work bound, over the sum
of their device time. An op whose kernels left no record is named in the
run's notes and left out of both sums."""


def read(run):
    tr = run.trace
    if tr is None:
        return None
    shapes = run.driver.shapes()
    bound = device = 0.0
    for name in run.catalog.names("kernels", ".py"):
        op = run.catalog.module("kernels", name)
        ms = op.bound_ms(shapes)
        if ms is None:
            continue
        us, _ = tr.kernel_us(op.PATTERNS)
        _, calls = tr.kernel_us([op.CALL])
        if calls == 0:
            run.notes.append(f"kernels/{name}: no record matched")
            continue
        bound += calls * ms
        device += us / 1e3
    return 100.0 * bound / device if device else None
