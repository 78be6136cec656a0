"""MLM positions trained per second over the window (batch x sequence
length a step; host clock)."""


def read(run):
    w = run.window
    return w.work.get("tokens", 0.0) / w.seconds if w.seconds else None
