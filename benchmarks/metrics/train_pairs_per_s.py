"""Training pairs completed per second over the window (host clock)."""


def read(run):
    w = run.window
    return w.work.get("pairs", 0.0) / w.seconds if w.seconds else None
