"""Host ms a training step of the loop's work before an epoch's call:
the benchmark's span around ``stack_epoch`` (the shuffle, ``cut_batch``
of every batch and the stack), over the window, divided by the steps. The
epoch step's pack and copy, inside its call, show in the traced window's
idle gap at the epoch's start."""


def read(run):
    w = run.window
    steps = w.work.get("steps")
    spent = w.span_seconds("stack_epoch")
    return spent / steps * 1e3 if steps and spent else None
