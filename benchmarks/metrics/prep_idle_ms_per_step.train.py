"""Device-idle ms a training step inside the host's preparation of an
epoch: the program's spans ``stack_epoch`` (shuffle, ``cut_batch``,
stack), ``epoch_step.pack`` and ``epoch_step.copy``, over the traced
window's steps."""
from harness.program_spans import idle_ms_per

NAMES = ("stack_epoch", "epoch_step.pack", "epoch_step.copy")


def read(run):
    return idle_ms_per(run, NAMES, "steps")
