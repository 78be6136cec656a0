"""Device-idle ms a request inside the scorer's host work: the program's
spans ``score_pairs.cut_batch``, ``score_pairs.to_device``,
``score_pairs.forward`` (the eval step's enqueue, during which the card
waits for the forward's first launches) and ``score_pairs.fetch``, over
the traced window's requests."""
from harness.program_spans import idle_ms_per

NAMES = ("score_pairs.cut_batch", "score_pairs.to_device",
         "score_pairs.forward", "score_pairs.fetch")


def read(run):
    return idle_ms_per(run, NAMES, "requests")
