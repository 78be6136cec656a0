"""The share of the epoch step's replay loop (the program's span
``epoch_step.replays``) in which no operation ran on the card: the gaps
between the captured graph's kernels and between its replays."""
from harness.program_spans import idle_pct


def read(run):
    return idle_pct(run, ("epoch_step.replays",))
