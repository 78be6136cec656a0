"""The share of the MLM dispatch's replay loop (the program's span
``mlm.replays``) in which no operation ran on the card."""
from harness.program_spans import idle_pct


def read(run):
    return idle_pct(run, ("mlm.replays",))
