"""The share of the traced window in which no operation ran on the card."""
from harness.readers import idle_pct as read  # noqa: F401
