"""Model FLOPs a second over the window, as a share of the dense bf16 peak."""
from harness.readers import mfu_pct as read  # noqa: F401
