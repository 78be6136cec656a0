"""Arithmetic that several metric readers share."""

from __future__ import annotations

from typing import Optional

from harness.work import PEAK_BF16_FLOPS


def mfu_pct(run) -> Optional[float]:
    """The model FLOPs the window's units completed, over the window's
    seconds, as a share of the card's dense bf16 peak."""
    w = run.window
    if not w.seconds or not w.work.get("flops"):
        return None
    return 100.0 * w.work["flops"] / w.seconds / PEAK_BF16_FLOPS


def idle_pct(run) -> Optional[float]:
    """The share of the traced window in which no operation ran on the
    device."""
    tr = run.trace
    if tr is None or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)


def kernel_ms_per_step(run, patterns) -> Optional[float]:
    """Device ms a step of the kernels matching ``patterns`` in the traced
    window; nothing when none matched."""
    tr = run.trace
    if tr is None or not tr.work.get("steps"):
        return None
    us, n = tr.kernel_us(patterns)
    if n == 0:
        return None
    return us / 1e3 / tr.work["steps"]
