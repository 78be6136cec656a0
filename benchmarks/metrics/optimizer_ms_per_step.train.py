"""Device ms a training step of the fused Adam kernels in the traced
window."""

from harness.readers import kernel_ms_per_step

PATTERNS = [r"FusedAdam", r"fused_adam"]


def read(run):
    return kernel_ms_per_step(run, PATTERNS)
