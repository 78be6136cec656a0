"""Device ms a training step of torch's foreach kernels in the traced
window (``multi_tensor_apply_kernel`` other than the fused Adam's): the
update of ``MuDtypeAdam``, which ``train --optim_mu_dtype bfloat16`` runs
in place of the fused Adam."""

from harness.readers import kernel_ms_per_step

PATTERNS = [r"multi_tensor_apply_kernel(?!.*Fused)"]


def read(run):
    return kernel_ms_per_step(run, PATTERNS)
