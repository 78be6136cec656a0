"""The routed experts' grouped products (carel_tpu_torch/ops/moe.py:
expert_gemm_kernel, forward and the products of the input's gradient, and
expert_gemm_wgrad_kernel, the weights' gradient; Triton).

Their least work depends on the rows routed to the held experts, which the
shapes do not give: ``expert_gemm_roofline.moe_train`` reads it from the
program's ``epoch_step.moe`` spans (``harness/work_moe.py``). So
``bound_ms`` gives None and ``train_kernels_roofline`` leaves the op out."""

PATTERNS = [r"expert_gemm_kernel", r"expert_gemm_wgrad_kernel"]
CALL = r"expert_gemm_kernel"


def bound_ms(s: dict):
    return None
