"""The held experts' grouped products' share of their roofline in the
traced window: the least-work bound of the rows they computed
(``harness/work_moe.expert_gemm_bound_ms`` of the ``held_rows``, steps and
layers of the program's ``epoch_step.moe`` spans in the window) over the
device time of the kernels of ``kernels/expert_gemm.py``. None where the
program records no such span or no kernel matched."""

from harness.work_moe import expert_gemm_bound_ms


def read(run):
    tr = run.trace
    if tr is None:
        return None
    try:
        from carel_tpu_torch.utils.profiling import spans
    except ImportError:
        return None
    lo, hi = tr.window
    rows = layer_steps = 0
    for s in spans():
        if s.name == "epoch_step.moe" and s.end_ns / 1e3 > lo \
                and s.start_ns / 1e3 < hi:
            rows += s.counts.get("held_rows", 0)
            layer_steps += s.counts.get("steps", 0) * s.counts.get(
                "layers", 0)
    if not rows:
        return None
    op = run.catalog.module("kernels", "expert_gemm")
    us, n = tr.kernel_us(op.PATTERNS)
    if n == 0:
        return None
    shapes = run.driver.shapes()
    bound = expert_gemm_bound_ms(rows, layer_steps, shapes["D"],
                                 shapes["moe_width"], shapes["held_experts"])
    return 100.0 * bound / (us / 1e3)
