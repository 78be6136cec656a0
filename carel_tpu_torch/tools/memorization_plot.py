"""Memorization-analysis plot from self-training logs, port of
carel_tpu/tools/memorization_plot.py.

The memorization variants (drl_classifier_ec_mmd_final_mul_memorization.py)
track per-iteration P/R/F1 and pseudo-positive churn and plot them
(memorization.png). The self-train driver logs those series as jsonl events
('memorization', 'selftrain_best'); this module renders the figure from a
log file. matplotlib is imported inside the function, so the module imports
on a machine without it.
"""

from __future__ import annotations

import json
from typing import List, Optional


def plot_memorization(log_path: str, out_path: str = "memorization.png"
                      ) -> Optional[str]:
    """Write the churn / best-F1 figure of ``log_path`` to ``out_path`` and
    return that path, or None when the log has neither series."""
    iters: List[int] = []
    churn: List[float] = []
    f1s: List[float] = []
    f1_iters: List[int] = []
    with open(log_path, encoding="utf8") as f:
        for line in f:
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                continue
            if rec.get("event") == "memorization":
                iters.append(rec["iteration"])
                churn.append(rec["pos_change_rate"])
            elif rec.get("event") == "selftrain_best":
                f1_iters.append(rec["iteration"])
                f1s.append(rec["f1"])
    if not iters and not f1_iters:
        return None

    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax1 = plt.subplots(figsize=(8, 5))
    if iters:
        ax1.plot(iters, [c * 100 for c in churn], "o-", color="tab:red",
                 label="pos change %")
        ax1.set_ylabel("pseudo-positive churn (%)", color="tab:red")
    ax1.set_xlabel("self-training iteration")
    if f1_iters:
        ax2 = ax1.twinx()
        ax2.plot(f1_iters, f1s, "s-", color="tab:blue", label="best F1")
        ax2.set_ylabel("best pair-F1", color="tab:blue")
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path
