"""Device time of the eager flagship step with autocast's cast cache on and
off, in turns, on the card.

    python3 carel_tpu_torch/tools/autocast_cache.py

The encoder runs its bf16 autocast region with ``cache_enabled=False``, as
autocast inside a CUDA-graph capture requires. This holds the eager step's
device time with the cache on (``torch.autocast`` wrapped to pass
``cache_enabled=True``) against the encoder as it is, six epochs of 16 steps
in the order on, off, off, on, on, off, each profiled over its epoch. The
flagship runs at full width (b64 x s96, random weights, 1,024 random pairs)
as ``chip_smoke.py`` builds it, through the per-step loop of
``--no_scan_epoch``. Needs a GPU and nvcc; prints the card's name and power
limit, then per epoch the device ms/step, the kernels/step, the fused
Adam's ms/step, and for the first two epochs the eight largest kernels.
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[2]


def main() -> int:
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from carel_tpu_torch.pipeline import init_state
    from carel_tpu_torch.train.steps import make_train_step

    cs.phase_device()
    cs.phase_build()
    cfg = cs.full_width_config(cs.FLAGSHIP, "autocast_cache")
    train = cs.synth_pair_arrays(np.random.default_rng(0), 1024,
                                 cfg.data.max_len,
                                 cfg.model.encoder.vocab_size,
                                 cfg.model.bow_dim)
    B, nb = cfg.train.batch_size, -(-1024 // cfg.train.batch_size)
    state = init_state(cfg, "cuda")
    step = make_train_step(cfg)
    autocast = torch.autocast
    cs.eager_epoch(step, state, train, B, 0, 0.0).cpu()  # warm-up
    try:
        for i, cache in enumerate((True, False, False, True, True, False)):
            if cache:
                torch.autocast = lambda *a, **k: autocast(
                    *a, **{**k, "cache_enabled": True})
            else:
                torch.autocast = autocast
            ms, kernels, per_kernel = cs.profile_epoch(
                lambda: cs.eager_epoch(step, state, train, B, i + 1, 0.0), nb)
            adam = sum(us for name, (us, _) in per_kernel.items()
                       if "adam" in name.lower()) / 1e3 / nb
            print(f"autocast cache {'on' if cache else 'off'}: device "
                  f"{ms:.3f} ms/step, {kernels:.1f} kernels/step, fused Adam "
                  f"{adam:.3f} ms/step", flush=True)
            if i < 2:
                top = sorted(per_kernel.items(), key=lambda kv: -kv[1][0])
                for name, (us, calls) in top[:8]:
                    print(f"  {us / 1e3 / nb:8.3f} ms/step {calls // nb:5d} "
                          f"calls/step  {name[:90]}", flush=True)
    finally:
        torch.autocast = autocast
    return 0


if __name__ == "__main__":
    sys.exit(main())
