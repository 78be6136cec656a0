"""Ops: plain PyTorch statistics and losses, and the hand-written CUDA
kernels that replace the JAX package's Pallas kernels.

- ``pairwise`` / ``bow_recon``: plain versions (run on the CPU, and the
  yardstick the kernels are held against);
- ``cuda_pairwise``: fused MMD^2, kernels K1 (forward) and K2 (backward),
  and HSIC, kernels K5 (forward) and K6 (backward);
- ``cuda_bow``: fused BoW decoder loss, kernels K3 (forward) and K4
  (backward);
- ``cuda_attention``: flash attention with a segment mask, kernels K7
  (forward), K8 (dK, dV) and K9 (dQ), behind ``attention_impl="flash"``;
- ``xla_attention``: the encoder's default attention core (key-padding
  bias, fp32 softmax, dropout on the bf16 probabilities) as plain ops, and
  on CUDA in bf16 one forward and one backward kernel;
- ``cuda_embedding``: the sum of the encoder's word, position and
  token-type lookups, with one backward for all three tables that adds in a
  fixed order, kernel K10;
- ``entmax``: sparsemax and entmax15 for the sparse attention adapters
  (plain ops on every device: the JAX package has no Pallas kernel for
  them);
- ``moe``: the routed experts of a mixture-of-experts layer over the
  experts a device holds: a dropless dispatch and the grouped products
  (Triton kernels on CUDA, built at the first launch);
- ``native``: builds ``csrc/*.cu`` with nvcc at first use and loads it.
"""

from carel_tpu_torch.ops import (cuda_attention, cuda_bow, cuda_embedding,
                                 cuda_pairwise, moe, xla_attention)

_COUNTS = (cuda_pairwise.launches, cuda_bow.launches, cuda_attention.launches,
           cuda_embedding.launches, moe.launches, xla_attention.launches)


def launch_counts() -> dict:
    """Kernel launches since the last ``reset_launch_counts``."""
    return {name: n for counts in _COUNTS for name, n in counts.items()}


def reset_launch_counts() -> None:
    for counts in _COUNTS:
        for name in counts:
            counts[name] = 0


def add_launches(launched: dict, times: int = 1) -> None:
    """Count ``times`` more of each launch in ``launched`` ({name: n}). A
    replay of a captured CUDA graph launches every kernel captured in it
    without running the wrappers; train/scan_epoch.py counts its replays
    here."""
    for counts in _COUNTS:
        for name in counts:
            counts[name] += launched.get(name, 0) * times
