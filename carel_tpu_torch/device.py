"""Device selection and the numeric settings of the port, in one place.

Entry points take ``device="cuda"`` by default and run on the CPU only when
the caller asks for it (``device="cpu"``, ``--device cpu``). With no GPU and
no explicit CPU request they raise; they never carry on quietly on the CPU.

Numerics on CUDA: fp32 matrix products and convolutions run in full fp32.
TF32 is switched off because the Gram/pdist arithmetic of the MMD statistic
and the decoder products of the BoW loss must not drop to TF32 (the JAX
package pins the same products to Precision.HIGHEST for the same reason).
The encoder runs under bf16 autocast with LayerNorm in fp32
(``models/encoder.py``); the heads, MMD and BoW run in fp32.
"""

from __future__ import annotations

import torch


def set_numerics() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def resolve_device(device="cuda") -> torch.device:
    """The torch device to run on; raises when CUDA is asked for and absent."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' (CLI: "
            "--device cpu) to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}: use cuda or cpu")
    set_numerics()
    return dev
