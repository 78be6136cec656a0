"""carel_tpu_torch: the PyTorch/CUDA port of carel_tpu for one NVIDIA H100.

The JAX package ``carel_tpu`` stays the reference; this package imports
nothing of it (nor of jax, flax, optax or orbax) and keeps its own copies of
the jax-free modules it needs. Layout mirrors the JAX package:

- ``config``    dataclasses and every preset
- ``data``      ECPE ingest: parser, pair construction, BoW, tokenizer, batching
- ``models``    encoder, VAE heads, discriminators, DrlModel
- ``ops``       plain statistics and losses, and the hand-written CUDA kernels
                (fused MMD^2, fused BoW decoder loss) and the nvcc build
- ``losses``    classifier, VAE and regularizer losses
- ``train``     optimizer state, train/eval steps, loop, metrics, checkpoints
- ``pipeline``  config -> datasets -> sized config
- ``cli``       ``python -m carel_tpu_torch.cli train|presets``
- ``convert``   JAX DrlModel params -> this package's state_dict

Entry points run on the card unless the caller asks for the CPU
(``device.resolve_device``).
"""

__version__ = "0.1.0"
