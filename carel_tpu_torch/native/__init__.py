"""Host-side ingest in C (the counterpart of carel_tpu/native/).

``build`` compiles ``csrc/fastingest.c`` with the system C compiler into
``build/carel_tpu_torch/`` at first use; ``fast_tokenizer`` encodes
ZhCharTokenizer batches through it. Where no compiler or no Python headers
are found, ``load_fastingest`` gives None and the tokenizer keeps its Python
loop. This is host ingest, not a device kernel: it has a fallback on
purpose, unlike the CUDA kernels of ``ops/``.
"""
