"""ECPE ingest: copies of the jax-free carel_tpu.data modules the port needs."""

from carel_tpu_torch.data.bow import BowVocab, build_bow_vocab_en, build_bow_vocab_zh  # noqa: F401
from carel_tpu_torch.data.ecpe_format import Clause, Document, parse_ecpe_file, parse_ecpe_text, write_ecpe_file  # noqa: F401
from carel_tpu_torch.data.pairs import PairExample, PairSet, build_pairs  # noqa: F401
