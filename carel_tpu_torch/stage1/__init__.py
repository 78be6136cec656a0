"""Stage 1: document-level emotion detection and the pair files that feed
stage 2 (``trainer``), and the clause-level DANN classifier
(``dann_driver``)."""

from carel_tpu_torch.stage1.data import DocArrays, build_doc_arrays  # noqa: F401
from carel_tpu_torch.stage1.pair_writer import write_pair_data  # noqa: F401
from carel_tpu_torch.stage1.trainer import Stage1Config, train_stage1  # noqa: F401
