"""Serving: batched pair inference over a domain file and raw-text scoring."""

from carel_tpu_torch.infer.pair_inference import (InferenceResult,
                                                  run_pair_inference,
                                                  score_pairs)
from carel_tpu_torch.infer.scorer import PairScorer

__all__ = ["InferenceResult", "PairScorer", "run_pair_inference",
           "score_pairs"]
