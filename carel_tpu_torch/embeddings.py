"""Sentence embeddings: the encoder embedder, contrastive domain
fine-tuning and the clause-keywords loader for clustering experiments; port
of carel_tpu/embeddings.py.

The reference fine-tunes a downloaded SimCSE / mpnet model with the
batch-all triplet loss on domain labels (chi/en[_ec]_sentence_transformer.py)
and encodes per-emotion cause-clause lists to vectors (ECPE_dataset.py:
39-149). Neither machine can download those models, so the embedder is the
port's own TransformerEncoder (optionally started from a local checkpoint
through models/hf_port.py) fine-tuned with the same objective. As in JAX:

- the embedding is the pooler output in fp32, optionally L2-normalised with
  the norm clamped at 1e-9, computed without gradient;
- the loss is the mean over the triplets of positive loss of
  max(d(a, p) - d(a, n) + margin, 0), from the ``[B, B, B]`` triplet tensor
  and d = sqrt(max(d^2, 1e-12));
- training is Adam (eps 1e-8), batches drawn by ``numpy.default_rng(seed)``
  (a shuffle an epoch, the last partial batch dropped), dropout on.

Where there are fewer texts than one batch the JAX trainer runs no step and
then fails on an unbound ``loss``; this one raises a ValueError that names
both counts.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from carel_tpu_torch.config import EncoderConfig
from carel_tpu_torch.data.ecpe_format import parse_ecpe_file
from carel_tpu_torch.data.tokenizer import BaseTokenizer
from carel_tpu_torch.device import resolve_device
from carel_tpu_torch.models.encoder import TransformerEncoder, init_flax_
from carel_tpu_torch.train.state import adam


def _encoder_on(encoder_cfg: EncoderConfig,
                params: Optional[Dict[str, torch.Tensor]], seed: int,
                device: torch.device) -> TransformerEncoder:
    """The encoder on ``device``: ``params`` (a state_dict), or Flax-style
    random init from ``seed`` (a CPU generator)."""
    model = TransformerEncoder(encoder_cfg)
    if params is None:
        init_flax_(model, torch.Generator().manual_seed(seed))
    else:
        model.load_state_dict(params)
    return model.to(device)


class EncoderEmbedder:
    """Callable List[str] -> np.ndarray [N, D] of the encoder's pooler
    output (fp32), in batches of ``batch_size`` texts (the last one
    shorter), on ``device`` (the GPU unless "cpu" is asked for). ``params``
    is the encoder's state_dict, or None for Flax-style random weights from
    seed 0."""

    def __init__(self, encoder_cfg: EncoderConfig,
                 params: Optional[Dict[str, torch.Tensor]],
                 tokenizer: BaseTokenizer,
                 max_len: int = 128, batch_size: int = 256,
                 normalize: bool = False, device="cuda"):
        self.cfg = encoder_cfg
        self.tokenizer = tokenizer
        self.max_len = max_len
        self.batch_size = batch_size
        self.normalize = normalize
        self.device = resolve_device(device)
        self.model = _encoder_on(encoder_cfg, params, 0, self.device).eval()

    @torch.no_grad()
    def embed_batch(self, texts: Sequence[str]) -> torch.Tensor:
        """The embeddings of one batch of texts, on the device."""
        enc = self.tokenizer.encode_batch(list(texts), self.max_len)
        ids, mask, types = (torch.from_numpy(np.asarray(a)).to(self.device)
                            for a in (enc.input_ids, enc.attention_mask,
                                      enc.token_type_ids))
        _, pooled = self.model(ids, mask, types, deterministic=True)
        pooled = pooled.float()
        if self.normalize:
            pooled = pooled / torch.clamp_min(
                torch.linalg.vector_norm(pooled, dim=-1, keepdim=True), 1e-9)
        return pooled

    def __call__(self, texts: Sequence[str]) -> np.ndarray:
        outs = [self.embed_batch(texts[s: s + self.batch_size])
                for s in range(0, len(texts), self.batch_size)]
        if not outs:
            return np.zeros((0, 1))
        return torch.cat(outs).cpu().numpy()


def batch_all_triplet_loss(embeddings: torch.Tensor, labels: torch.Tensor,
                           margin: float = 5.0) -> torch.Tensor:
    """BatchAll triplet loss (sentence_transformers.losses.BatchAllTripletLoss
    semantics): mean over all valid (a, p, n) triplets of
    max(d(a,p) - d(a,n) + margin, 0), counting only positive-loss triplets.
    ``torch.maximum`` splits the gradient of a tie in half, as
    ``jnp.maximum`` does."""
    sq = torch.sum(embeddings ** 2, 1)
    d2 = sq[:, None] + sq[None, :] - 2 * embeddings @ embeddings.T
    dist = torch.sqrt(torch.maximum(d2, d2.new_tensor(1e-12)))
    same = (labels[:, None] == labels[None, :]).float()
    eye = torch.eye(labels.shape[0], dtype=torch.float32,
                    device=embeddings.device)
    pos_mask = same - eye
    neg_mask = 1.0 - same
    # triplet tensor [a, p, n]
    tl = dist[:, :, None] - dist[:, None, :] + margin
    valid = pos_mask[:, :, None] * neg_mask[:, None, :]
    tl = torch.maximum(tl * valid, tl.new_tensor(0.0))
    num_pos = torch.sum((tl > 1e-16).float())
    return torch.sum(tl) / torch.clamp_min(num_pos, 1.0)


@dataclass(frozen=True)
class EmbedderTrainConfig:
    batch_size: int = 32
    epochs: int = 9  # chi_sentence_transformer.py:17
    learning_rate: float = 2e-5
    margin: float = 5.0
    max_len: int = 200  # reference sets max_seq_length=200
    seed: int = 42


def make_embedder_step(cfg: EmbedderTrainConfig, model: TransformerEncoder,
                       optimizer: torch.optim.Optimizer) -> Callable:
    """One eager step: ``step(ids, mask, types, labels) -> loss`` (a 0-d
    tensor on the device, not synchronized); dropout on."""

    def step(ids, mask, types, labels) -> torch.Tensor:
        optimizer.zero_grad(set_to_none=True)
        _, pooled = model(ids, mask, types, deterministic=False)
        loss = batch_all_triplet_loss(pooled.float(), labels, cfg.margin)
        loss.backward()
        optimizer.step()
        return loss.detach()

    return step


def train_domain_embedder(
    cfg: EmbedderTrainConfig,
    encoder_cfg: EncoderConfig,
    tokenizer: BaseTokenizer,
    texts: Sequence[str],
    labels: Sequence[int],
    init_params: Optional[Dict[str, torch.Tensor]] = None,
    logger=None,
    device="cuda",
) -> Dict[str, torch.Tensor]:
    """Fine-tune the encoder with batch-all triplet loss on domain labels;
    returns its state_dict (on ``device``). ``init_params`` (a state_dict)
    replaces the random init from ``cfg.seed``; dropout draws from the
    device's default generator, seeded from ``cfg.seed``. Each epoch logs an
    "embedder_epoch" event with the loss of its last step."""
    n = len(texts)
    if n < cfg.batch_size:
        raise ValueError(
            f"train_domain_embedder: {n} texts, fewer than one batch of "
            f"{cfg.batch_size}: no step would run")
    device = resolve_device(device)
    torch.manual_seed(cfg.seed)
    model = _encoder_on(encoder_cfg, init_params, cfg.seed, device).train()
    step = make_embedder_step(cfg, model,
                              adam(list(model.parameters()),
                                   cfg.learning_rate, device))
    enc = tokenizer.encode_batch(list(texts), cfg.max_len)
    arrays = [torch.from_numpy(np.asarray(a)) for a in (
        enc.input_ids, enc.attention_mask, enc.token_type_ids,
        np.asarray(labels, np.int32))]
    data_rng = np.random.default_rng(cfg.seed)
    for epoch in range(cfg.epochs):
        order = np.arange(n)
        data_rng.shuffle(order)
        for s in range(0, n - cfg.batch_size + 1, cfg.batch_size):
            idx = torch.from_numpy(order[s: s + cfg.batch_size])
            loss = step(*(a[idx].to(device) for a in arrays))
        if logger:
            logger.log({"event": "embedder_epoch", "epoch": epoch + 1,
                        "loss": float(loss)})
    return model.state_dict()


def load_domain_docs(paths: Dict[str, str]) -> Tuple[List[str], List[int]]:
    """(doc_text, domain_label) pairs from ECPE files, one label per file
    (the chi/en_sentence_transformer corpus construction)."""
    texts, labels = [], []
    for label, (name, path) in enumerate(sorted(paths.items())):
        for doc in parse_ecpe_file(path):
            content = "".join(
                cl.text_field3.strip().replace(" ", "") for cl in doc.clauses)
            texts.append(content)
            labels.append(label)
    return texts, labels


def load_clause_keywords(
    path: str,
    source_doc_ids: Sequence[str],
    target_doc_ids: Sequence[str],
) -> Tuple[Dict[str, List[str]], Dict[str, List[str]]]:
    """Per-emotion cause-clause lists for source/target domains.

    Parses data/clause_keywords_emotion.txt
    ("doc_id,emotion,clause_id,keyword,rel_pos,is_cause,clause",
    ECPE_dataset.py:39-103): clauses with is_cause == "yes" bucket under
    cau_<emotion>, the rest under cau_none.
    """
    s_ids = set(map(str, source_doc_ids))
    t_ids = set(map(str, target_doc_ids))
    emotions = ["happiness", "sadness", "disgust", "surprise", "fear", "anger"]
    s_stat = {f"cau_{e}": [] for e in emotions + ["none"]}
    t_stat = {f"cau_{e}": [] for e in emotions + ["none"]}
    with open(path, encoding="utf8") as f:
        for line in f:
            parts = line.rstrip("\n").split(",")
            if len(parts) < 7:
                continue
            doc_id, emotion, flag = parts[0], parts[1], parts[5]
            clause = parts[-1].replace(" ", "")
            stat = s_stat if doc_id in s_ids else (
                t_stat if doc_id in t_ids else None)
            if stat is None:
                continue
            if flag == "yes" and emotion in emotions:
                stat[f"cau_{emotion}"].append(clause)
            else:
                stat["cau_none"].append(clause)
    return s_stat, t_stat


def save_embeddings(path: str, embeddings: np.ndarray,
                    labels: Optional[np.ndarray] = None) -> str:
    """Cache embeddings (+ optional labels) as .npz, the
    ECPE_dataset_v1.py precomputed-split pattern."""
    if labels is None:
        np.savez(path, embeddings=np.asarray(embeddings))
    else:
        np.savez(path, embeddings=np.asarray(embeddings),
                 labels=np.asarray(labels))
    return path if path.endswith(".npz") else path + ".npz"


def load_embeddings(path: str):
    """(embeddings, labels-or-None) from a save_embeddings .npz."""
    data = np.load(path if path.endswith(".npz") else path + ".npz")
    return data["embeddings"], (data["labels"] if "labels" in data else None)
