"""Masked-language-model pretraining for the encoder, and the port's encoder
and MLM directories; port of carel_tpu/pretrain/mlm.py.

As in JAX: the BERT recipe (``mask_prob`` of the real non-special positions;
of those 80 % [MASK], 10 % a random id, 10 % kept; optional whole-word
masking), the encoder's hidden state cast to fp32 under an untied head
(Dense d->d, exact GELU, LayerNorm at Flax's eps 1e-6, Dense d->V), the
masked mean of the negative log-likelihood, and AdamW (weight decay 0.01,
eps 1e-8) under optax's ``linear_schedule(0, lr, warmup)`` or, with
``lr_decay``, ``warmup_cosine_decay_schedule(0, lr, warmup, steps, 0.1
lr)``, read at the count of updates made before it (``lr_at``: the first
update has lr 0). The whole tokenized corpus (and the word starts) lives on
the device; each step draws its batch indices (with replacement), two
uniforms and the random ids from one ``torch.Generator`` on the device
(``draw_noise``).

JAX runs the head over every position and lets the loss weigh the
unmasked ones by 0. The trainer runs it over the masked rows alone: a
step's flat positions, masked ones first in row-major order, the first C
of them gathered from the hidden state, each weighted 1 if masked and 0 if
a pad (a pad row is an unmasked position, so no row repeats and the
gather's backward writes each row once). That is the same loss and the
same gradients, up to fp32 summation order. C (``head_capacity``) is set
once from the corpus: the expected masked count of a step plus 6 standard
deviations, rounded up to a multiple of 128, and never above what a batch
of the longest rows could mask. A step that masks more than C rows runs
eagerly over exactly its masked rows (``full_steps``).

JAX fuses ``scan_size`` steps into one ``lax.scan`` dispatch. Here a
dispatch first makes all its steps' draws (one small captured graph,
replayed once a step, in the generator's order: the steps draw nothing
else), fetches their masked counts in one copy, then replays one captured
step at capacity C on each step that fits and runs the others eagerly, its
lr formed on the device from a step counter. Warm-up and capture do not
change the run (``train/scan_epoch.Snapshot``). The CPU, and ``capture``
off, run the same draws, rows and fallback eagerly. Whole dispatches run,
so ``steps=10, scan_size=4`` trains 12 steps, and each logs one
``mlm_step`` event with the dispatch's mean loss, as in JAX.

Directories (JAX's are orbax checkpoints, which the port does not read):

- the encoder dir: one file, ``encoder.pt``, the ``TransformerEncoder``
  state_dict in fp32 (``save_encoder``/``load_encoder``). It holds no
  config: it is read into an encoder built from the configured
  ``EncoderConfig`` (``models/hf_port.load_encoder_checkpoint`` sizes the
  tables to the file's). ``pretrain --out`` and ``embed --out`` write one;
  every ``--hf_encoder`` reads one;
- the MLM dir (``pretrain --save_mlm``): one file, ``mlm.pt``, the whole
  ``MlmModel`` state_dict (encoder and head) in fp32
  (``save_mlm``/``load_mlm``), which ``tools/mlm_scorer.py`` reads. The
  tokenizer it was trained with lies beside it as ``<dir>.tokenizer.json``.
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from carel_tpu_torch.config import EncoderConfig
from carel_tpu_torch.models.encoder import TransformerEncoder, init_flax_
from carel_tpu_torch.utils.profiling import span

ENCODER_FILE = "encoder.pt"
MLM_FILE = "mlm.pt"
# Flax's LayerNorm default; the encoder's own LayerNorms take
# cfg.layer_norm_eps
MLM_LN_EPS = 1e-6
# ids up to [MASK] = 4 are specials (never masked), and the random
# replacements start above them
LAST_SPECIAL_ID = 4
# the head's capacity: a step's expected masked rows plus this many
# standard deviations, rounded up to a multiple of HEAD_ROUND
HEAD_SDS, HEAD_ROUND = 6, 128


class MlmModel(nn.Module):
    """The encoder, then the untied MLM head over its hidden state in fp32:
    logits [B, L, V] (fp32)."""

    def __init__(self, cfg: EncoderConfig):
        super().__init__()
        d = cfg.hidden_dim
        self.encoder = TransformerEncoder(cfg)
        self.mlm_transform = nn.Linear(d, d)
        self.mlm_ln = nn.LayerNorm(d, eps=MLM_LN_EPS)
        self.mlm_output = nn.Linear(d, cfg.vocab_size)

    def hidden(self, input_ids: torch.Tensor,
               attention_mask: torch.Tensor) -> torch.Tensor:
        """The encoder's last hidden state in fp32 [B, L, D] (no dropout,
        as JAX's ``deterministic=True``)."""
        hidden, _ = self.encoder(input_ids, attention_mask, None,
                                 deterministic=True, pool=False)
        return hidden.float()

    def head(self, h: torch.Tensor) -> torch.Tensor:
        """The MLM head on fp32 hidden states [..., D] -> logits [..., V],
        in fp32 outside any autocast."""
        with torch.autocast(device_type=h.device.type, enabled=False):
            h = F.gelu(self.mlm_transform(h), approximate="none")
            return self.mlm_output(self.mlm_ln(h))

    def forward(self, input_ids: torch.Tensor,
                attention_mask: torch.Tensor) -> torch.Tensor:
        return self.head(self.hidden(input_ids, attention_mask))


@dataclass(frozen=True)
class MlmConfig:
    batch_size: int = 256
    seq_len: int = 64
    steps: int = 2000
    warmup_steps: int = 200
    learning_rate: float = 1e-4
    mask_prob: float = 0.15
    seed: int = 42
    # steps a dispatch: one captured step replayed this many times
    scan_size: int = 50
    # whole-word masking: every token of a word reads its first token's
    # draws (jieba words for zh, "##"-joined WordPiece pieces for en)
    whole_word: bool = False
    language: str = "zh"
    # cosine decay to 10% of peak after warmup; constant after it otherwise
    lr_decay: bool = False
    # encoder snapshots "{save_path}_step{N}" every save_every steps
    save_every: int = 0
    save_path: str = ""
    # the whole MlmModel (encoder and head) at the end, for the scorer
    save_full_path: str = ""


def make_mlm_batches(texts: Sequence[str], tokenizer, cfg: MlmConfig
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """Tokenize the corpus once into [N, L] ids and masks."""
    enc = tokenizer.encode_batch(list(texts), cfg.seq_len)
    return enc.input_ids, enc.attention_mask


def make_word_starts(texts: Sequence[str], tokenizer, seq_len: int,
                     language: str, segmenter=None) -> np.ndarray:
    """[N, L] index of the first token of the word holding each position;
    specials and padding point at themselves. zh: jieba words over the
    space-stripped clause (one token a char), through ``segmenter``
    (``data.bow.SegmentationCache``) when one is given; en: a WordPiece
    ``##`` piece continues the previous word."""
    n = len(texts)
    out = np.tile(np.arange(seq_len, dtype=np.int32), (n, 1))
    if language == "zh":
        if segmenter is None:
            import jieba

            cut = jieba.lcut
        else:
            cut = segmenter.cut
        for i, t in enumerate(texts):
            t = "".join(ch for ch in str(t) if not ch.isspace())
            pos = 1  # 0 is [CLS]
            for word in cut(t):
                start = pos
                for _ in word:
                    if pos < seq_len:
                        out[i, pos] = min(start, seq_len - 1)
                    pos += 1
    else:
        id_to_token = {}
        if hasattr(tokenizer, "_tok"):
            id_to_token = {v: k for k, v in tokenizer._tok.get_vocab().items()}
        for i, t in enumerate(texts):
            ids = tokenizer.tokenize_to_ids(str(t))
            pos, start = 1, 1
            for tid in ids:
                if not id_to_token.get(tid, "").startswith("##"):
                    start = pos
                if pos < seq_len:
                    out[i, pos] = min(start, seq_len - 1)
                pos += 1
    return out


def lr_at(cfg: MlmConfig, count: torch.Tensor) -> torch.Tensor:
    """The lr of the update after ``count`` updates (a 0-d fp32 tensor, on
    the device in a captured step), in fp32 as optax forms it:
    ``linear_schedule(0, lr, warmup)``, 0 throughout when warmup is 0; with
    ``lr_decay``, ``warmup_cosine_decay_schedule(0, lr, warmup, steps,
    0.1 lr)``, whose cosine spans steps - warmup after the warmup."""
    lr, warmup = cfg.learning_rate, cfg.warmup_steps

    def linear(c):
        if warmup <= 0:
            return torch.zeros_like(c)
        frac = 1 - torch.clamp(c, 0, warmup) / warmup
        return (0.0 - lr) * frac + lr

    if not cfg.lr_decay:
        return linear(count)
    decay_steps = cfg.steps - warmup
    if not decay_steps > 0:
        raise ValueError("the cosine schedule requires steps > warmup_steps, "
                         f"got steps={cfg.steps}, warmup={warmup}")
    end = lr * 0.1
    alpha = 0.0 if lr == 0.0 else end / lr
    c = torch.clamp(count - warmup, max=decay_steps)
    cosine = 0.5 * (1 + torch.cos(math.pi * c / decay_steps))
    decayed = lr * ((1 - alpha) * cosine + alpha)
    return torch.where(count < warmup, linear(count), decayed)


def draw_noise(generator: torch.Generator, n: int, shape: Tuple[int, int],
               vocab_size: int, device: torch.device):
    """A step's draws from ``generator``, in this order: the batch indices
    [B] in [0, n) (with replacement), the mask uniform u and the branch
    uniform u2 [B, L] in [0, 1), the random ids [B, L] in [5, vocab_size).
    Every draw of the trainer goes through here."""
    idx = torch.randint(0, n, shape[:1], generator=generator, device=device)
    u = torch.rand(shape, generator=generator, device=device)
    u2 = torch.rand(shape, generator=generator, device=device)
    rand_ids = torch.randint(LAST_SPECIAL_ID + 1, vocab_size, shape,
                             generator=generator, device=device)
    return idx, u, u2, rand_ids


def mask_id_of(tokenizer) -> int:
    """The [MASK] id: the tokenizer's, or 4 when it keeps no
    ``token_to_id`` (the char and WordPiece tokenizers reserve 4)."""
    if hasattr(tokenizer, "token_to_id"):
        return getattr(tokenizer, "token_to_id", {}).get("[MASK]", 4)
    return 4


def _adamw(params, lr: float, device: torch.device):
    """optax.adamw(lr, weight_decay=0.01, eps=1e-8): on CUDA fused and
    capturable, its lr a 0-d device tensor that a captured step writes."""
    kw = dict(betas=(0.9, 0.999), eps=1e-8, weight_decay=0.01)
    if device.type == "cuda":
        return torch.optim.AdamW(
            params, lr=torch.tensor(lr, dtype=torch.float32, device=device),
            capturable=True, fused=True, **kw)
    return torch.optim.AdamW(params, lr=lr, **kw)


def head_capacity(ids: torch.Tensor, attn: torch.Tensor,
                  word_starts: Optional[torch.Tensor], batch_size: int,
                  mask_prob: float) -> int:
    """The rows a captured step's MLM head runs over: the expected masked
    count of a step over the corpus ``ids``/``attn`` [N, L] plus
    HEAD_SDS standard deviations, rounded up to a multiple of HEAD_ROUND,
    and at most ``batch_size`` times the most candidates in a row, where no
    step can mask more. A step masks the sum of ``batch_size`` rows drawn
    with replacement; a row of c candidates masks each with probability p,
    or under whole-word masking (``word_starts``) each word of l candidates
    l at a time, so a row's variance is p(1 - p) sum(l^2) + p^2 Var(c)."""
    cand = (attn > 0) & (ids > LAST_SPECIAL_ID)
    per_row = cand.sum(1, dtype=torch.float64)
    if word_starts is None:
        squares = per_row
    else:
        words = torch.zeros(cand.shape, dtype=torch.float64,
                            device=cand.device)
        words.scatter_add_(1, word_starts, cand.double())
        squares = (words * words).sum(1)
    mean_c, var_c, mean_sq, most = torch.stack([
        per_row.mean(), per_row.var(correction=0), squares.mean(),
        per_row.max()]).tolist()
    p, B = mask_prob, batch_size
    sd = math.sqrt(B * (p * (1 - p) * mean_sq + p * p * var_c))
    margin = math.ceil((B * p * mean_c + HEAD_SDS * sd) / HEAD_ROUND)
    return max(1, min(int(B * most), margin * HEAD_ROUND))


class MlmTrainer:
    """The model, its AdamW, the sampling generator (seeded ``cfg.seed`` on
    the device), the update counter, the device-resident corpus and the
    head's capacity (``capacity``, from ``head_capacity``). ``draw()``
    makes one step's inputs; ``train(inputs, rows)`` trains one step on
    them with the head over ``rows`` rows and returns its loss (a 0-d
    device tensor); ``dispatch(n)`` draws n steps, then trains them (on
    CUDA a captured step at ``capacity`` replayed on each step that fits,
    unless ``capture`` is off) and returns their mean loss. After a step
    each parameter's ``.grad`` holds the step's gradient (the pooler, which
    the loss never reads, a zero one: optax still decays it).

    Counters: ``captures`` (each makes the draw graph and the step graph),
    ``replays`` of the step, the kernel launches of the captured step
    (``captured_launches``; a replay adds them to the ops' launch counts,
    the capture and its warm-up add nothing), and over every step the rows
    ``masked``, the ``head_rows`` the head ran over and the ``full_steps``
    that masked more than ``capacity`` and ran over exactly their masked
    rows. Under a profiler a captured dispatch records the spans
    ``mlm.draws`` (with that dispatch's three counts) and
    ``mlm.replays``."""

    def __init__(self, model: MlmModel, cfg: MlmConfig, ids: np.ndarray,
                 mask: np.ndarray, word_starts: Optional[np.ndarray],
                 mask_id: int, device, capture: bool = True):
        self.model, self.cfg, self.mask_id = model, cfg, mask_id
        self.device = torch.device(device)
        self.vocab_size = model.encoder.cfg.vocab_size
        self.ids = torch.from_numpy(np.asarray(ids)).to(self.device)
        self.attn = torch.from_numpy(np.asarray(mask)).to(self.device)
        self.word_starts = (None if word_starts is None else torch.from_numpy(
            np.asarray(word_starts, np.int64)).to(self.device))
        self.capacity = head_capacity(self.ids, self.attn, self.word_starts,
                                      cfg.batch_size, cfg.mask_prob)
        self.params = list(model.parameters())
        self.optimizer = _adamw(self.params, cfg.learning_rate, self.device)
        self.generator = torch.Generator(device=self.device).manual_seed(
            cfg.seed)
        self.count = torch.zeros((), dtype=torch.float32, device=self.device)
        # gradients live across steps, each step zeroes them first
        for p in self.params:
            p.grad = torch.zeros_like(p)
        self.capture = capture and self.device.type == "cuda"
        self.captures = self.replays = 0
        self.masked = self.head_rows = self.full_steps = 0
        self.captured_launches: dict = {}
        self._draw_graph = self._drawn = None
        self._graph = self._inputs = self._loss = None

    def draw(self) -> Dict[str, torch.Tensor]:
        """One step's draws and what they make of its batch: the
        ``corrupted`` ids and the ``attn`` mask the encoder reads, the
        original ``ids`` (the targets), the flat positions in ``order``
        (the masked ones first, then the rest, each in row-major order) and
        the masked ``count`` (a 0-d tensor)."""
        cfg = self.cfg
        B, L = cfg.batch_size, cfg.seq_len
        idx, u, u2, rand_ids = draw_noise(self.generator, len(self.ids),
                                          (B, L), self.vocab_size,
                                          self.device)
        ids = self.ids.index_select(0, idx).long()
        attn = self.attn.index_select(0, idx)
        candidates = (attn > 0) & (ids > LAST_SPECIAL_ID)
        if self.word_starts is not None:
            # whole word: both draws are read at the word's first token
            ws = self.word_starts.index_select(0, idx)
            u = torch.gather(u, 1, ws)
            u2 = torch.gather(u2, 1, ws)
        is_masked = (u < cfg.mask_prob) & candidates
        replace_mask = is_masked & (u2 < 0.8)
        replace_rand = is_masked & (u2 >= 0.8) & (u2 < 0.9)
        corrupted = torch.where(
            replace_mask, torch.full_like(ids, self.mask_id),
            torch.where(replace_rand, rand_ids.long(), ids))
        flat = is_masked.view(-1)
        count = flat.sum()
        place = torch.where(flat, flat.cumsum(0), count + (~flat).cumsum(0))
        order = torch.empty_like(place).scatter_(
            0, place - 1, torch.arange(B * L, device=self.device))
        return {"corrupted": corrupted, "attn": attn, "ids": ids,
                "order": order, "count": count}

    def train(self, inputs: Dict[str, torch.Tensor], rows: int
              ) -> torch.Tensor:
        """One step on ``draw()``'s ``inputs``, the head over the first
        ``rows`` positions of their ``order``; returns the loss."""
        torch._foreach_zero_([p.grad for p in self.params])
        hidden = self.model.hidden(inputs["corrupted"], inputs["attn"])
        at = inputs["order"][:rows]
        h = hidden.reshape(-1, hidden.shape[-1]).index_select(0, at)
        nll = F.cross_entropy(self.model.head(h),
                              inputs["ids"].view(-1).index_select(0, at),
                              reduction="none")
        w = (torch.arange(rows, device=self.device) < inputs["count"]).float()
        loss = (nll * w).sum() / torch.clamp(w.sum(), min=1.0)
        loss.backward()
        lr = lr_at(self.cfg, self.count)
        for group in self.optimizer.param_groups:
            if isinstance(group["lr"], torch.Tensor):
                group["lr"].copy_(lr)
            else:
                group["lr"] = float(lr)
        self.optimizer.step()
        self.count += 1
        return loss.detach()

    def _head_rows(self, drawn) -> Tuple[list, dict]:
        """The head's rows for each drawn step, ``capacity`` or, where the
        step masks more, its masked count (one fetch for all of them), and
        the steps' counts, which the trainer's counters add up."""
        masked = torch.stack([x["count"] for x in drawn]).tolist()
        rows = [max(m, self.capacity) for m in masked]
        counts = {"masked": sum(masked), "head_rows": sum(rows),
                  "full_steps": sum(m > self.capacity for m in masked)}
        self.masked += counts["masked"]
        self.head_rows += counts["head_rows"]
        self.full_steps += counts["full_steps"]
        return rows, counts

    def dispatch(self, n: int) -> torch.Tensor:
        if not self.capture:
            drawn = [self.draw() for _ in range(n)]
            rows, _ = self._head_rows(drawn)
            return torch.stack([self.train(x, r)
                                for x, r in zip(drawn, rows)]).mean()
        from carel_tpu_torch import ops

        if self._graph is None:
            self._capture()
        with span("mlm.draws") as record:
            drawn = []
            for _ in range(n):
                self._draw_graph.replay()
                drawn.append({k: v.clone() for k, v in self._drawn.items()})
            rows, counts = self._head_rows(drawn)
            if record is not None:
                record.counts.update(counts)
        replays = 0
        with span("mlm.replays"):
            losses = torch.empty(n, dtype=torch.float32, device=self.device)
            for i, (inputs, r) in enumerate(zip(drawn, rows)):
                if r == self.capacity:
                    for k, v in inputs.items():
                        self._inputs[k].copy_(v)
                    self._graph.replay()
                    losses[i].copy_(self._loss)
                    replays += 1
                else:
                    losses[i].copy_(self.train(inputs, r))
        self.replays += replays
        ops.add_launches(self.captured_launches, replays)
        return losses.mean()

    def _capture(self) -> None:
        """The draw graph, then the step graph at ``capacity`` over inputs
        of one draw made for its warm-up; the snapshot rolls back what
        either warm-up, capture or that draw changed."""
        from carel_tpu_torch.train.scan_epoch import Snapshot, capture_graph
        from carel_tpu_torch.train.state import dropout_generator

        snapshot = Snapshot(self.params, [self.optimizer],
                            [self.generator, dropout_generator(self.device)],
                            [self.count])
        self._draw_graph, self._drawn, _, _ = capture_graph(
            self.draw, snapshot.restore, self.generator, self.device)
        self._inputs = self.draw()
        self._graph, self._loss, _, self.captured_launches = capture_graph(
            lambda: self.train(self._inputs, self.capacity),
            snapshot.restore, self.generator, self.device)
        self.captures += 1


def build_mlm(encoder_cfg: EncoderConfig, seed: int,
              init_params: Optional[Dict[str, torch.Tensor]] = None
              ) -> MlmModel:
    """MlmModel with Flax-style random init from ``seed`` (a CPU
    generator), its encoder replaced by ``init_params`` when given."""
    model = MlmModel(encoder_cfg)
    init_flax_(model, torch.Generator().manual_seed(seed))
    if init_params is not None:
        model.encoder.load_state_dict(init_params)
    return model


def pretrain_mlm(
    encoder_cfg: EncoderConfig,
    tokenizer,
    texts: Sequence[str],
    cfg: MlmConfig = MlmConfig(),
    logger=None,
    init_params: Optional[Dict[str, torch.Tensor]] = None,
    device="cuda",
    model: Optional[MlmModel] = None,
    capture: bool = True,
    segmenter=None,
) -> Dict[str, torch.Tensor]:
    """Run MLM pretraining; returns the encoder's state_dict (on
    ``device``). ``model`` replaces the random init (``build_mlm``);
    ``capture=False`` runs the CUDA steps eagerly; ``segmenter`` gives zh
    whole-word masking its words (jieba when None)."""
    from carel_tpu_torch.device import resolve_device

    device = resolve_device(device)
    ids, mask = make_mlm_batches(texts, tokenizer, cfg)
    ws = (make_word_starts(texts, tokenizer, cfg.seq_len, cfg.language,
                           segmenter)
          if cfg.whole_word else None)
    if model is None:
        model = build_mlm(encoder_cfg, cfg.seed, init_params)
    trainer = MlmTrainer(model.to(device), cfg, ids, mask, ws,
                         mask_id_of(tokenizer), device, capture=capture)
    scan_size = max(1, min(cfg.scan_size, cfg.steps))
    done = last_saved = 0
    while done < cfg.steps:
        loss = float(trainer.dispatch(scan_size))
        done += scan_size
        if logger:
            logger.log({"event": "mlm_step", "step": done, "loss": loss})
        if (cfg.save_every and cfg.save_path
                and done - last_saved >= cfg.save_every and done < cfg.steps):
            save_encoder(f"{cfg.save_path}_step{done}",
                         model.encoder.state_dict())
            last_saved = done
    if cfg.save_full_path:
        save_mlm(cfg.save_full_path, model.state_dict())
    return model.encoder.state_dict()


def is_encoder_dir(path: str) -> bool:
    """A directory written by ``save_encoder``: it holds encoder.pt."""
    return bool(path) and os.path.exists(os.path.join(path, ENCODER_FILE))


def _save_state(path: str, name: str, state: Dict[str, torch.Tensor]) -> str:
    path = os.path.abspath(path)
    os.makedirs(path, exist_ok=True)
    state = {k: v.detach().to("cpu", torch.float32).contiguous()
             for k, v in state.items()}
    tmp = os.path.join(path, name + ".tmp")
    torch.save(state, tmp)
    os.replace(tmp, os.path.join(path, name))
    return path


def _load_state(path: str, name: str) -> Dict[str, torch.Tensor]:
    return torch.load(os.path.join(path, name), map_location="cpu",
                      weights_only=True)


def save_encoder(path: str, encoder_state: Dict[str, torch.Tensor]) -> str:
    """Write the encoder's state_dict (as fp32 CPU tensors) to
    ``path/encoder.pt``; returns the directory's absolute path."""
    return _save_state(path, ENCODER_FILE, encoder_state)


def load_encoder(path: str) -> Dict[str, torch.Tensor]:
    """The encoder's state_dict from a ``save_encoder`` directory (CPU,
    fp32)."""
    return _load_state(path, ENCODER_FILE)


def save_mlm(path: str, mlm_state: Dict[str, torch.Tensor]) -> str:
    """Write the whole MlmModel's state_dict (fp32, CPU) to
    ``path/mlm.pt``; returns the directory's absolute path."""
    return _save_state(path, MLM_FILE, mlm_state)


def load_mlm(path: str) -> Dict[str, torch.Tensor]:
    """The MlmModel's state_dict from a ``save_mlm`` directory (CPU,
    fp32)."""
    if not os.path.exists(os.path.join(path, MLM_FILE)):
        raise FileNotFoundError(
            f"{path}: no {MLM_FILE}; write one with `pretrain --save_mlm` "
            "(an orbax directory of carel_tpu is not readable here)")
    return _load_state(path, MLM_FILE)
