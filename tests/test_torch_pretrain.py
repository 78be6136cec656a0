"""The port's MLM pretraining (carel_tpu_torch/pretrain/mlm.py) and the
pretrain verb against carel_tpu/pretrain/mlm.py, on the CPU at tiny widths
(tiny_encoder_config, dropout 0, fp32):

- MlmModel logits from JAX's init params, converted: within 1e-5
  normwise, a padded row included;
- make_word_starts: equal arrays, zh (jieba) and en (one saved WordPiece);
- lr_at against optax's linear and warmup-cosine schedules at counts 0, 1,
  warmup - 1, warmup, warmup + 1 and steps, bit for bit;
- pretrain_mlm from JAX's init (its key(seed) split repeated, converted)
  with the same draws injected into both (JAX's randint/uniform as its
  module sees them; the port's draw_noise): 3 steps at scan_size 1, and 4
  steps at scan_size 3, which trains 6 (JAX's overshoot): the mlm_step
  events' steps and losses (rel 1e-4) and the encoder's params: every
  entry within Adam's 2 lr a step, and within 1e-3 lr where its last
  gradient is not noise, above 1 % of its tensor's largest (over three
  steps Adam's ratio m/sqrt(v) drifts with the rounding where the gradient
  is small: one entry of layers.1.mlp_in.weight at 0.2 % of the largest
  moves 1.5e-3 lr from JAX's, all others at most 2.6e-4 lr); the
  attention key biases (gradient 0 in exact arithmetic) to 2 lr only;
- the MLM and encoder dirs round trip bit for bit;
- the pretrain verb on the CPU writes an encoder dir, the MLM dir and its
  pinned tokenizer (the same bytes as JAX's), and `train --hf_encoder
  <out>` starts from its bits.
"""

import json
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import carel_tpu.pretrain.mlm as jmlm
from carel_tpu.data.tokenizer import WordPieceTokenizer as JWP
from carel_tpu.data.tokenizer import ZhCharTokenizer as JZh
from carel_tpu.models.encoder import tiny_encoder_config as j_tiny

import carel_tpu_torch.pretrain.mlm as tmlm
from carel_tpu_torch.cli.main import main
from carel_tpu_torch.convert import jax_params_to_state_dict
from carel_tpu_torch.data.tokenizer import WordPieceTokenizer as TWP
from carel_tpu_torch.data.tokenizer import ZhCharTokenizer
from carel_tpu_torch.models.encoder import tiny_encoder_config

from tests.test_torch_adapters import _key_bias_entries
from tests.test_torch_data import synth_docs, write_newsplit_corpus
from tests.test_torch_tokenizer_en import en_texts


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _zh_texts(n_docs=16, seed=0):
    return [c.text.strip().replace(" ", "")
            for d in synth_docs(seed, n_docs) for c in d.clauses]


def _relnorm(got, want):
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                  1e-30))


def test_mlm_model_logits_match_jax():
    cfg = j_tiny(vocab_size=300, dropout=0.0)
    rng = np.random.default_rng(0)
    ids = rng.integers(5, 300, (3, 16)).astype(np.int32)
    mask = np.ones((3, 16), np.int32)
    mask[1, 9:] = 0
    params = jmlm.MlmModel(cfg).init(jax.random.key(1), jnp.asarray(ids),
                                     jnp.asarray(mask))["params"]
    want = np.asarray(jmlm.MlmModel(cfg).apply(
        {"params": params}, jnp.asarray(ids), jnp.asarray(mask)))
    model = tmlm.MlmModel(tiny_encoder_config(vocab_size=300, dropout=0.0))
    model.load_state_dict(jax_params_to_state_dict(_np(params)))
    with torch.no_grad():
        got = model(torch.from_numpy(ids), torch.from_numpy(mask)).numpy()
    assert got.shape == want.shape == (3, 16, 300)
    assert _relnorm(got, want) <= 1e-5


def test_make_word_starts_zh_matches_jax():
    texts = _zh_texts(6)
    jt, tt = JZh.from_corpus(texts), ZhCharTokenizer.from_corpus(texts)
    want = jmlm.make_word_starts(texts, jt, 24, "zh")
    got = tmlm.make_word_starts(texts, tt, 24, "zh")
    np.testing.assert_array_equal(got, want)
    # some word is longer than one char, so the map is not the identity
    assert (got != np.arange(24)[None]).any()


def test_make_word_starts_en_matches_jax(tmp_path):
    # words the small vocabulary splits into ## pieces
    texts = en_texts(0, 8) + ["succeededly homeworks parenting",
                              "misunderstood schoolwork"]
    path = str(tmp_path / "tokenizer_en.json")
    JWP.train_from_corpus(en_texts(), 400).save(path)
    want = jmlm.make_word_starts(texts, JWP.load(path), 24, "en")
    got = tmlm.make_word_starts(texts, TWP.load(path), 24, "en")
    np.testing.assert_array_equal(got, want)
    assert (got != np.arange(24)[None]).any()


@pytest.mark.parametrize("lr_decay", [False, True])
def test_schedules_match_optax(lr_decay):
    cfg = tmlm.MlmConfig(steps=40, warmup_steps=6, learning_rate=3e-4,
                         lr_decay=lr_decay)
    if lr_decay:
        want = optax.warmup_cosine_decay_schedule(
            0.0, cfg.learning_rate, cfg.warmup_steps, cfg.steps,
            end_value=cfg.learning_rate * 0.1)
    else:
        want = optax.linear_schedule(0.0, cfg.learning_rate,
                                     cfg.warmup_steps)
    w = cfg.warmup_steps
    for count in (0, 1, w - 1, w, w + 1, 23, cfg.steps, cfg.steps + 5):
        got = float(tmlm.lr_at(cfg, torch.tensor(float(count))))
        assert got == float(want(jnp.asarray(count, jnp.int32))), count
    assert float(tmlm.lr_at(cfg, torch.tensor(0.0))) == 0.0


class _Draws:
    """One step's draws, from a numpy seed, as both packages take them."""

    def __init__(self, n, B, L, vocab, seed=5):
        rng = np.random.default_rng(seed)
        self.idx = rng.integers(0, n, B).astype(np.int32)
        self.u = rng.random((B, L)).astype(np.float32)
        self.u2 = rng.random((B, L)).astype(np.float32)
        # enough masked positions of each branch for a tiny batch
        self.u[:, ::3] = 0.01
        self.u2[:, ::9] = 0.85
        self.rand = rng.integers(5, vocab, (B, L)).astype(np.int32)

    def jax_proxy(self):
        """``jax`` as carel_tpu/pretrain/mlm.py sees it, with randint and
        uniform answering from these draws by shape (the two uniforms in
        the order the step asks for them)."""
        draws, calls = self, [0]

        class Random:
            def __getattr__(self, name):
                return getattr(jax.random, name)

            @staticmethod
            def randint(key, shape, lo, hi):
                a = draws.idx if len(shape) == 1 else draws.rand
                return jnp.asarray(a)

            @staticmethod
            def uniform(key, shape):
                calls[0] += 1
                return jnp.asarray(draws.u if calls[0] % 2 else draws.u2)

        class Jax:
            random = Random()

            def __getattr__(self, name):
                return getattr(jax, name)

        return Jax()

    def torch_draw(self, generator, n, shape, vocab_size, device):
        return (torch.from_numpy(self.idx).long(), torch.from_numpy(self.u),
                torch.from_numpy(self.u2),
                torch.from_numpy(self.rand).long())


class _Records:
    def __init__(self):
        self.records = []

    def log(self, record):
        self.records.append(record)


@pytest.mark.parametrize("steps,scan_size", [(3, 1), (4, 3)])
def test_pretrain_matches_jax(steps, scan_size, monkeypatch):
    texts = _zh_texts(10)
    jt, tt = JZh.from_corpus(texts), ZhCharTokenizer.from_corpus(texts)
    jenc = j_tiny(vocab_size=jt.vocab_size, dropout=0.0)
    tenc = tiny_encoder_config(vocab_size=tt.vocab_size, dropout=0.0)
    cfg = dict(batch_size=6, seq_len=24, steps=steps, warmup_steps=2,
               learning_rate=1e-3, seed=3, scan_size=scan_size)
    jcfg, tcfg = jmlm.MlmConfig(**cfg), tmlm.MlmConfig(**cfg)
    draws = _Draws(len(texts), 6, 24, jenc.vocab_size)

    # JAX's init, by its own key split, carried across
    ids, mask = jmlm.make_mlm_batches(texts, jt, jcfg)
    p_rng, _ = jax.random.split(jax.random.key(jcfg.seed))
    init = jmlm.MlmModel(jenc).init({"params": p_rng}, jnp.asarray(ids[:2]),
                                    jnp.asarray(mask[:2]))["params"]
    model = tmlm.MlmModel(tenc)
    model.load_state_dict(jax_params_to_state_dict(_np(init)))

    monkeypatch.setattr(jmlm, "jax", draws.jax_proxy())
    jlog = _Records()
    want = jax_params_to_state_dict(_np(jmlm.pretrain_mlm(
        jenc, jt, texts, jcfg, jlog)))
    monkeypatch.setattr(tmlm, "draw_noise", draws.torch_draw)
    tlog = _Records()
    got = tmlm.pretrain_mlm(tenc, tt, texts, tcfg, tlog, device="cpu",
                            model=model)

    trained = -(-steps // scan_size) * scan_size
    assert [r["step"] for r in tlog.records] == \
        [r["step"] for r in jlog.records] == \
        list(range(scan_size, trained + 1, scan_size))
    np.testing.assert_allclose([r["loss"] for r in tlog.records],
                               [r["loss"] for r in jlog.records], rtol=1e-4)
    lr_sum = sum(float(tmlm.lr_at(tcfg, torch.tensor(float(c))))
                 for c in range(trained))
    grads = {f"encoder.{k}": p.grad for k, p in
             model.encoder.named_parameters()}
    assert set(got) == set(want)
    for name, w in want.items():
        gap = (got[name] - w).abs()
        assert float(gap.max()) <= 2 * lr_sum, name
        g = grads[f"encoder.{name}"].abs()
        safe = g > 1e-2 * float(g.max())
        safe &= ~_key_bias_entries(name, g)
        if bool(safe.any()):
            assert float(gap[safe].max()) <= 1e-3 * lr_sum, name


def _corpus(content, L=24):
    """[N, L] ids and mask: [CLS], ``content[i]`` content ids, [SEP],
    padding."""
    rng = np.random.default_rng(len(content))
    ids = np.zeros((len(content), L), np.int32)
    mask = np.zeros_like(ids)
    for i, c in enumerate(content):
        ids[i, 0], ids[i, 1:c + 1], ids[i, c + 1] = 2, rng.integers(
            5, 120, c), 3
        mask[i, :c + 2] = 1
    return ids, mask


def _word_starts(n, L, size):
    """Words of ``size`` tokens from position 1 on; [CLS] its own."""
    pos = np.arange(L)
    return np.tile(np.where(pos > 0, 1 + (pos - 1) // size * size, 0),
                   (n, 1)).astype(np.int32)


@pytest.mark.parametrize("case", ["within capacity", "over capacity",
                                  "whole word"])
def test_masked_rows_head_matches_every_position(case, monkeypatch):
    """The trainer's step, its head over a capacity buffer of the masked
    rows (pads weighted 0), against the same model's head over every
    position and the masked mean of JAX's step, under injected draws: the
    loss within 1e-6 relative, every parameter's gradient within 1e-5
    normwise. Over capacity (``head_capacity`` forced below the step's
    count) the step runs over exactly its masked rows and counts one full
    step; whole-word masking reads the draws at each word's start."""
    B, L, V = 6, 24, 120
    ids, mask = _corpus([6, 9, 14, 17, 20, 22, 11, 8, 19, 15], L)
    ws = _word_starts(len(ids), L, 3) if case == "whole word" else None
    draws = _Draws(len(ids), B, L, V)
    monkeypatch.setattr(tmlm, "draw_noise", draws.torch_draw)
    if case == "over capacity":
        monkeypatch.setattr(tmlm, "head_capacity", lambda *a: 4)
    enc = tiny_encoder_config(vocab_size=V, dropout=0.0)
    model = tmlm.build_mlm(enc, seed=2)
    init = {k: v.clone() for k, v in model.state_dict().items()}
    cfg = tmlm.MlmConfig(batch_size=B, seq_len=L, warmup_steps=2,
                         learning_rate=1e-3)
    trainer = tmlm.MlmTrainer(model, cfg, ids, mask, ws, 4, "cpu")
    got = float(trainer.dispatch(1))

    ref = tmlm.MlmModel(enc)
    ref.load_state_dict(init)
    tids = torch.from_numpy(ids[draws.idx]).long()
    attn = torch.from_numpy(mask[draws.idx])
    u, u2 = torch.from_numpy(draws.u), torch.from_numpy(draws.u2)
    if ws is not None:
        at = torch.from_numpy(ws[draws.idx]).long()
        u, u2 = u.gather(1, at), u2.gather(1, at)
    masked = (u < cfg.mask_prob) & (attn > 0) & (tids > 4)
    corrupted = torch.where(
        masked & (u2 < 0.8), torch.full_like(tids, 4),
        torch.where(masked & (u2 >= 0.8) & (u2 < 0.9),
                    torch.from_numpy(draws.rand).long(), tids))
    nll = torch.nn.functional.cross_entropy(
        ref(corrupted, attn).view(B * L, -1), tids.view(-1),
        reduction="none").view(B, L)
    w = masked.float()
    loss = (nll * w).sum() / torch.clamp(w.sum(), min=1.0)
    loss.backward()
    want = float(loss.detach())

    count = int(masked.sum())
    capacity = 4 if case == "over capacity" else 128
    assert trainer.capacity == capacity
    assert (trainer.full_steps == 1) == (count > capacity)
    assert trainer.masked == count
    assert trainer.head_rows == max(count, capacity)
    assert abs(got - want) <= 1e-6 * abs(want)
    grads = dict(model.named_parameters())
    for name, p in ref.named_parameters():
        # the pooler: no gradient in the reference, a zero one in the step
        g = torch.zeros_like(p) if p.grad is None else p.grad
        assert _relnorm(grads[name].grad.numpy(), g.numpy()) <= 1e-5, name


@pytest.mark.parametrize("case, B, size, want", [
    # 8, 16, 24, 32 candidates: mean 0.15 x 20 a row, var 80; a step of
    # 256 rows masks 768 +- sqrt(256 (0.1275 x 20 + 0.0225 x 80)) = 33.37,
    # so 768 + 6 x 33.37 = 968.2 rounds up to 1,024
    ("margin", 256, None, 1024),
    # words of 4: sum(l^2) = 4 c a row, sd sqrt(256 (0.1275 x 80 + 1.8)),
    # 768 + 6 x 55.43 = 1,100.6 rounds up to 1,152
    ("whole word", 256, 4, 1152),
    # 2 rows: the margin rounds up to 128, past the 2 x 32 candidates
    ("every row", 2, None, 64),
])
def test_head_capacity(case, B, size, want):
    """``head_capacity`` on a hand-made corpus: never above B times the
    most candidates in a row, and equal to it where the margin is more."""
    ids, mask = _corpus([8, 16, 24, 32], 40)
    ws = None if size is None else torch.from_numpy(
        _word_starts(len(ids), 40, size)).long()
    got = tmlm.head_capacity(torch.from_numpy(ids), torch.from_numpy(mask),
                             ws, B, 0.15)
    assert got == want <= B * 32


def test_mlm_and_encoder_dirs_round_trip(tmp_path):
    model = tmlm.build_mlm(tiny_encoder_config(vocab_size=200), seed=4)
    state = model.state_dict()
    path = tmlm.save_mlm(str(tmp_path / "mlm"), state)
    assert os.listdir(path) == [tmlm.MLM_FILE]
    back = tmlm.load_mlm(path)
    assert back.keys() == state.keys()
    assert all(torch.equal(back[k], state[k]) for k in state)
    enc = tmlm.save_encoder(str(tmp_path / "enc"),
                            model.encoder.state_dict())
    assert tmlm.is_encoder_dir(enc) and not tmlm.is_encoder_dir(path)
    loaded = tmlm.load_encoder(enc)
    assert all(torch.equal(loaded[k], v)
               for k, v in model.encoder.state_dict().items())
    with pytest.raises(FileNotFoundError, match="pretrain --save_mlm"):
        tmlm.load_mlm(enc)


def _last_json(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_pretrain_verb_chains_into_train(tmp_path, capsys, monkeypatch):
    """As tests/test_cli.py::test_pretrain_then_train_chain for JAX: the
    pretrain verb (whole-word masking, a dispatch of 2 steps) writes the
    encoder dir, the MLM dir and the pinned tokenizer; train
    --hf_encoder <out> loads the encoder bit for bit and trains."""
    root = str(tmp_path / "corpus")
    write_newsplit_corpus(root)
    enc_dir, mlm_dir = str(tmp_path / "enc"), str(tmp_path / "mlm")
    common = ["--data_root", root, "--encoder", "tiny", "--device", "cpu",
              "--cache_dir", str(tmp_path / "cache"), "--log_dir",
              str(tmp_path / "logs")]
    assert main(["pretrain", *common, "--steps", "4", "--scan_size", "2",
                 "--mlm_batch", "8", "--seq_len", "32", "--whole_word",
                 "--warmup_steps", "2", "--save_mlm", mlm_dir,
                 "--save_every", "2", "--out", enc_dir]) == 0
    out = _last_json(capsys)
    assert out["encoder_ckpt"] == os.path.abspath(enc_dir)
    assert out["clauses"] > 0
    assert os.path.exists(os.path.join(enc_dir, tmlm.ENCODER_FILE))
    assert os.path.exists(os.path.join(mlm_dir, tmlm.MLM_FILE))
    assert os.path.exists(enc_dir + "_step2")
    assert not os.path.exists(enc_dir + "_step4")
    events = [json.loads(line) for log in (tmp_path / "logs").glob(
        "pretrain_*.jsonl") for line in log.read_text().splitlines()]
    assert [e["step"] for e in events if e["event"] == "mlm_step"] == [2, 4]
    assert all(math.isfinite(e["loss"]) for e in events
               if e["event"] == "mlm_step")
    # the pinned tokenizer is the cache's, in JAX's format
    pinned = mlm_dir + ".tokenizer.json"
    cache = tmp_path / "cache" / "tokenizer_zh.json"
    assert open(pinned, "rb").read() == cache.read_bytes()
    j = JZh.load(pinned)
    j.save(str(tmp_path / "jax_tok.json"))
    assert (tmp_path / "jax_tok.json").read_bytes() == cache.read_bytes()
    # the MLM's encoder part is the encoder dir
    full = tmlm.load_mlm(mlm_dir)
    enc = tmlm.load_encoder(enc_dir)
    assert all(torch.equal(full[f"encoder.{k}"], v) for k, v in enc.items())

    from carel_tpu_torch import pipeline

    loaded = {}
    real_init = pipeline.init_state

    def spy(cfg, device="cuda", **kw):
        state = real_init(cfg, device, **kw)
        loaded.update({k: v.clone() for k, v in
                       state.model.encoder.state_dict().items()})
        return state

    monkeypatch.setattr(pipeline, "init_state", spy)
    assert main(["train", *common, "--hf_encoder", enc_dir,
                 "--epochs", "1", "--self_iteration", "0",
                 "--batch_size", "8", "--checkpoint_dir",
                 str(tmp_path / "ckpt")]) == 0
    assert 0.0 <= _last_json(capsys)["best_f1"] <= 1.0
    assert loaded.keys() == enc.keys()
    assert all(torch.equal(loaded[k], enc[k]) for k in enc)
