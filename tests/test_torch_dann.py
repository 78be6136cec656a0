"""The port's clause-level DANN (carel_tpu_torch.models.dann,
stage1/dann_driver.py) against carel_tpu's on the CPU in float32, at tiny
widths (tiny_encoder_config with dropout 0, ClauseEmotionDANN(dropout=0)),
from the same weights and batch statistics (carel_tpu_torch.convert) and
numpy-seeded inputs.

Tolerances: logits and losses atol 1e-5 (fp32, sums in another order); after
three train_dann steps (Adam, lr 1e-5) the running statistics atol 2e-6 and
the params within 2 x lr a step (an entry whose gradient is near 0 may take
Adam's step of +-lr with either sign); the gradient reversal exact. The
numpy draws of the batches are the same calls, so both packages train on
the same clauses; a DANN run of two self-training iterations logs the same
events, label histograms and F1s as JAX's run_dann.

Where the update itself is held (Adam's steps, the one Adam carried across
the phases, the best state copied back): after one step at lr 1e-3 every
entry whose JAX gradient is well above Adam's eps lies within 1e-2 x lr of
JAX's; after several steps the params' displacement from their start, taken
as one vector, lies within 10 % of JAX's (normwise). Entries whose gradient
is rounding noise (the keys' bias, to which softmax is blind) take Adam's
+-lr with either sign in each package, and those flips feed on through
training, so later steps are held normwise; a port that skips, resets or
rebuilds its Adam, or does not restart an iteration from the best state,
misses by 30-100 %."""

import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from carel_tpu.data.tokenizer import ZhCharTokenizer as JTok
from carel_tpu.models import dann as jdann
from carel_tpu.models.discriminators import grad_reverse as j_grad_reverse
from carel_tpu.models.encoder import tiny_encoder_config as j_tiny
from carel_tpu.stage1 import dann_driver as jdriver

import carel_tpu_torch.data as tdata
from carel_tpu_torch.cli.main import main
from carel_tpu_torch.convert import (jax_batch_stats_to_state_dict,
                                     jax_params_to_state_dict)
from carel_tpu_torch.data.tokenizer import ZhCharTokenizer as TTok
from carel_tpu_torch.models import dann as tdann
from carel_tpu_torch.models.discriminators import grad_reverse
from carel_tpu_torch.models.encoder import tiny_encoder_config as t_tiny
from carel_tpu_torch.stage1 import dann_driver as tdriver

from tests.test_torch_data import synth_docs

L = 16


def _clauses(seed, n_docs):
    docs = synth_docs(seed, n_docs)
    sents = [c.text_field3.replace(" ", "") for d in docs for c in d.clauses]
    labels = np.asarray([c.emotion for d in docs for c in d.clauses],
                        np.int32)
    return sents, labels


def _sets(vocab_tok, *seeds):
    out = []
    for seed in seeds:
        sents, labels = _clauses(seed, 4)
        out.append(tdriver.encode_clauses(vocab_tok, sents, labels, L))
    return out


def _pair(domain_weight=3.0, seed=0):
    """The JAX model's (params, batch_stats) from init_dann and the port's
    model loaded with them, over a source set and a target set."""
    sents = _clauses(1, 4)[0] + _clauses(2, 4)[0]
    tok = TTok.from_corpus(sents)
    source, target = _sets(tok, 1, 2)
    kw = dict(vocab_size=tok.vocab_size, dropout=0.0)
    jmodel = jdann.ClauseEmotionDANN(j_tiny(**kw), dropout=0.0,
                                     domain_weight=domain_weight)
    params, stats = jdann.init_dann(jmodel, source, seed)
    params = jax.tree_util.tree_map(np.asarray, params)
    tmodel = tdann.ClauseEmotionDANN(t_tiny(**kw), dropout=0.0,
                                     domain_weight=domain_weight)
    tmodel.load_state_dict({**jax_params_to_state_dict(params),
                            **jax_batch_stats_to_state_dict(stats)})
    return jmodel, params, stats, tmodel, source, target


def _t(data, idx=None):
    idx = np.arange(len(data["input_ids"])) if idx is None else idx
    return [torch.tensor(np.asarray(data[k])[idx]) for k in
            ("input_ids", "attention_mask", "token_type_ids")]


def test_dann_logits_and_batch_stats_match_jax():
    jmodel, params, stats, tmodel, source, _ = _pair()
    ids = [jnp.asarray(a) for a in _t(source)]
    je, jd = jmodel.apply({"params": params, "batch_stats": stats}, *ids)
    with torch.no_grad():
        te, td = tmodel(*_t(source))
    np.testing.assert_allclose(te.numpy(), np.asarray(je), atol=1e-5, rtol=0)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=1e-5, rtol=0)
    # batch statistics of a training forward, and its running update
    (je, jd), upd = jmodel.apply(
        {"params": params, "batch_stats": stats}, *ids,
        use_running_average=False, mutable=["batch_stats"])
    with torch.no_grad():
        te, td = tmodel(*_t(source), use_running_average=False)
    np.testing.assert_allclose(te.numpy(), np.asarray(je), atol=1e-5, rtol=0)
    want = jax_batch_stats_to_state_dict(upd["batch_stats"])
    for k, v in want.items():
        got = tmodel.state_dict()[k]
        np.testing.assert_allclose(got.numpy(), v.numpy(), atol=1e-6,
                                   rtol=1e-5, err_msg=k)
    moved = tmodel.batchnorm_l.running_var - 1.0
    assert float(moved.abs().max()) > 1e-4


def test_batch_stats_after_three_train_dann_steps():
    jmodel, params, stats, tmodel, source, target = _pair()
    initial = {k: v.detach().clone() for k, v in tmodel.state_dict().items()}
    # 12 labeled clauses in batches of 8: 12 // 4 = 3 steps
    labeled = {k: np.asarray(v)[:12] for k, v in source.items()}
    lr = 1e-5
    p, s, _ = jdann.train_dann(jmodel, labeled, target, epochs=1,
                               batch_size=8, learning_rate=lr, seed=3,
                               init=(params, stats, None))
    losses = []
    tdann.train_dann(tmodel, labeled, target, epochs=1, batch_size=8,
                     learning_rate=lr, seed=3, losses=losses)
    assert len(losses) == 3
    want = jax_batch_stats_to_state_dict(s)
    for k, v in want.items():
        np.testing.assert_allclose(tmodel.state_dict()[k].numpy(),
                                   v.numpy(), atol=2e-6, rtol=0, err_msg=k)
    assert float((tmodel.batchnorm_l.running_mean).abs().max()) > 1e-3
    got = jax_params_to_state_dict(jax.tree_util.tree_map(np.asarray, p))
    for k, v in tmodel.named_parameters():
        np.testing.assert_allclose(v.detach().numpy(), got[k].numpy(),
                                   atol=3 * 2 * lr, rtol=0, err_msg=k)
    _assert_moved_like(tmodel.state_dict(), got, initial)


def _assert_moved_like(state, want, initial, rtol=0.1):
    """The displacement state - initial, over every entry of ``want`` as one
    vector, within ``rtol`` of want - initial (normwise), and not zero."""
    err = moved = 0.0
    for k, w in want.items():
        d_got, d_want = state[k] - initial[k], w - initial[k]
        err += float((d_got - d_want).square().sum())
        moved += float(d_want.square().sum())
    assert moved > 0.0
    assert (err / moved) ** 0.5 <= rtol, (err / moved) ** 0.5


def _dann_grads(jmodel, params, stats, labeled, unlabeled, batch_size,
                seed):
    """JAX's gradient of the first train_dann step: the same numpy draws,
    the same loss (domain term on)."""
    data_rng = np.random.default_rng(seed)
    half = batch_size // 2
    lab_y = np.asarray(labeled["labels"])
    si = data_rng.choice(len(lab_y), half,
                         p=jdann.imbalanced_sample_weights(lab_y))
    ti = data_rng.choice(len(unlabeled["input_ids"]), batch_size - half)
    rows = [jnp.concatenate([jnp.asarray(np.asarray(labeled[k])[si]),
                             jnp.asarray(np.asarray(unlabeled[k])[ti])])
            for k in ("input_ids", "attention_mask", "token_type_ids")]
    emo_y = jnp.concatenate([jnp.asarray(lab_y[si], jnp.int32),
                             jnp.full(batch_size - half, -1, jnp.int32)])
    dom_y = jnp.asarray([0] * half + [1] * (batch_size - half), jnp.int32)

    def loss(p):
        (emo, dom), _ = jmodel.apply(
            {"params": p, "batch_stats": stats}, *rows, deterministic=False,
            use_running_average=False, mutable=["batch_stats"])
        e, d = jdann.dann_losses(emo, dom, emo_y, dom_y)
        return e + d

    return jax_params_to_state_dict(jax.tree_util.tree_map(
        np.asarray, jax.grad(loss)(params)))


@pytest.mark.parametrize("steps", [1, 3])
def test_params_after_train_dann_steps_at_lr_1e3(steps):
    """Adam's update at a learning rate where it moves the params far more
    than their rounding: one step per entry, three steps normwise."""
    jmodel, params, stats, tmodel, source, target = _pair()
    initial = {k: v.detach().clone() for k, v in tmodel.state_dict().items()}
    labeled = {k: np.asarray(v)[: 4 * steps] for k, v in source.items()}
    lr = 1e-3
    p, _, _ = jdann.train_dann(jmodel, labeled, target, epochs=1,
                               batch_size=8, learning_rate=lr, seed=3,
                               init=(params, stats, None))
    losses = []
    tdann.train_dann(tmodel, labeled, target, epochs=1, batch_size=8,
                     learning_rate=lr, seed=3, losses=losses)
    assert len(losses) == steps
    got = jax_params_to_state_dict(jax.tree_util.tree_map(np.asarray, p))
    for k, v in tmodel.named_parameters():
        np.testing.assert_allclose(v.detach().numpy(), got[k].numpy(),
                                   atol=steps * 2 * lr, rtol=0, err_msg=k)
    if steps == 1:
        grads = _dann_grads(jmodel, params, stats, labeled, target, 8, 3)
        n_clear = n_all = 0
        for k, v in tmodel.named_parameters():
            err = (v.detach() - got[k]).abs()
            clear = grads[k].abs() > 1e-5  # well above eps = 1e-8
            n_clear, n_all = n_clear + int(clear.sum()), n_all + clear.numel()
            if clear.any():
                assert float(err[clear].max()) <= 1e-2 * lr, k
        assert n_clear > 0.5 * n_all
    _assert_moved_like(tmodel.state_dict(), got, initial)


def test_dann_losses_match_jax_with_unlabeled_rows():
    rng = np.random.default_rng(0)
    emo = rng.normal(size=(6, 7)).astype(np.float32)
    dom = rng.normal(size=(6, 2)).astype(np.float32)
    emo_y = np.asarray([3, -1, 0, 6, -1, -1], np.int32)
    dom_y = np.asarray([0, 1, 0, 0, 1, 1], np.int32)
    want = jdann.dann_losses(*(jnp.asarray(a) for a in (emo, dom, emo_y,
                                                        dom_y)))
    got = tdann.dann_losses(*(torch.tensor(a) for a in (emo, dom, emo_y,
                                                        dom_y)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(float(g), float(w), rtol=1e-6)
    none = tdann.dann_losses(torch.tensor(emo), torch.tensor(dom),
                             torch.full((6,), -1), torch.tensor(dom_y))
    assert float(none[0]) == 0.0


@pytest.mark.parametrize("lam", [1.0, 3.0])
def test_grad_reverse_matches_jax(lam):
    x = np.random.default_rng(1).normal(size=(4, 5)).astype(np.float32)
    g = np.random.default_rng(2).normal(size=(4, 5)).astype(np.float32)
    y, vjp = jax.vjp(lambda a: j_grad_reverse(a, lam), jnp.asarray(x))
    xt = torch.tensor(x, requires_grad=True)
    yt = grad_reverse(xt, lam)
    (gt,) = torch.autograd.grad(yt, xt, torch.tensor(g))
    assert torch.equal(yt.detach(), torch.tensor(np.asarray(y)))
    assert torch.equal(gt, torch.tensor(np.asarray(vjp(jnp.asarray(g))[0])))


def test_imbalanced_weights_match_jax():
    labels = np.asarray([0, 6, 6, 6, 2, 6, 0])
    assert np.array_equal(tdann.imbalanced_sample_weights(labels),
                          jdann.imbalanced_sample_weights(labels))


def _domain_corpus(root):
    for name, seed in (("society", 21), ("finance", 22)):
        path = os.path.join(root, "domains/THUCTC_multiple", f"{name}.txt")
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tdata.write_ecpe_file(path, synth_docs(seed, 5))


class _Events:
    def __init__(self):
        self.records = []

    def log(self, record):
        self.records.append(record)


def _both_runs(tmp_path, monkeypatch, cfg_kw):
    """JAX's run_dann and the port's fit_dann from JAX's init over the
    corpus of _domain_corpus: (JAX's result, the port's, their event logs,
    the initial state_dict). JAX's driver builds its model with the
    reference's dropout 0.1; here both run with 0."""
    sents = (tdriver.read_clause_data(
        str(tmp_path / "domains/THUCTC_multiple/society.txt"))[0]
        + tdriver.read_clause_data(
            str(tmp_path / "domains/THUCTC_multiple/finance.txt"))[0])
    jtok, ttok = JTok.from_corpus(sents), TTok.from_corpus(sents)
    kw = dict(vocab_size=ttok.vocab_size, dropout=0.0)
    monkeypatch.setattr(jdriver, "ClauseEmotionDANN", functools.partial(
        jdann.ClauseEmotionDANN, dropout=0.0))
    jcfg = jdriver.DannConfig(**cfg_kw)
    jlog, tlog = _Events(), _Events()
    jres = jdriver.run_dann(jcfg, j_tiny(**kw), jtok, str(tmp_path), jlog)

    # JAX's init, copied into the port
    src = jdriver._encode(jtok, *jdriver.read_clause_data(
        str(tmp_path / "domains/THUCTC_multiple/society.txt")), L)
    params, stats = jdann.init_dann(jdriver.ClauseEmotionDANN(
        j_tiny(**kw), domain_weight=jcfg.domain_weight), src, jcfg.seed)
    initial = {**jax_params_to_state_dict(
        jax.tree_util.tree_map(np.asarray, params)),
        **jax_batch_stats_to_state_dict(stats)}
    tcfg = tdriver.DannConfig(**cfg_kw)
    model = tdriver.build_dann_model(tcfg, t_tiny(**kw), "cpu", dropout=0.0)
    model.load_state_dict(initial)
    source, target = (tdriver.encode_clauses(ttok, sent, y, L)
                      for sent, y in tdriver.read_domains(tcfg,
                                                          str(tmp_path)))
    tres = tdriver.fit_dann(tcfg, model, source, target, tlog)
    return jres, tres, jlog, tlog, initial


def test_run_dann_matches_jax(tmp_path, monkeypatch):
    """Two self-training iterations of one epoch after one base epoch, the
    domain loss on: the same events (losses within 1e-4), pseudo-label
    histograms and F1s."""
    _domain_corpus(str(tmp_path))
    cfg_kw = dict(epochs=1, self_iteration=2, self_epochs=1, batch_size=8,
                  learning_rate=1e-5, max_len=L)
    jres, tres, jlog, tlog, _ = _both_runs(tmp_path, monkeypatch, cfg_kw)
    names = [r["event"] for r in jlog.records]
    assert [r["event"] for r in tlog.records] == names
    assert names.count("dann_selftrain") == 2
    for j, t in zip(jlog.records, tlog.records):
        for k, v in j.items():
            if k in ("emo_loss", "dom_loss"):
                assert t[k] == pytest.approx(v, abs=1e-4), (k, j, t)
            elif k != "time":
                assert t[k] == v, (k, j, t)
    assert tres["base"] == jres["base"] and tres["best"] == jres["best"]
    assert set(tres["state_dict"]) >= {"batchnorm_l.running_mean",
                                       "batchnorm_l.running_var"}


def test_run_dann_best_state_matches_jax(tmp_path, monkeypatch):
    """The best state of a run with two base epochs and two self-training
    iterations, at lr 3e-4, where the one Adam carried across the phases
    decides the result. The F1s are scripted alike in both packages (0.5,
    0.1, 0.2, 0.9), so the best is the base's first epoch until the second
    iteration's end: each iteration restarts from a state that is not the
    live one, and the best returned is the run's last state, reached with
    moments and a step count carried from every earlier step."""
    _domain_corpus(str(tmp_path))
    f1s = (0.5, 0.1, 0.2, 0.9)

    def scripted(calls):
        def prf(pred, true):
            calls.append(len(calls))
            return (f1s[calls[-1]],) * 3
        return prf

    monkeypatch.setattr(jdriver, "_flat_prf", scripted([]))
    monkeypatch.setattr(tdriver, "flat_prf", scripted([]))
    cfg_kw = dict(epochs=2, self_iteration=2, self_epochs=1, batch_size=8,
                  learning_rate=3e-4, max_len=L)
    jres, tres, jlog, tlog, initial = _both_runs(tmp_path, monkeypatch,
                                                 cfg_kw)
    names = [r["event"] for r in jlog.records]
    assert [r["event"] for r in tlog.records] == names
    assert names.count("dann_selftrain") == 2
    for j, t in zip(jlog.records, tlog.records):
        if j["event"] == "dann_selftrain" or j["event"].endswith("_eval"):
            assert {k: v for k, v in t.items() if k != "time"} == {
                k: v for k, v in j.items() if k != "time"}
    assert tres["best"]["f1"] == jres["best"]["f1"] == 0.9
    want = {**jax_params_to_state_dict(jax.tree_util.tree_map(
        np.asarray, jres["params"])),
        **jax_batch_stats_to_state_dict(jres["batch_stats"])}
    _assert_moved_like(tres["state_dict"], want, initial)


def test_dann_verb_runs_on_cpu(tmp_path, capsys):
    _domain_corpus(str(tmp_path / "corpus"))
    assert main(["dann", "--data_root", str(tmp_path / "corpus"),
                 "--encoder", "tiny", "--device", "cpu", "--epochs", "1",
                 "--self_iteration", "1", "--self_epochs", "1",
                 "--batch_size", "8", "--max_len", "32",
                 "--cache_dir", str(tmp_path / "cache"),
                 "--log_dir", str(tmp_path / "logs")]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(out) == {"base", "best"}
    assert 0.0 <= out["best"]["f1"] <= 1.0
    logs = list((tmp_path / "logs").glob("dann_*.jsonl"))
    events = [json.loads(line)["event"] for line in logs[0].read_text()
              .splitlines()]
    assert events.count("dann_epoch") == 2 and "dann_selftrain" in events
    # an orbax encoder dir (no config.json) still raises; --language en
    # and an HF --hf_encoder run (tests/test_torch_en.py)
    (tmp_path / "orbax").mkdir()
    with pytest.raises(NotImplementedError, match="Queue 3"):
        main(["dann", "--data_root", str(tmp_path / "corpus"), "--encoder",
              "tiny", "--device", "cpu", "--hf_encoder",
              str(tmp_path / "orbax"), "--cache_dir", str(tmp_path / "cache"),
              "--log_dir", str(tmp_path / "logs")])
