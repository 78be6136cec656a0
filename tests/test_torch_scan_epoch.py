"""The port's whole-epoch step (carel_tpu_torch/train/scan_epoch.py) and its
prefetch (data/prefetch.py) on the CPU at tiny widths:

- ``stack_epoch`` gives JAX's stacked arrays, array for array, with a ragged
  tail;
- the epoch step over a stacked epoch against a per-step loop of the JAX
  package's step over the same slices (``_jax_step`` of
  test_torch_train_step.py, sample=False, which is zero noise; for vi the
  same permutation every batch and vi_beta 0.3), for every regularizer.
  JAX's own tests/test_scan_epoch.py holds its scan equal to that loop.
  Tolerances: losses rel 1e-4, as in the step tests; every param within
  2 * its group's lr a step (the step tests' bound, once per step: where
  the gradient is rounding noise, as the attention key bias's is, Adam
  moves each side by ~lr a step its own way), and the 99th percentile of
  every tensor within 0.05 lr;
- the epoch step against the port's own per-step loop, bit for bit, from
  equal seeds, with dropout on and kl_ann_iterations = 4, so that the
  within-epoch annealing weight of every batch matters;
- the packed batch rows, the capture key, and prefetch_to_device's order
  and error propagation (mirroring tests/test_train_step.py's prefetch
  test).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from carel_tpu.data.batching import PairArrays as JPairArrays
from carel_tpu.models.drl import DrlModel as JDrlModel
from carel_tpu.train.scan_epoch import stack_epoch as j_stack_epoch

from carel_tpu_torch.config import CarelConfig, DataConfig, LossConfig
from carel_tpu_torch.config import ModelConfig, Regularizer, TrainConfig
from carel_tpu_torch.convert import jax_params_to_state_dict
from carel_tpu_torch.data.batching import PairArrays, iter_batches
from carel_tpu_torch.data.prefetch import prefetch_to_device
from carel_tpu_torch.losses.vae import annealed_kl_weight
from carel_tpu_torch.models.drl import DrlModel
from carel_tpu_torch.models.encoder import tiny_encoder_config
from carel_tpu_torch.pipeline import init_state
from carel_tpu_torch.train import checkpoint as ckpt
from carel_tpu_torch.train.scan_epoch import (capture_key, make_epoch_step,
                                              pack_epoch, stack_epoch,
                                              unpack_row)
from carel_tpu_torch.train.state import create_train_state, set_lr
from carel_tpu_torch.train.steps import batch_to_device, make_train_step
from tests.test_torch_train_step import (B, BOW, GROUP_LR, L, VI_BETA, VOCAB,
                                         _cfgs, _jax_step, _np)

REGULARIZERS = ["none", "mmd", "hsic", "gan", "vi"]


def _arrays(n=21, seed=0, L=L, vocab=VOCAB, bow=BOW):
    """n pairs: with B = 8 three batches, the last with 5 real rows."""
    rng = np.random.default_rng(seed)
    mask = np.ones((n, L), np.int32)
    mask[::3, L // 2:] = 0
    idx = rng.integers(0, bow, (n, 6)).astype(np.int32)
    idx[:, -2:] = -1
    return dict(
        input_ids=(rng.integers(2, vocab, (n, L)) * mask).astype(np.int32),
        attention_mask=mask,
        token_type_ids=np.zeros((n, L), np.int32),
        pair_labels=(rng.random(n) < 0.4).astype(np.float32),
        emotion_labels=rng.integers(0, 6, n).astype(np.int32),
        temporal_order=rng.random(n) < 0.5,
        bow_indices=idx,
        bow_weights=np.where(idx >= 0, 0.25, 0.0).astype(np.float32))


@pytest.mark.parametrize("seed", [None, 7])
def test_stack_epoch_matches_jax(seed):
    fields = _arrays()
    got = stack_epoch(PairArrays(**fields), B,
                      None if seed is None else np.random.default_rng(seed))
    want = j_stack_epoch(JPairArrays(**fields), B,
                         None if seed is None else np.random.default_rng(seed))
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got["input_ids"].shape == (3, B, L)
    np.testing.assert_array_equal(got["example_mask"][-1],
                                  [1, 1, 1, 1, 1, 0, 0, 0])


def test_stack_epoch_shuffles_as_iter_batches():
    arrays = PairArrays(**_arrays())
    stacked = stack_epoch(arrays, B, np.random.default_rng(3))
    for i, batch in enumerate(iter_batches(arrays, B, shuffle=True,
                                           rng=np.random.default_rng(3))):
        for k, v in batch.as_dict().items():
            np.testing.assert_array_equal(stacked[k][i], v, err_msg=k)


def test_packed_rows_hold_each_batch():
    stacked = stack_epoch(PairArrays(**_arrays()), B,
                          np.random.default_rng(1))
    weights = [0.25, 1.0 / 3.0, 1.0]
    layout, rows = pack_epoch(stacked, weights, 0.3)
    assert rows.dtype == torch.uint8 and rows.shape == (3, layout.nbytes)
    for i in range(3):
        batch, kl, beta = unpack_row(rows[i], layout)
        assert batch.keys() == stacked.keys()
        for k, v in stacked.items():
            assert torch.equal(batch[k], torch.from_numpy(v[i])), k
        assert kl.shape == () and kl.dtype == torch.float32
        assert float(kl) == float(np.float32(weights[i]))
        assert float(beta) == float(np.float32(0.3))


@functools.lru_cache(maxsize=None)
def _epoch_against_jax(reg):
    jcfg, tcfg = _cfgs(reg)
    stacked = stack_epoch(PairArrays(**_arrays()), B,
                          np.random.default_rng(5))
    nb = stacked["input_ids"].shape[0]
    jm = JDrlModel(jcfg.model)
    first = {k: jnp.asarray(v[0]) for k, v in stacked.items()}
    params = jm.init({"params": jax.random.key(0),
                      "sample": jax.random.key(1)},
                     first["input_ids"], first["attention_mask"],
                     first["token_type_ids"])["params"]
    j_state, j_losses, perm = None, [], None
    for i in range(nb):
        jb = {k: jnp.asarray(v[i]) for k, v in stacked.items()}
        metrics, _, _, j_state, perm, _ = _jax_step(
            jcfg, jm, params, jb, reg, state=j_state, iteration=i)
        j_losses.append(float(metrics["loss"]))

    model = DrlModel(tcfg.model)
    model.load_state_dict(jax_params_to_state_dict(_np(params)))
    state = create_train_state(tcfg, model, torch.Generator())
    zeros = torch.zeros(tcfg.model.ec_dim)
    step = make_epoch_step(tcfg)
    losses = step(state, stacked, VI_BETA, eps=(zeros, zeros),
                  perm=None if perm is None else torch.from_numpy(perm).long())
    return dict(j_losses=np.asarray(j_losses),
                j_after=jax_params_to_state_dict(_np(j_state.params)),
                losses=losses.numpy(), state=state, nb=nb, step=step)


@pytest.mark.parametrize("reg", REGULARIZERS)
def test_epoch_step_matches_jax_per_step_loop(reg):
    run = _epoch_against_jax(reg)
    state = run["state"]
    assert getattr(run["step"], "is_epoch_step", False)
    assert run["losses"].shape == (run["nb"],)
    np.testing.assert_allclose(run["losses"], run["j_losses"], rtol=1e-4)
    assert state.step == run["nb"]
    # an Adam step moves an entry by at most ~lr, so two runs whose
    # gradients differ by rounding drift apart by at most 2 lr a step where
    # the gradient is itself rounding noise: the attention key bias (q.b is
    # added to every score of a query and the softmax cancels it, so its
    # gradient is zero in exact arithmetic) and the odd embedding row. The
    # bulk of every tensor must agree within 0.05 lr (its 99th percentile)
    worst, bulk = 0.0, 0.0
    for name, p in state.model.named_parameters():
        lr = GROUP_LR.get(state.labels[name], GROUP_LR["main"])
        err = (p.detach() - torch.from_numpy(
            np.asarray(run["j_after"][name]))).abs().flatten() / lr
        worst = max(worst, float(err.max()))
        if name.endswith("attention.qkv.bias"):
            hidden = err.numel() // 3  # laid out (q, k, v)
            err = torch.cat([err[:hidden], err[2 * hidden:]])
        bulk = max(bulk, float(torch.quantile(err.double(), 0.99)))
    assert worst <= 2.0 * run["nb"], worst
    assert bulk <= 0.05, bulk


def _seeded_cfg(reg: str, kl_ann_iterations: int = 4, dropout: float = 0.1):
    binary = reg in ("hsic", "gan")
    return CarelConfig(
        model=ModelConfig(encoder=tiny_encoder_config(
            vocab_size=VOCAB, dropout=dropout), ec_dim=8, bow_dim=BOW,
            dropout=dropout, binary_emotion=binary),
        loss=LossConfig(regularizer=Regularizer(reg),
                        kl_ann_iterations=kl_ann_iterations),
        data=DataConfig(max_len=L),
        train=TrainConfig(batch_size=B, vae_lr=1e-3, adv_lr=2e-3,
                          aprx_lr=5e-2, seed=11))


def _optimizer_tensors(state):
    return [v for opt in (state.optimizer, state.disc_optimizer,
                          state.club_optimizer)
            for entry in opt.state.values() for v in entry.values()
            if isinstance(v, torch.Tensor)]


@pytest.mark.parametrize("reg", REGULARIZERS)
def test_epoch_step_equals_the_per_step_loop(reg):
    """Six batches (two epochs of three), so that iterations 0-3 ramp the
    KL weight and 4+ do not; dropout on, noise and vi permutation from the
    generators: the epoch step and the per-step loop give the same bits."""
    cfg = _seeded_cfg(reg)
    arrays = PairArrays(**_arrays(n=45))  # 6 batches, the last ragged
    a = init_state(cfg, "cpu")
    losses_a = make_epoch_step(cfg)(
        a, stack_epoch(arrays, B, np.random.default_rng(2)), VI_BETA)
    after_a = {k: v.clone() for k, v in a.model.state_dict().items()}
    gen_a = (a.generator.get_state(), torch.get_rng_state())

    b = init_state(cfg, "cpu")
    step = make_train_step(cfg)
    losses_b = torch.stack([
        step(b, batch_to_device(batch.as_dict(), torch.device("cpu")), i,
             VI_BETA)["loss"]
        for i, batch in enumerate(iter_batches(
            arrays, B, shuffle=True, rng=np.random.default_rng(2)))])
    assert losses_a.shape == (6,)
    assert torch.equal(losses_a, losses_b)
    for k, v in b.model.state_dict().items():
        assert torch.equal(after_a[k], v), k
    moments_a, moments_b = _optimizer_tensors(a), _optimizer_tensors(b)
    assert len(moments_a) == len(moments_b) > 0
    assert all(torch.equal(x, y) for x, y in zip(moments_a, moments_b))
    assert a.step == b.step == 6
    assert torch.equal(gen_a[0], b.generator.get_state())
    assert torch.equal(gen_a[1], torch.get_rng_state())
    # the weights the host packed: 4 iterations of ramp, then 1
    weights = [annealed_kl_weight(i, 4, cfg.loss.ec_kl_lambda)
               for i in range(6)]
    assert weights[4] == weights[5] == 1.0 and weights[0] < weights[3] < 1.0


def test_epoch_step_takes_fixed_noise_on_the_cpu():
    """On the CPU the epoch step takes fixed noise (and a fixed vi
    permutation), as the per-step one does."""
    cfg = _seeded_cfg("mmd", dropout=0.0)
    state = init_state(cfg, "cpu")
    zeros = torch.zeros(8)
    losses = make_epoch_step(cfg)(
        state, stack_epoch(PairArrays(**_arrays()), B), 0.0,
        eps=(zeros, zeros))
    assert losses.shape == (3,) and torch.isfinite(losses).all()


def test_capture_key_tracks_what_a_capture_holds(tmp_path):
    """model.load_state_dict (the loop's best reload) copies in place and
    keeps the key; load_state replaces the optimizers' state tensors and a
    float lr change replaces a constant of the graph: both change it."""
    cfg = _seeded_cfg("vi")
    stacked = stack_epoch(PairArrays(**_arrays()), B)
    state = init_state(cfg, "cpu")
    make_epoch_step(cfg)(state, stacked, 0.1)
    layout, _ = pack_epoch(stacked, [0.0] * 3, 0.1)
    key = capture_key(state, layout)
    best = {k: v.clone() for k, v in state.model.state_dict().items()}
    make_epoch_step(cfg)(state, stacked, 0.1)
    assert capture_key(state, layout) == key  # steps update in place
    state.model.load_state_dict(best)
    assert capture_key(state, layout) == key
    ckpt.save_state(str(tmp_path), "m", state)
    ckpt.load_state(str(tmp_path), "m", state)
    reloaded = capture_key(state, layout)
    assert reloaded != key
    set_lr(state.optimizer, 5e-4)
    assert capture_key(state, layout) != reloaded
    other, _ = pack_epoch({k: v[:, :4] for k, v in stacked.items()},
                          [0.0] * 3, 0.1)
    assert capture_key(state, other) != capture_key(state, layout)


def _prefetch_arrays(n=20):
    return PairArrays(
        input_ids=np.arange(n * 4, dtype=np.int32).reshape(n, 4),
        attention_mask=np.ones((n, 4), np.int32),
        token_type_ids=np.zeros((n, 4), np.int32),
        pair_labels=np.arange(n, dtype=np.float32),
        emotion_labels=np.zeros(n, np.int32),
        temporal_order=np.zeros(n, bool),
        bow_indices=np.zeros((n, 2), np.int32),
        bow_weights=np.zeros((n, 2), np.float32))


def test_prefetch_to_device():
    arrs = _prefetch_arrays()
    it = iter_batches(arrs, 8, shuffle=False)
    out = list(prefetch_to_device(it, size=2, transform=lambda b: b.as_dict(),
                                  device="cpu"))
    assert len(out) == 3
    assert isinstance(out[0]["input_ids"], torch.Tensor)
    for i, batch in enumerate(out):
        want = np.arange(8 * i, 8 * i + 8, dtype=np.float32)
        want[want >= 20] = 0.0  # the padded tail
        np.testing.assert_array_equal(batch["pair_labels"].numpy(), want)
    np.testing.assert_array_equal(out[2]["example_mask"].numpy(),
                                  [1, 1, 1, 1, 0, 0, 0, 0])

    # error propagation, after the items before it
    def bad():
        yield arrs
        raise RuntimeError("boom")

    seen = []
    with pytest.raises(RuntimeError, match="boom"):
        for item in prefetch_to_device(bad(), transform=lambda b: b.input_ids):
            seen.append(item)
    assert len(seen) == 1 and torch.equal(seen[0],
                                          torch.from_numpy(arrs.input_ids))


def test_prefetch_keeps_the_order_of_many_items():
    items = [{"x": np.full(3, i, np.int64)} for i in range(50)]
    out = list(prefetch_to_device(iter(items), size=2,
                                  transform=lambda d: {"x": d["x"],
                                                       "y": d["x"] * 2}))
    assert [int(o["x"][0]) for o in out] == list(range(50))
    assert all(torch.equal(o["y"], torch.full((3,), 2 * i))
               for i, o in enumerate(out))
