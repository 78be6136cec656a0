"""--optim_mu_dtype bfloat16: the port's main Adam (train/state.py's
MuDtypeAdam) against optax.adam(mu_dtype=jnp.bfloat16), as the JAX
package's create_train_state builds it, on the CPU.

- The optimizer alone, three steps over tensors of several shapes from
  numpy draws, with a float lr and with a 0-d tensor lr: every stored first
  moment within one bf16 ulp of optax's (the fp32 moment is rounded once to
  bf16, after sums that may round differently in the last fp32 bit), the
  second moment and the params normwise within 1e-6 and 1e-5.
- Three flagship train steps (tiny widths, dropout 0, zero sampling noise,
  the preset's lr 1e-5) from JAX's init (converted), JAX's step jitted: the
  main Adam's first moments in bf16 within one ulp of optax's, the params
  normwise within 1e-5 (each weight tensor, and the whole set without the
  key biases: tests/test_torch_adapters.py says why), every entry within 2
  lr a step; the club Adam keeps fp32 moments (tests/test_train_step.py:279
  holds JAX to the same).
- A snapshot (checkpoint.save_state / load_state) keeps the moments in bf16
  and a resumed step gives the bits of the step it repeats; the capture key
  of every step is the same.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from carel_tpu.models.drl import DrlModel as JDrlModel
from carel_tpu.train.state import create_train_state as j_create_state

from carel_tpu_torch.convert import jax_params_to_state_dict
from carel_tpu_torch.models.drl import DrlModel
from carel_tpu_torch.train import checkpoint as ckpt
from carel_tpu_torch.train.scan_epoch import capture_key, pack_epoch
from carel_tpu_torch.train.state import (CLUB, MAIN, MuDtypeAdam,
                                         create_train_state)
from carel_tpu_torch.train.steps import batch_to_device, make_train_step

from tests import test_torch_adapters as ta
from tests import test_torch_train_step as ts

SHAPES = ((7,), (16, 5), (3, 4, 6), (1,))


def _ordered(x: torch.Tensor) -> torch.Tensor:
    """bf16 bit patterns as integers in the order of their values."""
    bits = x.to(torch.bfloat16).view(torch.int16).int()
    return torch.where(bits < 0, -(bits & 0x7FFF), bits)


def assert_within_one_bf16_ulp(got: torch.Tensor, want: torch.Tensor, msg):
    assert got.dtype == torch.bfloat16, msg
    gap = (_ordered(got) - _ordered(want)).abs()
    assert int(gap.max()) <= 1, msg


def _relnorm(a, b):
    return float(torch.linalg.vector_norm(a.float() - b.float())
                 / torch.linalg.vector_norm(b.float()))


@pytest.mark.parametrize("tensor_lr", [False, True])
def test_mu_dtype_adam_matches_optax(tensor_lr):
    rng = np.random.default_rng(0)
    p0 = [rng.normal(size=s).astype(np.float32) for s in SHAPES]
    lr = 1e-3
    tx = optax.adam(lr, eps=1e-8, mu_dtype=jnp.bfloat16)
    jp = [jnp.asarray(p) for p in p0]
    j_state = tx.init(jp)
    update = jax.jit(tx.update)
    params = [torch.nn.Parameter(torch.tensor(p)) for p in p0]
    opt = MuDtypeAdam(params, lr=torch.tensor(lr) if tensor_lr else lr,
                      betas=(0.9, 0.999), eps=1e-8)
    for _ in range(3):
        g = [rng.normal(size=s).astype(np.float32) for s in SHAPES]
        u, j_state = update([jnp.asarray(x) for x in g], j_state, jp)
        jp = optax.apply_updates(jp, u)
        for p, x in zip(params, g):
            p.grad = torch.tensor(x)
        opt.step()
    adam = j_state[0]
    assert int(adam.count) == 3
    for i, p in enumerate(params):
        st = opt.state[p]
        assert float(st["step"]) == 3.0
        assert_within_one_bf16_ulp(st["exp_avg"],
                                   torch.tensor(np.asarray(
                                       adam.mu[i]).astype(np.float32)), i)
        assert st["exp_avg_sq"].dtype == torch.float32
        assert _relnorm(st["exp_avg_sq"],
                        torch.tensor(np.asarray(adam.nu[i]))) <= 1e-6
        assert _relnorm(p.detach(), torch.tensor(np.asarray(jp[i]))) <= 1e-5


def test_denominator_chunks_give_the_same_bits(monkeypatch):
    """MuDtypeAdam makes its denominators a chunk of parameters at a time
    (train/state.py: DENOM_CHUNK); chunks of 20 entries (four ranges
    here, two of them one parameter larger than the chunk) give the bits
    of one chunk."""
    from carel_tpu_torch.train import state as state_mod

    rng = np.random.default_rng(1)
    p0 = [rng.normal(size=s).astype(np.float32) for s in SHAPES]
    grads = [[rng.normal(size=s).astype(np.float32) for s in SHAPES]
             for _ in range(3)]
    assert list(state_mod._chunks([torch.empty(s) for s in SHAPES], 20)) \
        == [(0, 1), (1, 2), (2, 3), (3, 4)]
    runs = []
    for chunk in (state_mod.DENOM_CHUNK, 20):
        monkeypatch.setattr(state_mod, "DENOM_CHUNK", chunk)
        params = [torch.nn.Parameter(torch.tensor(p)) for p in p0]
        opt = MuDtypeAdam(params, lr=1e-3)
        for gs in grads:
            for p, g in zip(params, gs):
                p.grad = torch.tensor(g)
            opt.step()
        runs.append([p.detach().clone() for p in params]
                    + [opt.state[p]["exp_avg"] for p in params])
    assert all(torch.equal(a, b) for a, b in zip(*runs))


def test_mu_dtype_adam_skips_params_without_a_gradient():
    a, b = (torch.nn.Parameter(torch.ones(3)) for _ in range(2))
    opt = MuDtypeAdam([a, b], lr=1e-2)
    a.grad = torch.ones(3)
    opt.step()
    assert b not in opt.state and torch.equal(b.detach(), torch.ones(3))
    assert not torch.equal(a.detach(), torch.ones(3))


def _cfgs(reg: str):
    jc, tc = ts._cfgs(reg)
    jc = dataclasses.replace(jc, train=dataclasses.replace(
        jc.train, vae_lr=ta.LR, optim_mu_dtype="bfloat16"))
    tc = dataclasses.replace(tc, train=dataclasses.replace(
        tc.train, vae_lr=ta.LR, optim_mu_dtype="bfloat16"))
    return jc, tc


@pytest.fixture(scope="module")
def three_steps():
    jc, tc = _cfgs("mmd")
    batch = ts._batch()
    jm = JDrlModel(jc.model)
    params = jm.init({"params": jax.random.key(0),
                      "sample": jax.random.key(1)}, batch["input_ids"],
                     batch["attention_mask"],
                     batch["token_type_ids"])["params"]
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    j_metrics, j_state = ta._jax_steps(jc, jm, params, jb)
    (j_mu,) = ts._moments(j_state.main_opt_state, ta._np(params),
                          optax.ScaleByAdamState, ("mu",))
    model = DrlModel(tc.model)
    model.load_state_dict(jax_params_to_state_dict(ta._np(params)))
    state = create_train_state(tc, model, torch.Generator())
    step = make_train_step(tc)
    zeros = torch.zeros(ts.EC)
    tb = batch_to_device(batch, torch.device("cpu"))
    layout, _ = pack_epoch({k: v[None] for k, v in batch.items()}, [0.0],
                           0.0)
    metrics, keys = [], []
    for i in range(ta.STEPS):
        metrics.append({k: float(v) for k, v in step(
            state, tb, i, eps=(zeros, zeros)).items()})
        keys.append(capture_key(state, layout))
    return dict(state=state, tc=tc, tb=tb, step=step, metrics=metrics,
                j_metrics=j_metrics, keys=keys, j_mu=j_mu,
                j_after=jax_params_to_state_dict(ta._np(j_state.params)))


def test_flagship_steps_losses_match_optax_bf16_mu(three_steps):
    for want, got in zip(three_steps["j_metrics"], three_steps["metrics"]):
        for k in want:
            if not k.startswith("kl_"):
                np.testing.assert_allclose(got[k], want[k], rtol=1e-5,
                                           err_msg=k)


def test_flagship_steps_mu_in_bf16_within_one_ulp(three_steps):
    """Every stored first moment within one bf16 ulp of optax's, but for
    the entries whose gradient is at the fp32 rounding level of its
    tensor (|mu| <= 1e-5 max|mu|: the two packages' gradients, summed in
    another order, differ there in their leading bits; 159 entries of
    94,972 here, of which 5 are more than one ulp apart) and the key biases
    (gradient 0 in exact arithmetic): those are held to 1e-5 max|mu| of
    their tensor instead, and must stay under 1% of the entries."""
    state = three_steps["state"]
    assert isinstance(state.optimizer, MuDtypeAdam)
    checked = entries = tiny = 0
    for name, p in state.model.named_parameters():
        if state.labels[name] != MAIN or p not in state.optimizer.state:
            continue
        got = state.optimizer.state[p]["exp_avg"]
        want = three_steps["j_mu"][name]
        scale = float(want.abs().max())
        small = (want.abs() <= 1e-5 * scale) & (want != 0)
        loose = small | ta._key_bias_entries(name, want)
        entries += want.numel()
        tiny += int(small.sum())
        assert_within_one_bf16_ulp(got[~loose], want[~loose], name)
        assert float(torch.cat([(got.float() - want)[loose].abs(),
                                torch.zeros(1)]).max()) <= 1e-5 * scale, name
        checked += 1
    assert checked > 20 and tiny < 1e-2 * entries


def test_flagship_steps_params_match_optax_bf16_mu(three_steps):
    state, after = three_steps["state"], three_steps["j_after"]
    err2 = ref2 = 0.0
    for name, p in state.model.named_parameters():
        got, want = p.detach(), after[name]
        torch.testing.assert_close(got, want, rtol=0,
                                   atol=2 * ta.LR * ta.STEPS, msg=name)
        if got.dim() >= 2:
            assert _relnorm(got, want) <= 1e-5, name
        keep = ~ta._key_bias_entries(name, got)
        err2 += float(((got - want)[keep] ** 2).sum())
        ref2 += float((want[keep] ** 2).sum())
    assert (err2 / ref2) ** 0.5 <= 1e-5


def test_capture_key_holds_over_steps(three_steps):
    assert three_steps["keys"][1] == three_steps["keys"][2]


def test_club_adam_keeps_fp32_moments():
    """Under vi with bf16 mu the club's Adam is torch's, fp32 moments; the
    main Adam's first moments are bf16."""
    _, tc = _cfgs("vi")
    model = DrlModel(tc.model)
    state = create_train_state(tc, model, torch.Generator())
    assert type(state.club_optimizer) is torch.optim.Adam
    zeros = torch.zeros(ts.EC)
    make_train_step(tc)(state, batch_to_device(ts._batch(),
                                               torch.device("cpu")), 0,
                        vi_beta=0.3, eps=(zeros, zeros),
                        perm=torch.arange(ts.B))
    club = [state.club_optimizer.state[p] for n, p in
            model.named_parameters() if state.labels[n] == CLUB]
    assert len(club) == 8
    assert all(s["exp_avg"].dtype == torch.float32 for s in club)
    mus = {s["exp_avg"].dtype for s in state.optimizer.state.values()}
    assert mus == {torch.bfloat16}


def test_snapshot_keeps_bf16_mu_and_resumes_bit_equal(three_steps,
                                                      tmp_path):
    state, step, tb = (three_steps[k] for k in ("state", "step", "tb"))
    zeros = torch.zeros(ts.EC)
    ckpt.save_state(str(tmp_path), "mid", state)
    step(state, tb, 3, eps=(zeros, zeros))
    want = [p.detach().clone() for p in state.model.parameters()]
    want_mu = [s["exp_avg"].clone() for s in state.optimizer.state.values()]
    ckpt.load_state(str(tmp_path), "mid", state)
    mus = {s["exp_avg"].dtype for s in state.optimizer.state.values()}
    assert mus == {torch.bfloat16}
    step(state, tb, 3, eps=(zeros, zeros))
    assert all(torch.equal(p.detach(), w)
               for p, w in zip(state.model.parameters(), want))
    assert all(torch.equal(s["exp_avg"], w) for s, w in
               zip(state.optimizer.state.values(), want_mu))


def test_default_keeps_torch_adam():
    _, tc = ts._cfgs("mmd")
    state = create_train_state(tc, DrlModel(tc.model), torch.Generator())
    assert type(state.optimizer) is torch.optim.Adam
    with pytest.raises(ValueError, match="optim_mu_dtype"):
        create_train_state(dataclasses.replace(tc, train=dataclasses.replace(
            tc.train, optim_mu_dtype="float16")), DrlModel(tc.model),
            torch.Generator())
