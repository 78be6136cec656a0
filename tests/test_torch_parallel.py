"""The port's mesh (carel_tpu_torch/parallel/) on the CPU under gloo.

One world of four ranks (tests/torch_parallel_worker.py, started once for
the module) trains the tiny model with one encoder layer (dropout 0, fixed
noise ε and vi permutation) under dp4, dp2 x tp2 and dp1 x tp2 for mmd, hsic, gan and vi:
two eager steps, then one epoch of two batches through the epoch step
(uncaptured on the CPU). Each is held:

- against the port's one-process run on the global batch (same steps,
  no mesh): losses within rel 1e-5; params within 2 lr of their group a
  step (8 lr after the four), and within 1e-3 lr a step where the last
  gradient is above 1e-3 of its tensor's largest (the convention of
  tests/test_torch_train_step.py and test_torch_scan_epoch.py: Adam's update
  flips sign for a gradient at rounding level, as the attention key bias's
  is, elsewhere its sign is safe);
- against JAX's epoch step on a dp2 x tp2 mesh of four of the conftest's
  eight CPU devices (carel_tpu/train/scan_epoch.py, params placed by
  carel_tpu/parallel/tp.py: shard_params_tp, the noise and permutation
  patched in), over the same four batches in two epochs of two: losses
  within rel 1e-4, the JAX parity tests' loss tolerance (the dense and the
  fused MMD and BoW round apart, and the mmd losses of the later steps sum
  terms of opposite sign), params as above. Under gan JAX's scan returns
  the differentiated total, disc BCEs included (ROADMAP Queue 3), so there
  the first two (eager) steps' totals are held, and the params.

Also: the port's TP layout (``_spec_for`` by state_dict name) against
JAX's ``carel_tpu.parallel.tp._spec_for`` for every parameter; the
replicated parameters of all four ranks bit-equal after three dp2 x tp2
steps with dropout on; a dp2 x tp2 best checkpoint loaded into a one-device
model gives its evaluation's probabilities, and its full-state snapshot
loads back on every rank and into one device; ``--mesh_shape`` parsing as
tests/test_mesh_cli.py; a batch that dp does not divide, and a mesh shape
that does not cover the devices, raise; the train verb under
``--mesh_shape 1,1`` (gloo, one rank in this process) gives the bits of no
mesh, and under ``--mesh_shape 2,1`` (two worker processes) it runs.
"""

import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import types
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import carel_tpu.losses.registry as jregistry
import carel_tpu.models.drl as jdrl
from carel_tpu.models.drl import DrlModel as JDrlModel
from carel_tpu.parallel.mesh import make_mesh as j_make_mesh
from carel_tpu.parallel.sharding import shard_stacked as j_shard_stacked
from carel_tpu.parallel.tp import _spec_for as j_spec_for
from carel_tpu.parallel.tp import shard_params_tp as j_shard_params_tp
from carel_tpu.train.scan_epoch import make_epoch_step as j_make_epoch_step
from carel_tpu.train.state import create_train_state as j_create_state

from carel_tpu_torch.cli.main import _apply_overrides, build_parser
from carel_tpu_torch.config import PRESETS, AdapterKind
from carel_tpu_torch.convert import (_module_path, jax_params_to_state_dict,
                                     jax_params_to_tp_shard)
from carel_tpu_torch.data.batching import PairArrays
from carel_tpu_torch.data.synthetic import write_zh_newsplit_corpus
from carel_tpu_torch.models.drl import DrlModel
from carel_tpu_torch.parallel import tp as ttp
from carel_tpu_torch.parallel.mesh import Mesh, free_port
from carel_tpu_torch.parallel.sharding import shard_batch, shard_stacked
from carel_tpu_torch.train import checkpoint as ckpt
from carel_tpu_torch.train.loop import evaluate
from carel_tpu_torch.train.state import create_train_state
from carel_tpu_torch.train.steps import make_eval_step
from tests.test_torch_train_step import (B, EC, GROUP_LR, VI_BETA, _batch,
                                         _cfgs, _np)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REGS = ["mmd", "hsic", "gan", "vi"]
CASES = ["dp4", "dp2tp2", "dp1tp2"]
# one noise vector for both latents, so that the patched JAX sampling
# needs no call order
EPS = np.random.default_rng(11).normal(size=EC).astype(np.float32)
PERM = np.random.default_rng(12).permutation(B).astype(np.int64)


def _test_arrays(n=24):
    rng = np.random.default_rng(21)
    b = [_batch(seed=30 + i) for i in range(3)]
    fields = {k: np.concatenate([x[k] for x in b])[:n] for k in b[0]}
    fields.pop("example_mask")
    fields["temporal_order"] = rng.random(n) < 0.5
    return PairArrays(**fields)


def _cfgs1(reg):
    """tests/test_torch_train_step.py's configs with one encoder layer."""
    return [dataclasses.replace(c, model=dataclasses.replace(
        c.model, encoder=dataclasses.replace(c.model.encoder, num_layers=1)))
        for c in _cfgs(reg)]


@contextlib.contextmanager
def _jax_noise():
    """JAX's sample_prior and club permutation read EPS and PERM."""
    def sample_prior(rng, mu, log_var, compat=True):
        return mu + jnp.asarray(EPS)[None, :] * jnp.exp(log_var)

    proxy = types.SimpleNamespace(
        random=types.SimpleNamespace(
            permutation=lambda rng, n: jnp.asarray(PERM)),
        lax=jax.lax)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jdrl, "sample_prior", sample_prior)
        mp.setattr(jregistry, "jax", proxy)
        yield


def _jax_mesh_run(reg, params, batches):
    """JAX's epoch step on a dp2 x tp2 mesh over the four batches (two
    epochs of two): losses and params after."""
    jcfg, _ = _cfgs1(reg)
    jm = JDrlModel(jcfg.model)
    mesh = j_make_mesh(4, axes=("data", "model"), shape=(2, 2))
    state = j_create_state(jcfg, j_shard_params_tp(mesh, params),
                           jax.random.key(2))
    ep = j_make_epoch_step(jcfg, jm)
    losses = []
    for pair in ((0, 1), (2, 3)):
        stacked = {k: np.stack([batches[i][k] for i in pair])
                   for k in batches[0]}
        state, ls = ep(state, j_shard_stacked(mesh, stacked), VI_BETA)
        losses += np.asarray(ls).tolist()
    return dict(losses=losses,
                params=jax_params_to_state_dict(_np(state.params)))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The four-rank run, and JAX's dp2 x tp2 runs made meanwhile."""
    out = str(tmp_path_factory.mktemp("world"))
    batches = [_batch(seed=3 + i) for i in range(4)]
    init, jparams, cfgs, by_model = {}, {}, {}, {}
    first = {k: jnp.asarray(v) for k, v in batches[0].items()}
    for reg in REGS:
        jcfg, tcfg = _cfgs1(reg)
        if jcfg.model not in by_model:  # one init a model config
            by_model[jcfg.model] = jax.jit(JDrlModel(jcfg.model).init)(
                {"params": jax.random.key(0), "sample": jax.random.key(1)},
                first["input_ids"], first["attention_mask"],
                first["token_type_ids"])["params"]
        jparams[reg] = by_model[jcfg.model]
        init[reg] = jax_params_to_state_dict(_np(jparams[reg]))
        cfgs[reg] = tcfg
    torch.save(dict(regs=REGS, cfgs=cfgs, init=init, batches=batches,
                    eps=(EPS, EPS), perm=PERM, vi_beta=VI_BETA,
                    test_arrays=_test_arrays()),
               os.path.join(out, "inputs.pt"))
    port = free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "tests.torch_parallel_worker", str(r), "4",
         str(port), out], cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(4)]
    try:
        # the four JAX compiles overlap in threads (the patched noise needs
        # no call order)
        with _jax_noise(), ThreadPoolExecutor(len(REGS)) as pool:
            jax_runs = dict(zip(REGS, pool.map(
                lambda reg: _jax_mesh_run(reg, jparams[reg], batches),
                REGS)))
        logs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for r, p in enumerate(procs):
        assert p.returncode == 0, f"rank {r}:\n{logs[r][-3000:]}"
    ranks = [torch.load(os.path.join(out, f"rank{r}.pt"),
                        weights_only=False) for r in range(4)]
    runs = {}
    for res in ranks:
        runs.update({k: v for k, v in res.items() if isinstance(k, tuple)})
    return dict(runs=runs, ranks=ranks, jax=jax_runs, out=out,
                init=init, cfgs=cfgs)


STEPS = 4


def _hold_params(got, want, grads, labels, what):
    """|got - want| within 2 lr of the group a step everywhere and 1e-3 lr a
    step where the last gradient is above 1e-3 of its tensor's largest."""
    for name, w in want.items():
        g = torch.as_tensor(np.asarray(got[name]))
        w = torch.as_tensor(np.asarray(w))
        lr = GROUP_LR.get(labels[name], GROUP_LR["main"])
        err = (g - w).abs() / lr
        assert float(err.max()) <= 2.0 * STEPS, (what, name,
                                                 float(err.max()))
        grad = grads.get(name)
        if grad is not None and float(grad.abs().max()) > 0:
            safe = grad.abs() > 1e-3 * grad.abs().max()
            if safe.any():
                worst = float(err[safe].max())
                assert worst <= 1e-3 * STEPS, (what, name, worst)


@pytest.mark.parametrize("reg", REGS)
@pytest.mark.parametrize("case", CASES)
def test_mesh_matches_one_process(world, case, reg):
    run, ref = world["runs"][(case, reg)], world["runs"][("single", reg)]
    np.testing.assert_allclose(run["losses"], ref["losses"], rtol=1e-5)
    _hold_params(run["params"], ref["params"], ref["grads"], ref["labels"],
                 (case, reg))


@pytest.mark.parametrize("reg", REGS)
@pytest.mark.parametrize("case", CASES)
def test_mesh_matches_jax_mesh(world, case, reg):
    run, ref = world["runs"][(case, reg)], world["jax"][reg]
    single = world["runs"][("single", reg)]
    if reg == "gan":
        np.testing.assert_allclose(run["totals"], ref["losses"][:2],
                                   rtol=1e-4)
    else:
        np.testing.assert_allclose(run["losses"], ref["losses"], rtol=1e-4)
    _hold_params(run["params"], ref["params"], single["grads"],
                 single["labels"], (case, reg, "jax"))


def test_replicated_params_bit_equal_with_dropout(world):
    """dp2 x tp2, dropout 0.1, three steps: every rank holds the same
    replicated parameters, bit for bit."""
    reps = [r["replicated"] for r in world["ranks"]]
    assert {r["coords"] for r in world["ranks"]} == {(0, 0), (0, 1), (1, 0),
                                                     (1, 1)}
    assert len(reps[0]) > 10
    moved = [n for n in reps[0]
             if not torch.equal(reps[0][n], world["init"]["mmd"][n])]
    assert "encoder.embeddings_ln.weight" in moved
    for other in reps[1:]:
        for name, t in reps[0].items():
            assert torch.equal(t, other[name]), name


def test_mesh_shape_must_cover_the_devices(world):
    for r in world["ranks"]:
        assert r["shape_error"] == "mesh shape (3, 1) does not cover 4 devices"


def test_dp2tp2_state_snapshot_round_trip(world):
    """save_state under dp2 x tp2 writes whole params and moments; every
    rank's load_state gives back its own split params, moments and step,
    and the file loads into a one-device state with the whole params."""
    assert all(r["state_round_trip"] for r in world["ranks"])
    cfg = world["cfgs"]["mmd"]
    state = ckpt.load_state(world["out"], "dp2tp2", create_train_state(
        cfg, DrlModel(cfg.model), torch.Generator()))
    best = torch.load(ckpt.best_path(world["out"], "dp2tp2"))
    assert state.step == 2
    for k, v in state.model.state_dict().items():
        assert torch.equal(v, best[k]), k


def test_dp2tp2_checkpoint_loads_on_one_device(world):
    cfg = world["cfgs"]["mmd"]
    model = DrlModel(cfg.model)
    ckpt.load_best_into(world["out"], "dp2tp2", model)
    probs = evaluate(make_eval_step(), model, _test_arrays(), 0,
                     torch.Generator().manual_seed(3), 16).probs
    np.testing.assert_allclose(probs, world["ranks"][0]["checkpoint_probs"],
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("adapter", [AdapterKind.NONE, AdapterKind.RAW])
def test_tp_layout_matches_jax_by_name(adapter):
    """Every parameter's split: the port's ``_spec_for`` by state_dict name
    against JAX's by its param path (no compile: eval_shape)."""
    jcfg, tcfg = _cfgs("mmd")
    jcfg = dataclasses.replace(jcfg, model=dataclasses.replace(
        jcfg.model, adapter=type(jcfg.model.adapter)(adapter.value)))
    tcfg = dataclasses.replace(tcfg, model=dataclasses.replace(
        tcfg.model, adapter=adapter))
    b = {k: jnp.asarray(v) for k, v in _batch().items()}
    shapes = jax.eval_shape(lambda: JDrlModel(jcfg.model).init(
        {"params": jax.random.key(0), "sample": jax.random.key(1)},
        b["input_ids"], b["attention_mask"], b["token_type_ids"]))["params"]
    leaf_key = {"kernel": "weight", "embedding": "weight", "scale": "weight",
                "bias": "bias", "query": "query"}
    want = {}
    for path, _ in jax.tree_util.tree_flatten_with_path(shapes)[0]:
        keys = [p.key for p in path]
        spec = tuple(j_spec_for(path))
        if spec == (None, None, "model", None):
            kind = ttp.HEADS  # qkv kernel [hidden, 3, heads, head_dim]
        elif spec == ("model", None, None):
            kind = ttp.HEADS  # out kernel [heads, head_dim, hidden]
        elif spec in ((None, "model"), ("model",)):
            kind = ttp.COLUMNS
        elif spec == ("model", None):
            kind = ttp.ROWS
        else:
            assert spec == (), (keys, spec)
            kind = None
        want[f"{_module_path(tuple(keys[:-1]))}.{leaf_key[keys[-1]]}"] = kind
    names = [n for n, _ in DrlModel(tcfg.model).named_parameters()]
    assert sorted(names) == sorted(want)
    assert {n: ttp._spec_for(n) for n in names} == want
    # qkv, out, mlp_in and its bias, mlp_out in each of the 2 layers
    assert sum(k is not None for k in want.values()) == 5 * 2


def test_tp_shard_is_jaxs_shard():
    """jax_params_to_tp_shard(params, r) equals JAX's own shard on model
    index r of a 1 x 2 mesh (shard_params_tp), converted leaf for leaf:
    the qkv kernel's [hidden, 3, h/2, head_dim] becomes the local qkv
    weight, the replicated qkv bias stays whole."""
    jcfg, tcfg = _cfgs("mmd")
    b = {k: jnp.asarray(v) for k, v in _batch().items()}
    params = jax.jit(JDrlModel(jcfg.model).init)(
        {"params": jax.random.key(0), "sample": jax.random.key(1)},
        b["input_ids"], b["attention_mask"], b["token_type_ids"])["params"]
    mesh = j_make_mesh(2, axes=("data", "model"), shape=(1, 2))
    placed = j_shard_params_tp(mesh, params)
    heads = tcfg.model.encoder.num_heads
    for r, device in enumerate(mesh.devices[0]):
        local = jax.tree_util.tree_map(
            lambda x: np.asarray(next(s.data for s in x.addressable_shards
                                      if s.device == device)), placed)
        want = jax_params_to_state_dict(local)
        got = jax_params_to_tp_shard(_np(params), r, 2, heads)
        assert got.keys() == want.keys()
        for k in want:
            assert torch.equal(got[k], want[k]), (r, k)


def test_shard_tensor_round_trip_and_heads():
    """The qkv rows are (3, heads, head_dim): tp rank r keeps heads
    [r h/tp, (r+1) h/tp) of each of q, k, v; the parts give the whole
    back."""
    h, hd, d = 4, 3, 12
    full = torch.arange(3 * d * d, dtype=torch.float32).view(3 * d, d)
    name = "encoder.layers.0.attention.qkv.weight"
    parts = [ttp.shard_tensor(name, full, r, 2, h) for r in range(2)]
    assert parts[0].shape == (3 * 2 * hd, d)
    assert torch.equal(parts[1].view(3, 2, hd, d),
                       full.view(3, h, hd, d)[:, 2:])
    assert torch.equal(ttp.unshard_tensor(name, parts, h), full)
    for name, shape in (("encoder.layers.0.attention.out.weight", (d, d)),
                        ("encoder.layers.0.mlp_in.weight", (2 * d, d)),
                        ("encoder.layers.0.mlp_in.bias", (2 * d,)),
                        ("encoder.layers.0.mlp_out.weight", (d, 2 * d)),
                        ("encoder.layers.0.attention.qkv.bias", (3 * d,))):
        full = torch.randn(shape)
        parts = [ttp.shard_tensor(name, full, r, 2, h) for r in range(2)]
        assert torch.equal(ttp.unshard_tensor(name, parts, h), full), name


def test_mesh_shape_parsing(tmp_path):
    """As tests/test_mesh_cli.py: two integers or SystemExit."""
    parser = build_parser()
    base = ["train", "--device", "cpu", "--cache_dir", str(tmp_path)]
    args = parser.parse_args(base + ["--mesh_shape", "4,2"])
    cfg = _apply_overrides(PRESETS[args.preset], args)
    assert cfg.train.mesh_shape == (4, 2)
    for bad in ("8", "4,2,1", "a,b"):
        args = parser.parse_args(base + ["--mesh_shape", bad])
        with pytest.raises(SystemExit):
            _apply_overrides(PRESETS[args.preset], args)
    args = parser.parse_args(base + ["--num_devices", "0"])
    assert _apply_overrides(PRESETS[args.preset], args).train.num_devices \
        == 0


def test_batch_not_divisible_by_dp_raises():
    mesh = Mesh(shape=(3, 1), axes=("data", "model"), rank=0, dp_rank=0,
                tp_rank=0, dp_group=None, tp_group=None, group=None)
    with pytest.raises(ValueError, match="not divisible"):
        shard_batch(mesh, {"x": np.zeros((8, 2))})
    with pytest.raises(ValueError, match="not divisible"):
        shard_stacked(mesh, {"x": np.zeros((2, 8, 2))})
    got = shard_stacked(dataclasses.replace(mesh, shape=(4, 1), dp_rank=2),
                        {"x": np.arange(16).reshape(2, 8)})
    np.testing.assert_array_equal(got["x"], [[4, 5], [12, 13]])


def _train_verb(root, tmp, tag, extra):
    from carel_tpu_torch.cli.main import main

    log = os.path.join(tmp, f"log_{tag}")
    argv = ["train", "--data_root", root, "--encoder", "tiny", "--device",
            "cpu", "--epochs", "1", "--self_iteration", "1",
            "--self_epochs", "1", "--batch_size", "8", "--max_train_docs",
            "12", "--max_test_docs", "8", "--cache_dir",
            os.path.join(tmp, "cache"), "--checkpoint_dir",
            os.path.join(tmp, f"ck_{tag}"), "--log_dir", log] + extra
    return argv, log


def _events(log):
    (name,) = os.listdir(log)
    with open(os.path.join(log, name)) as f:
        return [json.loads(line) for line in f]


def test_train_verb_mesh_of_one_gives_the_bits_of_no_mesh(tmp_path,
                                                          capsys):
    from carel_tpu_torch.cli.main import main

    root = str(tmp_path / "data")
    write_zh_newsplit_corpus(root, n_train=12, n_test=8, n_extra=4)
    losses, best = {}, {}
    for tag, extra in (("none", []), ("mesh", ["--mesh_shape", "1,1"])):
        argv, log = _train_verb(root, str(tmp_path), tag, extra)
        assert main(argv) == 0
        line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        events = _events(log)
        losses[tag] = [e["losses"] for e in events if e["event"] == "train"]
        done = [e for e in events if e["event"] == "self_done"][0]
        assert done["launches"]["bow_fwd"] == 0  # the CPU: plain versions
        assert done["captures"] == 0 and done["replays"] == 0  # the CPU
        best[tag] = torch.load(ckpt.best_path(str(tmp_path / f"ck_{tag}"),
                                              line["model_id"]))
    assert [e["mesh_shape"] for e in _events(log)
            if e["event"] == "config"] == [[1, 1]]
    assert len(losses["none"]) == 2 and losses["none"] == losses["mesh"]
    for k, v in best["none"].items():
        assert torch.equal(v, best["mesh"][k]), k


def test_train_verb_spawns_two_workers(tmp_path):
    root = str(tmp_path / "data")
    write_zh_newsplit_corpus(root, n_train=12, n_test=8, n_extra=4)
    argv, log = _train_verb(root, str(tmp_path), "dp2",
                            ["--mesh_shape", "2,1", "--self_iteration", "0"])
    proc = subprocess.run([sys.executable, "-m", "carel_tpu_torch.cli"]
                          + argv, cwd=ROOT, capture_output=True, text=True,
                          timeout=300,
                          env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = [json.loads(x) for x in proc.stdout.strip().splitlines()]
    assert len(lines) == 1 and 0.0 <= lines[0]["best_f1"] <= 1.0
    events = _events(log)
    assert [e["mesh_shape"] for e in events if e["event"] == "config"] \
        == [[2, 1]]
    assert np.isfinite([e["loss"] for e in events
                        if e["event"] == "train"]).all()
