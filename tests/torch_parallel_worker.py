"""One rank of tests/test_torch_parallel.py's gloo world (imports no JAX):

    python -m tests.torch_parallel_worker RANK WORLD PORT DIR

reads DIR/inputs.pt (configs, initial parameters, batches, noise and
permutation, the test arrays), joins the world on 127.0.0.1:PORT and runs,
for every regularizer, two eager train steps and one epoch of the epoch
step (uncaptured on the CPU) over meshes dp4, dp2 x tp2 and dp1 x tp2 (the
last on ranks 0 and 1; meanwhile rank 2 runs the same on one process,
without a mesh); then three steps under dp2 x tp2 with dropout on, and a
best checkpoint of dp2 x tp2 with its evaluation, and its full state saved
and loaded back. Rank 0 of each mesh (and
rank 2 for the one-process runs) writes DIR/rank<R>.pt.
"""

import os
import sys

import numpy as np
import torch
import torch.distributed as dist

from carel_tpu_torch.models.drl import DrlModel
from carel_tpu_torch.parallel.mesh import init_distributed, make_mesh
from carel_tpu_torch.parallel.sharding import (shard_batch, shard_params,
                                               shard_stacked)
from carel_tpu_torch.parallel.tp import (_spec_for, full_state_dict,
                                         shard_params_tp)
from carel_tpu_torch.train import checkpoint as ckpt
from carel_tpu_torch.train.loop import evaluate
from carel_tpu_torch.train.scan_epoch import make_epoch_step
from carel_tpu_torch.train.state import create_train_state
from carel_tpu_torch.train.steps import (batch_to_device, make_eval_step,
                                         make_train_step)

CPU = torch.device("cpu")


def build(cfg, init, mesh):
    model = DrlModel(cfg.model)
    model.load_state_dict(init)
    if mesh is not None:
        if mesh.tp > 1:
            shard_params_tp(mesh, model)
        else:
            shard_params(mesh, model)
        model.mesh = mesh
    return create_train_state(cfg, model, torch.Generator())


def train(inp, reg, mesh):
    """Two eager steps and one epoch (two batches) from ``inp``'s params;
    the losses, the whole params and the last gradients."""
    cfg = inp["cfgs"][reg]
    state = build(cfg, inp["init"][reg], mesh)
    eps = tuple(torch.from_numpy(e) for e in inp["eps"])
    perm = torch.from_numpy(inp["perm"])
    batches = inp["batches"]
    step = make_train_step(cfg)
    losses, totals = [], []
    for i in range(2):
        b = batches[i] if mesh is None else shard_batch(mesh, batches[i])
        m = step(state, batch_to_device(b, CPU), i, inp["vi_beta"],
                 eps=eps, perm=perm)
        losses.append(float(m["loss"]))
        # the loss differentiated under gan, with the disc BCEs
        totals.append(float(m["loss"] + m.get("ec_disc_loss", 0.0)
                            + m.get("ce_disc_loss", 0.0)))
    stacked = {k: np.stack([batches[2][k], batches[3][k]])
               for k in batches[2]}
    if mesh is not None:
        stacked = shard_stacked(mesh, stacked)
    losses += make_epoch_step(cfg)(state, stacked, inp["vi_beta"], eps=eps,
                                   perm=perm).tolist()
    grads = {n: p.grad.clone() for n, p in state.model.named_parameters()
             if p.grad is not None}
    return dict(losses=losses, totals=totals,
                params=full_state_dict(state.model, mesh), grads=grads,
                labels=state.labels)


def dropout_run(inp, mesh):
    """Three steps under mesh with dropout 0.1 (the mmd config); this
    rank's replicated params."""
    import dataclasses

    cfg = inp["cfgs"]["mmd"]
    enc = dataclasses.replace(cfg.model.encoder, dropout=0.1)
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, encoder=enc, dropout=0.1))
    torch.manual_seed(5)
    state = build(cfg, inp["init"]["mmd"], mesh)
    step = make_train_step(cfg)
    for i in range(3):
        b = shard_batch(mesh, inp["batches"][i])
        step(state, batch_to_device(b, CPU), i)
    return {n: p.detach().clone() for n, p in
            state.model.named_parameters() if _spec_for(n) is None}


def checkpoint_run(inp, mesh, out):
    """Two steps under ``mesh``, the best checkpoint written and the test
    set evaluated with a seeded generator."""
    cfg = inp["cfgs"]["mmd"]
    state = build(cfg, inp["init"]["mmd"], mesh)
    step = make_train_step(cfg)
    eps = tuple(torch.from_numpy(e) for e in inp["eps"])
    for i in range(2):
        b = shard_batch(mesh, inp["batches"][i])
        step(state, batch_to_device(b, CPU), i, eps=eps)
    ckpt.save_best_of(out, "dp2tp2", state.model, mesh)
    res = evaluate(make_eval_step(), state.model, inp["test_arrays"], 0,
                   torch.Generator().manual_seed(3), 16, mesh)
    # the full state, whole on disk, back into a fresh split state
    ckpt.save_state(out, "dp2tp2", state, mesh)
    fresh = ckpt.load_state(out, "dp2tp2", build(cfg, inp["init"]["mmd"],
                                                  mesh), mesh)
    same = fresh.step == state.step and all(
        torch.equal(a, b) for a, b in zip(state.model.parameters(),
                                          fresh.model.parameters()))
    for p, q in zip(state.model.parameters(), fresh.model.parameters()):
        for k, v in state.optimizer.state.get(p, {}).items():
            same = same and torch.equal(v, fresh.optimizer.state[q][k])
    return res.probs, same


def main(rank: int, world: int, port: int, out: str) -> None:
    torch.set_num_threads(1)
    inp = torch.load(os.path.join(out, "inputs.pt"), weights_only=False)
    init_distributed(rank, world, port, CPU)
    results = {}
    try:
        make_mesh(4, shape=(3, 1))
    except ValueError as err:
        results["shape_error"] = str(err)
    meshes = {"dp4": make_mesh(4, shape=(4, 1)),
              "dp2tp2": make_mesh(4, shape=(2, 2)),
              "dp1tp2": make_mesh(2, shape=(1, 2))}
    for name, mesh in meshes.items():
        if mesh is None:
            continue
        for reg in inp["regs"]:
            run = train(inp, reg, mesh)
            if mesh.rank == 0:
                results[(name, reg)] = run
    if rank == 2:
        for reg in inp["regs"]:
            results[("single", reg)] = train(inp, reg, None)
    results["replicated"] = dropout_run(inp, meshes["dp2tp2"])
    results["coords"] = (meshes["dp2tp2"].dp_rank, meshes["dp2tp2"].tp_rank)
    probs, results["state_round_trip"] = checkpoint_run(
        inp, meshes["dp2tp2"], out)
    if rank == 0:
        results["checkpoint_probs"] = probs
    torch.save(results, os.path.join(out, f"rank{rank}.pt"))
    dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
