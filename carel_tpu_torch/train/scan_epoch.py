"""Whole-epoch training, the counterpart of carel_tpu/train/scan_epoch.py.

The JAX package stacks an epoch's batches into device-resident
``[nb, B, ...]`` arrays and ``lax.scan``s its train step over them: one
dispatch per epoch. Here the epoch goes to the card in one host-to-device
copy, and one train step (``train/steps.py: make_step_body``), captured once
in a CUDA graph, is replayed once per batch: a replay launches the ~1,500
kernels of a step without the host's cost per kernel.

Semantics are those of the per-step loop: the same body runs per batch;
``iteration`` is the within-epoch batch index, whose KL-annealing weight the
host computes in double and packs beside the batch; the tail batch stays
masked; the noise, the dropout masks and the vi permutation come from the
same generators in the same order. On the CPU the epoch step runs the body
eagerly over the batches.

Capture (CUDA), at first use and again whenever the state no longer matches
the capture (``capture_key``): the step is warmed up on a side stream, which
creates the optimizers' state, then captured on static input buffers, with
the sampling generator registered with the graph (the default generator,
which dropout draws from, always is). Warm-up and capture must not change
the run, so the params, every optimizer state tensor, the step count and both
generators are copied first and restored in place after the capture; the
captured epoch then consumes the state and the random streams the eager
epoch would. Per batch the host copies the batch's row of the epoch into the
static buffers, replays and copies the loss out: three operations a step.
There is no fallback: if the capture fails on the card, it raises.

The batch shape is fixed by ``cut_batch``, so one capture serves the base
epochs and every self-training fine-tune: a pseudo set of another size is
only another number of replays. (The JAX CLI falls back to its per-step
loop when the pseudo-set size varies, to spare a compile per size; the port
has no such cost.)

Under a mesh each rank stacks its rows of the epoch (``shard_stacked``) and
captures the step with its collectives (the gathers over 'data' and the
gradient sum; NCCL on the card). The warm-up runs every collective once
outside the capture, which creates NCCL's communicators before the graph
needs them, and every rank restores its own state after it.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

from carel_tpu_torch import ops
from carel_tpu_torch.config import CarelConfig
from carel_tpu_torch.data.batching import PairArrays, cut_batch
from carel_tpu_torch.losses.vae import annealed_kl_weight
from carel_tpu_torch.train.state import TrainState, dropout_generator
from carel_tpu_torch.train.steps import make_step_body
from carel_tpu_torch.utils.profiling import span

# byte alignment of each array in a packed batch row
_ALIGN = 256
# eager steps before a capture: the first creates the optimizers' state,
# the second runs the step as every later one will
WARMUP_STEPS = 2


def stack_epoch(
    arrays: PairArrays,
    batch_size: int,
    rng: Optional[np.random.Generator] = None,
) -> Dict[str, np.ndarray]:
    """Shuffle and stack the dataset into [nb, B, ...] numpy arrays (the
    shuffle of ``iter_batches`` for the same ``rng``)."""
    n = len(arrays)
    nb = -(-n // batch_size)
    with span("stack_epoch", batches=nb):
        order = np.arange(n)
        if rng is not None:
            rng.shuffle(order)
        batches = [cut_batch(arrays,
                             order[i * batch_size:(i + 1) * batch_size],
                             batch_size).as_dict() for i in range(nb)]
        return {k: np.stack([b[k] for b in batches]) for k in batches[0]}


@dataclasses.dataclass(frozen=True)
class RowLayout:
    """Where each array of one batch lies in a packed row of bytes:
    (key, byte offset, dtype, shape) per array, and the row's length."""

    fields: tuple
    nbytes: int


def pack_epoch(stacked: Dict[str, np.ndarray], kl_weights: Sequence[float],
               vi_beta: float, pin: bool = False):
    """(layout, rows): batch i of ``stacked``, its KL weight and ``vi_beta``
    (both rounded to float32) packed into row i of a uint8 tensor [nb,
    nbytes], in pinned memory when ``pin``, so that the epoch goes to the
    card in one copy and a batch into the captured step's buffers in
    another."""
    arrays = dict(stacked)
    nb = len(kl_weights)
    arrays["kl_weight"] = np.asarray(kl_weights, np.float32)
    arrays["vi_beta"] = np.full(nb, vi_beta, np.float32)
    fields, offset = [], 0
    for key, a in arrays.items():
        if a.shape[0] != nb:
            raise ValueError(f"{key}: {a.shape[0]} batches, expected {nb}")
        dtype = torch.from_numpy(np.empty(0, a.dtype)).dtype
        fields.append((key, offset, dtype, tuple(a.shape[1:])))
        offset += -(-a[0].nbytes // _ALIGN) * _ALIGN
    rows = torch.zeros((nb, offset), dtype=torch.uint8, pin_memory=pin)
    host = rows.numpy()
    for key, start, _, _ in fields:
        flat = np.ascontiguousarray(arrays[key]).reshape(nb, -1)
        flat = flat.view(np.uint8)
        host[:, start:start + flat.shape[1]] = flat
    return RowLayout(tuple(fields), offset), rows


def unpack_row(row: torch.Tensor, layout: RowLayout):
    """(batch, kl_weight, vi_beta): views of one packed row, the weights as
    0-d float32 tensors."""
    views = {}
    for key, start, dtype, shape in layout.fields:
        n = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
        views[key] = row[start:start + n].view(dtype).view(shape)
    return views, views.pop("kl_weight"), views.pop("vi_beta")


def _addr(value):
    return ("tensor", value.data_ptr()) if isinstance(value, torch.Tensor) \
        else value


def _optimizers(state: TrainState):
    return (state.optimizer, state.disc_optimizer, state.club_optimizer)


def capture_key(state: TrainState, layout: RowLayout) -> tuple:
    """What a captured step holds fixed: the batch layout, the sampling
    generator, the mesh, the params' addresses and requires_grad, every optimizer's
    hyper-parameters (a tensor lr by its address, since a replay reads its
    value) and the addresses of its state tensors. A capture whose key no
    longer matches the state is stale. ``model.load_state_dict`` copies in
    place and keeps the key; ``checkpoint.load_state`` replaces the
    optimizers' state tensors and changes it."""
    mesh = state.model.mesh
    key = [layout, id(state.generator), mesh.key() if mesh else None]
    key += [(p.data_ptr(), p.requires_grad)
            for p in state.model.parameters()]
    for opt in _optimizers(state):
        for group in opt.param_groups:
            key.append(tuple((k, _addr(v)) for k, v in sorted(group.items())
                             if k != "params"))
            key += [tuple((k, _addr(v)) for k, v in
                          sorted(opt.state.get(p, {}).items()))
                    for p in group["params"]]
    return tuple(key)


class Snapshot:
    """Copies of what a warm-up and a capture change: the ``params``, every
    state tensor of the ``optimizers``, the ``tensors`` (a step counter)
    and the ``generators``' states. ``restore`` writes them back in place
    and zeroes the optimizer state tensors created since, which is the
    state a first optimizer step creates (Adam's step and moments,
    RMSprop's nu)."""

    def __init__(self, params, optimizers, generators, tensors=()):
        self.optimizers = tuple(optimizers)
        self.params = [(p, p.detach().clone()) for p in params]
        self.tensors = [(t, t.clone()) for t in tensors]
        self.opt = {id(t): (t, t.clone()) for t in self._opt_tensors()}
        self.gens = [(g, g.get_state()) for g in generators]

    def _opt_tensors(self):
        for opt in self.optimizers:
            for entry in opt.state.values():
                for value in entry.values():
                    if isinstance(value, torch.Tensor):
                        yield value

    @torch.no_grad()
    def restore(self) -> None:
        for p, saved in self.params + self.tensors:
            p.copy_(saved)
        for t in self._opt_tensors():
            if id(t) in self.opt:
                t.copy_(self.opt[id(t)][1])
            else:
                t.zero_()
        for gen, saved in self.gens:
            gen.set_state(saved)


class _Snapshot(Snapshot):
    """A ``Snapshot`` of a TrainState: its params, its three optimizers,
    the sampling and dropout generators and the step count."""

    def __init__(self, state: TrainState):
        device = next(state.model.parameters()).device
        super().__init__(state.model.parameters(), _optimizers(state),
                         (state.generator, dropout_generator(device)))
        self.step = state.step

    def restore(self, state: TrainState) -> None:
        super().restore()
        state.step = self.step


def _diff(after: dict, before: dict) -> dict:
    return {k: after[k] - before.get(k, 0) for k in after
            if after[k] != before.get(k, 0)}


def capture_graph(fn: Callable, restore: Callable,
                  generator: torch.Generator, device: torch.device):
    """``fn()`` warmed up WARMUP_STEPS times on a side stream, then one
    call captured in a CUDA graph with ``generator`` registered;
    ``restore()`` then rolls back what the warm-up and the capture changed,
    and the ops' launch counts are left as they were. Returns (the graph,
    the captured call's output, the warm-up's launches, the captured
    launches). There is no fallback: a failed capture raises."""
    counts = ops.launch_counts()
    graph = torch.cuda.CUDAGraph()
    try:
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            for _ in range(WARMUP_STEPS):
                fn()
        torch.cuda.current_stream(device).wait_stream(side)
        warm = ops.launch_counts()
        graph.register_generator_state(generator)
        with torch.cuda.graph(graph, stream=side):
            out = fn()
        captured = ops.launch_counts()
    finally:
        restore()
        ops.reset_launch_counts()
        ops.add_launches(counts)
    return graph, out, _diff(warm, counts), _diff(captured, warm)


class EpochStep:
    """``step(state, stacked, vi_beta) -> losses[nb]``: one epoch of train
    steps over ``stacked`` (``stack_epoch``'s arrays), the main loss of each
    batch as a device tensor (not synchronized). ``eps`` and ``perm`` fix
    the noise and the vi permutation of every batch, on the CPU only.

    Counters: ``captures`` made, ``replays`` run, and the kernel launches
    of the captured step (``captured_launches``) and of the last capture's
    warm-up (``warmup_launches``), {name: n}. The wrappers count a captured
    launch once, at capture; the launch counts of ``ops`` leave out the
    warm-up and the capture and add the captured launches once a replay."""

    is_epoch_step = True

    def __init__(self, cfg: CarelConfig):
        self.cfg = cfg
        self.body = make_step_body(cfg)
        self.captures = 0
        self.replays = 0
        self.captured_launches: dict = {}
        self.warmup_launches: dict = {}
        self._graph = None
        self._key = None
        self._row = None
        self._loss = None
        self._out = None
        self._moe = None
        self.moe_counts: dict = {}

    def __call__(self, state: TrainState, stacked: Dict[str, np.ndarray],
                 vi_beta: float,
                 eps: Optional[Sequence[torch.Tensor]] = None,
                 perm: Optional[torch.Tensor] = None) -> torch.Tensor:
        with span("epoch_step"):
            lc = self.cfg.loss
            nb = stacked["input_ids"].shape[0]
            device = next(state.model.parameters()).device
            cuda = device.type == "cuda"
            with span("epoch_step.pack"):
                weights = [annealed_kl_weight(i, lc.kl_ann_iterations,
                                              lc.ec_kl_lambda)
                           for i in range(nb)]
                layout, rows = pack_epoch(stacked, weights, vi_beta, pin=cuda)
            counters = getattr(state.model.encoder, "moe_counters", None)
            self._moe = None if counters is None else (
                counters, len(state.model.encoder.moe_layers()))
            if not cuda:
                self._zero_moe()
                return self._epoch_out(torch.stack([
                    self.body(state, *unpack_row(rows[i], layout), eps,
                              perm)["loss"] for i in range(nb)]))
            if eps is not None or perm is not None:
                raise ValueError("the captured epoch step draws its noise "
                                 "and permutation from the generators; eps "
                                 "and perm fix them on the CPU only")
            with span("epoch_step.copy", bytes=rows.numel()):
                rows = rows.to(device, non_blocking=True)
            if self._key != capture_key(state, layout):
                with span("epoch_step.capture"):
                    self._capture(state, layout, rows[0])
            # a capture's warm-up counts too: the epoch's counts start here
            self._zero_moe()
            with span("epoch_step.replays", replays=nb):
                losses = torch.empty(nb, dtype=torch.float32, device=device)
                for i in range(nb):
                    self._row.copy_(rows[i])
                    self._graph.replay()
                    losses[i].copy_(self._loss)
            state.step += nb
            self.replays += nb
            ops.add_launches(self.captured_launches, nb)
            return self._epoch_out(losses)

    def _zero_moe(self) -> None:
        if self._moe is not None:
            self._moe[0].zero_()

    def _epoch_out(self, losses: torch.Tensor) -> torch.Tensor:
        """``losses``, or where the encoder has mixture layers the view of
        a float64 buffer (which holds an epoch's counts exactly) that holds
        the epoch's MoE counters after them, so that ``fetch`` reads both
        in one copy."""
        if self._moe is None:
            self._out = losses
            return losses
        nb = losses.shape[0]
        self._out = torch.cat([losses.double(), self._moe[0].double()])
        return self._out[:nb]

    def fetch(self, losses: torch.Tensor) -> np.ndarray:
        """The epoch's ``losses`` (this step's last output) on the host, in
        one copy with the encoder's MoE counters of the same epoch, which
        land in ``moe_counts`` ({held_rows, buffer_rows, max_expert_rows,
        steps, layers}; empty without mixture layers). Under a profiler the
        counts are recorded as the span ``epoch_step.moe``."""
        nb = losses.shape[0]
        host = self._out.cpu().numpy()
        self.moe_counts = {}
        if self._moe is not None:
            held, buffer, most = (int(v) for v in host[nb:nb + 3])
            self.moe_counts = dict(held_rows=held, buffer_rows=buffer,
                                   max_expert_rows=most, steps=nb,
                                   layers=self._moe[1])
            with span("epoch_step.moe", **self.moe_counts):
                pass
        return host[:nb]

    def _capture(self, state: TrainState, layout: RowLayout,
                 first_row: torch.Tensor) -> None:
        # drop the last capture and the gradients it left in its pool
        self._graph = self._row = self._loss = self._key = None
        state.model.zero_grad(set_to_none=True)
        snapshot = _Snapshot(state)
        row = first_row.clone()
        batch, kl_weight, vi_beta = unpack_row(row, layout)
        graph, metrics, self.warmup_launches, self.captured_launches = \
            capture_graph(lambda: self.body(state, batch, kl_weight, vi_beta),
                          lambda: snapshot.restore(state), state.generator,
                          first_row.device)
        self._graph, self._row, self._loss = graph, row, metrics["loss"]
        self._key = capture_key(state, layout)
        self.captures += 1


def make_epoch_step(cfg: CarelConfig) -> Callable:
    """The whole-epoch train step for this config (see ``EpochStep``)."""
    return EpochStep(cfg)
