"""The hand-written CUDA kernels K1-K9 against their plain PyTorch versions,
on the card. Every test here is marked ``cuda`` and skips without a GPU (the
kernels have no CPU mode). This file imports nothing of JAX, so it also runs
on a GPU machine without JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels.py -q

Tolerances: values rtol 1e-5; grads normwise relative error 1e-5 (MMD) and
1e-4 (BoW, HSIC), the gates of chip_smoke.py. HSIC (K5/K6 compute in
double) is held against its plain version evaluated in float64 on the same
inputs: with tight latents the plain fp32 version itself is off by ~3e-4
(tests/test_torch_hsic.py). Flash attention (K7-K9) is held against its
plain version evaluated in fp32 from the same inputs: fp32 inputs (the
CUDA-core kernels) to 1e-5 (output) and 1e-4 (gradients), where only the
order of the sums differs; bf16 inputs (the tensor-core kernels) to 6e-3
and 8e-3, three times the errors measured on the card (2.0e-3, 2.6e-3: the
kernels round the probabilities, ds and the results to bf16;
tests/test_torch_attention.py repeats that arithmetic on the CPU). The BoW
forward (K3) and backward (K4), each one cooperative launch, are also held
at ragged shapes and under other plans, must refuse a grid that cannot be
resident, and replay bit-equal from a CUDA graph. The MMD kernels K1
(forward, one launch whose last block merges) and K2 (backward, a warp a
row) are held at ragged B up to 1,024 and four alphas, launch one device
kernel each, leave K1's ticket at 0 between calls, and replay bit-equal from
one CUDA graph. The HSIC backward K6 (a warp a gradient row, the lanes merged
by shuffles) is held against the float64 plain version at ragged B up to
4,096 with g != 1, and with K5 at d of 1, 8, 13, 17 and 32 (every instance
of K6) at both input scales; K5 (one cooperative launch) and K6 launch one device
kernel each, replay bit-equal from one CUDA graph, and the wrappers refuse
d = 33, B = 1 and sigmas that are not positive. K7, K8 and K9 replay
bit-equal from one CUDA graph. The captured epoch step (train/scan_epoch.py)
at tiny widths equals the eager per-step loop from equal seeds (losses rel
1e-5; params within 2 lr a step, the 99th percentile of every tensor within
0.05 lr, as the CPU tests hold it against JAX) under every step variant,
and a capture made stale by load_state is made again; captured through
a mesh of one rank (NCCL, the collectives in the graph) it gives the bits
of no mesh. A tiny fp32 step of
the original 3-latent DRL (train/steps_original.py) on the card equals the
CPU's (losses rel 1e-4, params within 2 lr of their group), its latent heads
unchanged and its adversaries moved on both. A tiny fp32 MLM step
(pretrain/mlm.py), captured on the card, equals the CPU's eager one (loss
rel 1e-4, gradients 1e-3 normwise, params within 2 lr, 1e-3 lr where the
gradient is not noise) and launches K7-K9 and K10 as the path does; with
the head's capacity forced under some steps' masked rows, a captured run
and an eager run give the same bits.
"""

import numpy as np
import pytest
import torch

from carel_tpu_torch import ops
from carel_tpu_torch.ops import cuda_attention, cuda_bow, cuda_pairwise

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    from carel_tpu_torch.device import resolve_device

    return resolve_device("cuda")


def _relnorm(a, b):
    return float(torch.linalg.vector_norm((a - b).double())
                 / torch.linalg.vector_norm(b.double()))


def _mmd_problem(device, B, masked, d=24, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, d)).astype(np.float32)
    y = (rng.normal(size=(B, d)) * 1.2 + 0.3).astype(np.float32)
    mask = np.ones(B, np.float32)
    mask[B - masked:] = 0.0
    return tuple(torch.tensor(a, device=device) for a in (x, y, mask))


def _bow_problem(device, B=64, D=48, V=23808, T=128, masked=4, seed=1):
    rng = np.random.default_rng(seed)
    h = rng.normal(size=(B, D)).astype(np.float32)
    W = (rng.normal(size=(V, D)) * 0.2).astype(np.float32)
    b = (rng.normal(size=V) * 0.1).astype(np.float32)
    idx = rng.integers(0, V, (B, T)).astype(np.int32)
    idx[:, T // 4:] = -1  # padded nnz slots
    idx[0, 1] = idx[0, 0]  # duplicate index in one row
    wts = np.where(idx >= 0, rng.random((B, T)), 0.0).astype(np.float32)
    wts /= wts.sum(axis=1, keepdims=True)
    mask = np.ones(B, np.float32)
    mask[B - masked:] = 0.0
    return tuple(torch.tensor(a, device=device)
                 for a in (h, W, b, idx, wts, mask))


MMD_FOUR_ALPHAS = (0.1, 0.5, 1.0, 2.0)  # as many as the kernels take


# ragged B: one tile of K1 (2), a tile short of or past a multiple of the
# tile rows (63, 65), many blocks (1,000, 1,024) and several chunks of K2
@pytest.mark.parametrize("B,masked,alphas", [
    (64, 0, (0.1,)), (61, 3, (0.1,)), (13, 2, (0.1,)), (2, 0, (0.1,)),
    (63, 5, (0.1,)), (65, 1, (0.1,)), (1000, 7, (0.1,)), (1024, 9, (0.1,)),
    (1000, 7, MMD_FOUR_ALPHAS)])
def test_mmd_kernels_match_plain(cuda, B, masked, alphas):
    x, y, mask = _mmd_problem(cuda, B, masked)
    xk, yk = x.clone().requires_grad_(), y.clone().requires_grad_()
    xp, yp = x.clone().requires_grad_(), y.clone().requires_grad_()
    ops.reset_launch_counts()
    vk = cuda_pairwise.mmd_statistic(xk, yk, alphas, mask)
    gk = torch.autograd.grad(vk, (xk, yk))
    assert ops.launch_counts()["mmd_fwd"] == 1
    assert ops.launch_counts()["mmd_bwd"] == 1
    vp = cuda_pairwise.mmd_statistic_plain(xp, yp, alphas, mask)
    gp = torch.autograd.grad(vp, (xp, yp))
    torch.testing.assert_close(vk, vp, rtol=1e-5, atol=0)
    for a, c in zip(gk, gp):
        assert _relnorm(a, c) <= 1e-5
        if masked:
            assert float(a[-masked:].abs().max()) == 0.0


def _device_kernels(fn, calls: int = 20) -> list:
    """The names of the device kernels the profiler records over ``calls``
    calls of fn (it may drop a few events, never add any)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    # the first profile of a process may record none of its device events
    with profile(activities=[ProfilerActivity.CUDA]):
        fn()
        torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return [e.name for e in prof.events() if e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]


@pytest.mark.parametrize("B", [64, 1000])
def test_mmd_kernels_launch_one_device_kernel_each(cuda, B):
    """K1 is one launch (its last block merges the partials), K2 one: over
    20 calls the profiler sees one kernel name each, at most 20 times."""
    x, y, mask = _mmd_problem(cuda, B, 3)
    _, res = cuda_pairwise.mmd_forward_kernel(x, y, mask, (0.1,))
    g = torch.ones((), device=cuda)
    ops.reset_launch_counts()
    for fn, name in (
            (lambda: cuda_pairwise.mmd_forward_kernel(x, y, mask, (0.1,)),
             "mmd_fwd_kernel"),
            (lambda: cuda_pairwise.mmd_backward_kernel(x, y, mask, res, g,
                                                       (0.1,)),
             "mmd_bwd_kernel")):
        names = _device_kernels(fn)
        assert 0 < len(names) <= 20, names
        assert all(name in n for n in names), names
    assert ops.launch_counts()["mmd_fwd"] == 22
    assert ops.launch_counts()["mmd_bwd"] == 22


def test_mmd_forward_ticket_returns_to_zero(cuda):
    """Calls at alternating B share one scratch: each leaves K1's ticket at
    0, so the next call's last block merges (a ticket left over would keep
    every block from being the last, and the value would not be written)."""
    from carel_tpu_torch.ops import native

    assert native.consts["carel_mmd_tile_rows"] == \
        cuda_pairwise.MMD_TILE_ROWS
    for B, masked in ((1000, 7), (64, 0), (2, 0), (1000, 7), (65, 1)):
        x, y, mask = _mmd_problem(cuda, B, masked, seed=B)
        out, res = cuda_pairwise.mmd_forward_kernel(x, y, mask, (0.1,))
        torch.cuda.synchronize()
        scratch = cuda_pairwise._mmd_scratch[x.device]
        assert int(scratch[:1].view(torch.int32)[0]) == 0
        want = cuda_pairwise.mmd_statistic_plain(x, y, (0.1,), mask)
        torch.testing.assert_close(out, want, rtol=1e-5, atol=0)
        assert torch.equal(res[0], out)
        assert float(res[1]) == float(mask.sum())
        torch.testing.assert_close(res[2:2 + B], (x * x).sum(1), rtol=1e-6,
                                   atol=0)
        torch.testing.assert_close(res[2 + B:], (y * y).sum(1), rtol=1e-6,
                                   atol=0)


@pytest.mark.parametrize("B", [64, 1000])
def test_mmd_kernels_replay_from_a_cuda_graph(cuda, B):
    """K1 and K2 captured together in one CUDA graph: the replay writes the
    bits of the eager calls (the ticket is back at 0 after every launch)."""
    x, y, mask = _mmd_problem(cuda, B, 3)
    g = torch.full((), 0.5, device=cuda)

    def both():
        out, res = cuda_pairwise.mmd_forward_kernel(x, y, mask, (0.1,))
        return (out, res, *cuda_pairwise.mmd_backward_kernel(
            x, y, mask, res, g, (0.1,)))

    _assert_replays_bit_equal(both)


def _assert_replays_bit_equal(launch, fill=0.0):
    """launch() captured in one CUDA graph and replayed twice writes the
    bits of the eager call (into outputs filled with ``fill`` before the
    replays: NaN shows an element that a replay does not write)."""
    want = [t.clone() for t in launch()]
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = launch()
    for t in got:
        t.fill_(fill)
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        assert all(torch.equal(u, v) for u, v in zip(got, want))


def _hsic_problem(device, B, masked, scale, d=24, seed=0):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(B, d)) * scale).astype(np.float32)
    y = (rng.normal(size=(B, d)) * 1.3 * scale + 0.1 * scale).astype(
        np.float32)
    mask = np.ones(B, np.float32)
    mask[B - masked:] = 0.0
    return tuple(torch.tensor(a, device=device) for a in (x, y, mask))


# B = 1,000 takes K5's multi-block path that evaluates the Gram entries again
# in its second phase (more than 128 rows)
@pytest.mark.parametrize("scale", [0.2, 0.2e-2])
@pytest.mark.parametrize("B,masked", [(64, 0), (61, 3), (13, 2), (1000, 7)])
def test_hsic_kernels_match_plain(cuda, B, masked, scale):
    x, y, mask = _hsic_problem(cuda, B, masked, scale)
    xk, yk = x.clone().requires_grad_(), y.clone().requires_grad_()
    xp = x.double().requires_grad_()
    yp = y.double().requires_grad_()
    ops.reset_launch_counts()
    vk = cuda_pairwise.hsic_statistic(xk, yk, 1.0, 0.7, mask)
    gk = torch.autograd.grad(vk, (xk, yk))
    assert ops.launch_counts()["hsic_fwd"] == 1
    assert ops.launch_counts()["hsic_bwd"] == 1
    vp = cuda_pairwise.hsic_plain(xp, yp, 1.0, 0.7, mask.double())
    gp = torch.autograd.grad(vp, (xp, yp))
    vk, vp = float(vk.detach()), float(vp.detach())
    assert abs(vk - vp) <= 1e-5 * abs(vp)
    for a, c in zip(gk, gp):
        assert _relnorm(a, c) <= 1e-4
        if masked:
            assert float(a[-masked:].abs().max()) == 0.0


# ragged B for K6: one pair of rows (2), short of and past one warp's 32
# lanes (13, 33), short of and past one of its 64-row chunks (61, 65), many
# chunks (1,000, 4,096)
@pytest.mark.parametrize("B,masked", [(2, 0), (13, 0), (33, 0), (61, 3),
                                      (65, 1), (1000, 7), (4096, 9)])
def test_hsic_backward_kernel_at_ragged_b(cuda, B, masked):
    x, y, mask = _hsic_problem(cuda, B, masked, 0.2, seed=B)
    xk, yk = x.clone().requires_grad_(), y.clone().requires_grad_()
    xp = x.double().requires_grad_()
    yp = y.double().requires_grad_()
    ops.reset_launch_counts()
    vk = cuda_pairwise.hsic_statistic(xk, yk, 1.0, 0.7, mask)
    gk = torch.autograd.grad(vk * 0.5, (xk, yk))  # g = 0.5
    assert ops.launch_counts()["hsic_bwd"] == 1
    vp = cuda_pairwise.hsic_plain(xp, yp, 1.0, 0.7, mask.double())
    gp = torch.autograd.grad(vp * 0.5, (xp, yp))
    vk, vp = float(vk.detach()), float(vp.detach())
    assert abs(vk - vp) <= 1e-5 * abs(vp)
    for a, c in zip(gk, gp):
        assert _relnorm(a, c) <= 1e-4
        if masked:
            assert float(a[-masked:].abs().max()) == 0.0


# K6 is instantiated for rows of 8, 16, 24 and 32 coordinates (d rounded up
# to 8): a width at or short of each, and d = 1
@pytest.mark.parametrize("scale", [0.2, 0.2e-2])
@pytest.mark.parametrize("B,masked", [(64, 0), (61, 3)])
@pytest.mark.parametrize("d", [1, 8, 13, 17, 32])
def test_hsic_kernels_at_every_width(cuda, d, B, masked, scale):
    x, y, mask = _hsic_problem(cuda, B, masked, scale, d=d, seed=d)
    xk, yk = x.clone().requires_grad_(), y.clone().requires_grad_()
    xp = x.double().requires_grad_()
    yp = y.double().requires_grad_()
    vk = cuda_pairwise.hsic_statistic(xk, yk, 1.0, 0.7, mask)
    gk = torch.autograd.grad(vk * 0.5, (xk, yk))
    vp = cuda_pairwise.hsic_plain(xp, yp, 1.0, 0.7, mask.double())
    gp = torch.autograd.grad(vp * 0.5, (xp, yp))
    vk, vp = float(vk.detach()), float(vp.detach())
    assert abs(vk - vp) <= 1e-5 * abs(vp)
    for a, c in zip(gk, gp):
        assert _relnorm(a, c) <= 1e-4
        if masked:
            assert float(a[-masked:].abs().max()) == 0.0


@pytest.mark.parametrize("B", [64, 1000])
def test_hsic_kernels_launch_one_device_kernel_each(cuda, B):
    """K5 is one cooperative launch, K6 one: over 20 calls the profiler sees
    one kernel name each, at most 20 times."""
    x, y, mask = _hsic_problem(cuda, B, 3, 0.2)
    _, res = cuda_pairwise.hsic_forward_kernel(x, y, mask, 1.0, 0.7)
    g = torch.ones((), device=cuda)
    ops.reset_launch_counts()
    for fn, name in (
            (lambda: cuda_pairwise.hsic_forward_kernel(x, y, mask, 1.0, 0.7),
             "hsic_fwd_kernel"),
            (lambda: cuda_pairwise.hsic_backward_kernel(x, y, mask, 1.0, 0.7,
                                                        res, g),
             "hsic_bwd_kernel")):
        names = _device_kernels(fn)
        assert 0 < len(names) <= 20, names
        assert all(name in n for n in names), names
    assert ops.launch_counts()["hsic_fwd"] == 22
    assert ops.launch_counts()["hsic_bwd"] == 22


@pytest.mark.parametrize("B", [64, 1000])
def test_hsic_kernels_replay_from_a_cuda_graph(cuda, B):
    """K5 and K6 captured together in one CUDA graph: the replay writes the
    bits of the eager calls."""
    x, y, mask = _hsic_problem(cuda, B, 3, 0.2)
    g = torch.full((), 0.5, device=cuda)

    def both():
        out, res = cuda_pairwise.hsic_forward_kernel(x, y, mask, 1.0, 0.7)
        return (out, res, *cuda_pairwise.hsic_backward_kernel(
            x, y, mask, 1.0, 0.7, res, g))

    _assert_replays_bit_equal(both)


def test_hsic_backward_refuses_what_the_kernel_does_not_take(cuda):
    x, y, mask = _hsic_problem(cuda, 8, 0, 0.2)
    _, res = cuda_pairwise.hsic_forward_kernel(x, y, mask, 1.0, 1.0)
    one = torch.ones((), device=cuda)
    wide = torch.zeros(8, 33, device=cuda)
    with pytest.raises(ValueError, match="exceeds"):
        cuda_pairwise.hsic_backward_kernel(wide, wide, mask, 1.0, 1.0, res,
                                           one)
    with pytest.raises(ValueError, match="outside"):
        cuda_pairwise.hsic_backward_kernel(x[:1], y[:1], mask[:1], 1.0, 1.0,
                                           res, one)
    for s in (0.0, -1.0):
        for s_x, s_y in ((s, 1.0), (1.0, s)):
            with pytest.raises(ValueError, match="sigmas"):
                cuda_pairwise.hsic_backward_kernel(x, y, mask, s_x, s_y, res,
                                                   one)


@pytest.mark.parametrize("V", [23808, 700])
def test_bow_kernels_match_plain(cuda, V):
    h, W, b, idx, wts, mask = _bow_problem(cuda, V=V)
    leaves_k = [t.clone().requires_grad_() for t in (h, W, b)]
    leaves_p = [t.clone().requires_grad_() for t in (h, W, b)]
    ops.reset_launch_counts()
    vk = cuda_bow.fused_bow_loss(*leaves_k, idx, wts, 0.1, mask)
    gk = torch.autograd.grad(vk, leaves_k)
    assert ops.launch_counts()["bow_fwd"] == 1
    assert ops.launch_counts()["bow_bwd"] == 1
    vp = cuda_bow.fused_bow_loss_plain(*leaves_p, idx, wts, 0.1, mask)
    gp = torch.autograd.grad(vp, leaves_p)
    torch.testing.assert_close(vk, vp, rtol=1e-5, atol=0)
    for a, c in zip(gk, gp):
        assert _relnorm(a, c) <= 1e-4


# the en BoW vocabulary of the roberta-base path (40,000: 157 chunks of
# 256 columns on 132 SMs, so a block owns several chunks) at the training
# batch, and a ragged V past it at 200 rows
@pytest.mark.parametrize("B,V", [(64, 40000), (200, 40009)])
def test_bow_kernels_at_the_en_vocabulary(cuda, B, V):
    """K3 and K4 where a block owns more than one chunk of V: the value
    within rtol 1e-5 and the gradients within 1e-4 normwise of the plain
    version, and two runs of each kernel bit-equal."""
    h, W, b, idx, wts, mask = _bow_problem(cuda, B=B, V=V)
    leaves_k = [t.clone().requires_grad_() for t in (h, W, b)]
    leaves_p = [t.clone().requires_grad_() for t in (h, W, b)]
    vk = cuda_bow.fused_bow_loss(*leaves_k, idx, wts, 0.1, mask)
    gk = torch.autograd.grad(vk, leaves_k)
    vp = cuda_bow.fused_bow_loss_plain(*leaves_p, idx, wts, 0.1, mask)
    gp = torch.autograd.grad(vp, leaves_p)
    torch.testing.assert_close(vk, vp, rtol=1e-5, atol=0)
    for a, c in zip(gk, gp):
        assert _relnorm(a, c) <= 1e-4
    stats = cuda_bow.bow_forward_kernel(h, W, b)
    assert torch.equal(stats, cuda_bow.bow_forward_kernel(h, W, b))
    rowp = _bow_rowp(h, W, b, mask)
    safe, corr = _bow_corrections(idx)
    first = cuda_bow.bow_backward_kernel(h, W, b, rowp, safe, corr)
    assert all(torch.equal(u, v) for u, v in zip(
        first, cuda_bow.bow_backward_kernel(h, W, b, rowp, safe, corr)))


# few words (each in many rows, up to 64 times; an index may repeat in a
# row) and the training vocabulary, at the training batch and at 100 rows
# (two groups of K4's rows)
@pytest.mark.parametrize("B,words", [(64, 40), (64, 23808), (100, 40)])
def test_bow_backward_repeats_its_bits_with_duplicate_indices(cuda, B,
                                                              words):
    """K3 + K4 with the corrections at the BoW indices added to G in a
    fixed order: two backward runs give the same bits, a CUDA graph of the
    forward and backward replays them, and the gradients stay within 1e-4
    normwise of the plain version."""
    h, W, b, _, _, mask = _bow_problem(cuda, B=B)
    T = 128
    rng = np.random.default_rng(words)
    idx = rng.integers(0, words, (B, T)).astype(np.int32)
    idx[:, T // 4:] = -1
    wts = np.where(idx >= 0, rng.random((B, T)), 0.0).astype(np.float32)
    wts /= wts.sum(axis=1, keepdims=True)
    idx, wts = torch.tensor(idx, device=cuda), torch.tensor(wts, device=cuda)
    leaves = [t.clone().requires_grad_() for t in (h, W, b)]

    def grads():
        return torch.autograd.grad(
            cuda_bow.fused_bow_loss(*leaves, idx, wts, 0.1, mask), leaves)

    ops.reset_launch_counts()
    first = grads()
    assert ops.launch_counts()["bow_bwd"] == 1
    assert all(torch.equal(u, v) for u, v in zip(first, grads()))
    _assert_replays_bit_equal(grads)
    leaves_p = [t.clone().requires_grad_() for t in (h, W, b)]
    gp = torch.autograd.grad(
        cuda_bow.fused_bow_loss_plain(*leaves_p, idx, wts, 0.1, mask),
        leaves_p)
    for a, c in zip(first, gp):
        assert _relnorm(a, c) <= 1e-4


# the zh tables (words, bert positions, token types) at the training batch
# of 64 x 96 ids with Zipf-like word ids (a few in long runs) or one word id
# in every entry, and at the stage-1 batch of 300 clauses of 60 tokens; the
# token types all 0 (one run across every chunk)
ZH_ROWS = (21128, 512, 2)


def _emb_relnorms(dWs, ids, g, rows):
    from carel_tpu_torch.ops import cuda_embedding

    want = cuda_embedding.embeddings_backward_plain(ids, g, rows)
    return [_relnorm(a, b) for a, b in zip(dWs, want)]


@pytest.mark.parametrize("n,case", [(64 * 96, "zipf"), (64 * 96, "one"),
                                    (300 * 60, "zipf")])
def test_embedding_backward_repeats_its_bits(cuda, n, case):
    """K10, one call over the three zh tables: two runs and two replays of
    a CUDA graph give the same bits (every row written again: the replays'
    outputs start as NaN), each table within 1e-5 normwise of index_add_
    (fp32 sums in another order); one launch of the wrapper."""
    from carel_tpu_torch.ops import cuda_embedding

    rng = np.random.default_rng(n)
    L = 96 if n == 64 * 96 else 60
    B, D = n // L, 768
    words = (np.minimum(rng.zipf(1.3, n) - 1, ZH_ROWS[0] - 1)
             if case == "zipf" else np.zeros(n, np.int64))
    ids = [torch.tensor(a, dtype=torch.long, device=cuda)
           for a in (words, np.tile(np.arange(L), B), np.zeros(n, np.int64))]
    g = torch.tensor(rng.normal(size=(n, D)), dtype=torch.float32,
                     device=cuda)
    ops.reset_launch_counts()
    first = cuda_embedding.embeddings_backward_kernel(ids, g, ZH_ROWS)
    assert ops.launch_counts()["emb_bwd"] == 1
    again = cuda_embedding.embeddings_backward_kernel(ids, g, ZH_ROWS)
    assert all(torch.equal(a, b) for a, b in zip(first, again))
    _assert_replays_bit_equal(
        lambda: tuple(cuda_embedding.embeddings_backward_kernel(
            ids, g, ZH_ROWS)), fill=float("nan"))
    assert max(_emb_relnorms(first, ids, g, ZH_ROWS)) <= 1e-5


# roberta-base's tables at the en path's batch of 64 x 128 ids: the 50,265
# words, the 514 positions (RoBERTa's, offset by the pad id) and the one-row
# token-type table (every entry one run across every chunk), in one call;
# the cases differ in their seed
@pytest.mark.parametrize("rows", [1, 514, 50265])
def test_embedding_backward_over_roberta_tables(cuda, rows):
    """K10 over roberta-base's three tables in one call: two runs and two
    graph replays bit-equal, each table within 1e-5 normwise of
    index_add_."""
    from carel_tpu_torch.ops import cuda_embedding

    rng = np.random.default_rng(rows)
    B, L, D = 64, 128, 768
    tables = (50265, 514, 1)
    mask = np.arange(L)[None, :] < rng.integers(16, L + 1, B)[:, None]
    ids = [torch.tensor(a.reshape(-1), dtype=torch.long, device=cuda)
           for a in (np.minimum(rng.zipf(1.3, (B, L)) - 1, tables[0] - 1),
                     np.cumsum(mask, axis=1) * mask + 1,
                     np.zeros((B, L), np.int64))]
    g = torch.tensor(rng.normal(size=(B * L, D)), dtype=torch.float32,
                     device=cuda)
    first = cuda_embedding.embeddings_backward_kernel(ids, g, tables)
    again = cuda_embedding.embeddings_backward_kernel(ids, g, tables)
    assert all(torch.equal(a, b) for a, b in zip(first, again))
    _assert_replays_bit_equal(
        lambda: tuple(cuda_embedding.embeddings_backward_kernel(
            ids, g, tables)), fill=float("nan"))
    assert max(_emb_relnorms(first, ids, g, tables)) <= 1e-5


def _bow_corrections(idx):
    """(safe indices [B, T] int64, corrections [B, T]) as the BoW backward
    hands them to K4: 0 at an empty slot, normal values of std 1e-4 from a
    seed where the slot holds an index."""
    valid = idx >= 0
    gen = torch.Generator(device=idx.device).manual_seed(3)
    corr = torch.randn(idx.shape, device=idx.device, generator=gen) * 1e-4
    return (torch.where(valid, idx, 0).long().contiguous(),
            torch.where(valid, corr, 0.0).contiguous())


def _bow_rowp(h, W, b, mask):
    """K3's row sums of (h, W, b) and a rowp [5, B] for K4 with A = 0, as
    the training step's weights would give it."""
    B, V = h.shape[0], W.shape[0]
    stats = cuda_bow.bow_forward_kernel(h, W, b)
    return torch.stack([stats[0], torch.zeros_like(stats[0]),
                        mask * 0.9 / (B * V), mask * 0.1 / (V * B * V),
                        mask / (B * V)]).contiguous()


# the shapes of the forward's ragged cases, with the gradients: a few and
# many rows at a V of no round size, more rows than one pass takes, more
# chunks of V than SMs with a D that is no multiple of 4
@pytest.mark.parametrize("B,D,V", [(5, 48, 1003), (200, 48, 1003),
                                   (300, 48, 23808), (5, 33, 40000)])
def test_bow_backward_kernel_at_ragged_shapes(cuda, B, D, V):
    h, W, b, idx, wts, _ = _bow_problem(cuda, B=B, D=D, V=V, T=32, masked=0)
    mask = torch.ones(B, device=cuda)
    mask[-1] = 0.0
    leaves_k = [t.clone().requires_grad_() for t in (h, W, b)]
    leaves_p = [t.clone().requires_grad_() for t in (h, W, b)]
    ops.reset_launch_counts()
    gk = torch.autograd.grad(
        cuda_bow.fused_bow_loss(*leaves_k, idx, wts, 0.1, mask), leaves_k)
    assert ops.launch_counts()["bow_bwd"] == 1
    gp = torch.autograd.grad(
        cuda_bow.fused_bow_loss_plain(*leaves_p, idx, wts, 0.1, mask),
        leaves_p)
    for a, c in zip(gk, gp):
        assert _relnorm(a, c) <= 1e-4
    rowp = _bow_rowp(h, W, b, mask)
    corr = _bow_corrections(idx)
    assert all(torch.equal(u, v) for u, v in zip(
        cuda_bow.bow_backward_kernel(h, W, b, rowp, *corr),
        cuda_bow.bow_backward_kernel(h, W, b, rowp, *corr)))


def _bow_backward_planned(h, W, b, rowp, idx, corr, cols, grid):
    """K4 under a plan given: (error, dW, db, dh)."""
    from carel_tpu_torch.ops import native

    B, D = h.shape
    V = W.shape[0]
    lib = native.lib()
    scratch = torch.empty(lib.carel_bow_bwd_scratch(B, D, V, grid),
                          device=h.device)
    dW = torch.full_like(W, 7.0)
    db = torch.full_like(b, 7.0)
    dh = torch.full_like(h, 7.0)
    err = lib.carel_bow_bwd_planned(
        h.data_ptr(), W.data_ptr(), b.data_ptr(), B, D, V, cols, grid,
        rowp.data_ptr(), idx.data_ptr(), corr.data_ptr(), idx.shape[1],
        dW.data_ptr(), db.data_ptr(),
        dh.data_ptr(), scratch.data_ptr(), native.stream(h.device))
    return err, dW, db, dh


@pytest.mark.parametrize("cols,grid", [(64, 132), (256, 60), (181, 66)])
def test_bow_backward_plans_agree(cuda, cols, grid):
    """Another cut of V, or fewer blocks that own several chunks each: dW
    and db hold the same bits (each column's sums run over the rows in the
    same order), dh the same sums merged in another order."""
    from carel_tpu_torch.ops import native

    h, W, b, idx, _, mask = _bow_problem(cuda)
    rowp = _bow_rowp(h, W, b, mask)
    corr = _bow_corrections(idx)
    want = cuda_bow.bow_backward_kernel(h, W, b, rowp, *corr)
    err, *got = _bow_backward_planned(h, W, b, rowp, *corr, cols, grid)
    native.check(err, "bow backward kernel")
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert _relnorm(got[2], want[2]) <= 1e-6


def test_bow_backward_refuses_a_grid_that_cannot_be_resident(cuda):
    """Chunks of 8 columns in 2,976 blocks cannot all be resident: the
    entry point returns the error and launches nothing."""
    from carel_tpu_torch.ops import native

    h, W, b, idx, _, mask = _bow_problem(cuda)
    rowp = _bow_rowp(h, W, b, mask)
    err, dW, db, dh = _bow_backward_planned(h, W, b, rowp,
                                            *_bow_corrections(idx), 8,
                                            -(-W.shape[0] // 8))
    with pytest.raises(RuntimeError, match="too many blocks|cooperative"):
        native.check(err, "bow backward kernel")
    torch.cuda.synchronize()
    assert all(bool((t == 7.0).all()) for t in (dW, db, dh))


def _dense_row_sums(h, W, b):
    """lse, S_z, S_log1mp, Qp of z = h W^T + b in float64, and sum |z|."""
    z = h.double() @ W.double().T + b.double()
    lse = torch.logsumexp(z, 1)
    p = torch.clamp(torch.exp(z - lse[:, None]), max=cuda_bow.P_MAX)
    return torch.stack([lse, z.sum(1), torch.log1p(-p).sum(1),
                        (p / (1 - p)).sum(1)]), z.abs().sum(1)


# V not a multiple of anything with a few and with many rows; more rows than
# the kernel keeps logits for on the chip; more chunks of V than SMs, with a
# D that is no multiple of 4 (no 16-byte loads); one row
@pytest.mark.parametrize("B,D,V", [(5, 48, 1003), (200, 48, 1003),
                                   (300, 48, 23808), (5, 33, 40000),
                                   (1, 7, 50)])
def test_bow_forward_kernel_at_ragged_shapes(cuda, B, D, V):
    h, W, b, idx, wts, _ = _bow_problem(cuda, B=B, D=D, V=V, T=32, masked=0)
    ops.reset_launch_counts()
    got = cuda_bow.bow_forward_kernel(h, W, b)
    assert ops.launch_counts()["bow_fwd"] == 1
    assert torch.equal(got, cuda_bow.bow_forward_kernel(h, W, b))
    want, abs_z = _dense_row_sums(h, W, b)
    scale = torch.stack([want[0].abs(), abs_z, want[2].abs(), want[3].abs()])
    assert float(((got.double() - want).abs() / scale).max()) <= 1e-5
    mask = torch.ones(B, device=cuda)
    torch.testing.assert_close(
        cuda_bow.fused_bow_loss(h, W, b, idx, wts, 0.1, mask),
        cuda_bow.fused_bow_loss_plain(h, W, b, idx, wts, 0.1, mask),
        rtol=1e-5, atol=0)


@pytest.mark.parametrize("cols,keep", [(181, 1), (181, 0), (64, 0), (256, 0)])
def test_bow_forward_plans_agree(cuda, cols, keep):
    """The same row sums whether the logits stay on the chip between the
    sweeps or are evaluated again, and for other cuts of V."""
    from carel_tpu_torch.ops import native

    h, W, b, *_ = _bow_problem(cuda)
    B, D = h.shape
    V = W.shape[0]
    lib = native.lib()
    chunks = -(-V // cols)
    scratch = torch.empty(lib.carel_bow_fwd_scratch(B, D, V, cols),
                          device=cuda)
    out = torch.empty(4, B, device=cuda)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    native.check(lib.carel_bow_fwd_planned(
        h.data_ptr(), W.data_ptr(), b.data_ptr(), B, D, V, cols,
        min(chunks, sms), keep, scratch.data_ptr(), out.data_ptr(),
        native.stream(cuda)), "bow forward kernel")
    want, abs_z = _dense_row_sums(h, W, b)
    scale = torch.stack([want[0].abs(), abs_z, want[2].abs(), want[3].abs()])
    assert float(((out.double() - want).abs() / scale).max()) <= 1e-5


def test_bow_forward_refuses_a_grid_that_cannot_be_resident(cuda):
    """A cooperative launch needs every block on the card at once: chunks of
    8 columns would be 2,976 blocks. The entry point returns the error and
    launches nothing; there is no other path to fall to."""
    from carel_tpu_torch.ops import native

    h, W, b, *_ = _bow_problem(cuda)
    B, D = h.shape
    V = W.shape[0]
    lib = native.lib()
    scratch = torch.empty(lib.carel_bow_fwd_scratch(B, D, V, 8), device=cuda)
    out = torch.full((4, B), 7.0, device=cuda)
    err = lib.carel_bow_fwd_planned(
        h.data_ptr(), W.data_ptr(), b.data_ptr(), B, D, V, 8, -(-V // 8), 0,
        scratch.data_ptr(), out.data_ptr(), native.stream(cuda))
    with pytest.raises(RuntimeError, match="too many blocks|cooperative"):
        native.check(err, "bow forward kernel")
    torch.cuda.synchronize()
    assert bool((out == 7.0).all())


def test_bow_forward_launch_can_be_captured_in_a_cuda_graph(cuda):
    """The cooperative launch goes on the current stream and is recorded by
    a stream capture; the replay writes the same bits."""
    h, W, b, *_ = _bow_problem(cuda)
    want = cuda_bow.bow_forward_kernel(h, W, b).clone()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = cuda_bow.bow_forward_kernel(h, W, b)
    got.zero_()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def test_bow_backward_launch_can_be_captured_in_a_cuda_graph(cuda):
    """K4's cooperative launch is recorded by a stream capture too, and the
    replay writes the same bits."""
    h, W, b, idx, _, mask = _bow_problem(cuda)
    rowp = _bow_rowp(h, W, b, mask)
    corr = _bow_corrections(idx)
    want = [t.clone() for t in cuda_bow.bow_backward_kernel(h, W, b, rowp,
                                                             *corr)]
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = cuda_bow.bow_backward_kernel(h, W, b, rowp, *corr)
    for t in got:
        t.zero_()
    graph.replay()
    torch.cuda.synchronize()
    assert all(torch.equal(u, v) for u, v in zip(got, want))


def test_kernels_repeat_bit_for_bit(cuda):
    for B, masked in ((64, 0), (1000, 7)):
        x, y, mask = _mmd_problem(cuda, B, masked)
        a, res_a = cuda_pairwise.mmd_forward_kernel(x, y, mask, (0.1,))
        b, res_b = cuda_pairwise.mmd_forward_kernel(x, y, mask, (0.1,))
        assert torch.equal(a, b) and torch.equal(res_a, res_b)
        g = torch.ones((), device=cuda)
        da = cuda_pairwise.mmd_backward_kernel(x, y, mask, res_a, g, (0.1,))
        db = cuda_pairwise.mmd_backward_kernel(x, y, mask, res_b, g, (0.1,))
        assert all(torch.equal(u, v) for u, v in zip(da, db))
    h, W, bias, bidx, _, bmask = _bow_problem(cuda)
    assert torch.equal(cuda_bow.bow_forward_kernel(h, W, bias),
                       cuda_bow.bow_forward_kernel(h, W, bias))
    rowp = _bow_rowp(h, W, bias, bmask)
    corr = _bow_corrections(bidx)
    assert all(torch.equal(u, v) for u, v in zip(
        cuda_bow.bow_backward_kernel(h, W, bias, rowp, *corr),
        cuda_bow.bow_backward_kernel(h, W, bias, rowp, *corr)))
    for B, masked in ((61, 3), (1000, 7)):
        x, y, mask = _hsic_problem(cuda, B, masked, 0.2)
        a, res_a = cuda_pairwise.hsic_forward_kernel(x, y, mask, 1.0, 1.0)
        b, res_b = cuda_pairwise.hsic_forward_kernel(x, y, mask, 1.0, 1.0)
        assert torch.equal(a, b) and torch.equal(res_a, res_b)
        g = torch.ones((), device=cuda)
        da = cuda_pairwise.hsic_backward_kernel(x, y, mask, 1.0, 1.0, res_a,
                                                g)
        db = cuda_pairwise.hsic_backward_kernel(x, y, mask, 1.0, 1.0, res_b,
                                                g)
        assert all(torch.equal(u, v) for u, v in zip(da, db))


def _flash_problem(device, B, h, L, hd, dtype, seed=0, min_tail=0,
                   min_len=1):
    rng = np.random.default_rng(seed)
    q, k, v, g = (torch.tensor(rng.normal(size=(B, h, L, hd))
                               .astype(np.float32), device=device).to(dtype)
                  for _ in range(4))
    # pad tails >= min_tail, rows of min_len real tokens or more
    lengths = rng.integers(min_len, L - min_tail + 1, B)
    lengths[0], lengths[1] = L, 0  # a row without pads, an all-pad row
    mask = (np.arange(L)[None, :] < lengths[:, None]).astype(np.int32)
    return q, k, v, g, torch.tensor(mask, device=device)


@pytest.mark.parametrize("dtype,tol_out,tol_grad", [
    (torch.float32, 1e-5, 1e-4), (torch.bfloat16, 6e-3, 8e-3)])
@pytest.mark.parametrize("B,h,L,hd,min_tail,min_len", [
    (8, 12, 96, 64, 0, 1), (5, 4, 37, 16, 0, 1), (3, 2, 130, 32, 0, 1),
    (2, 2, 70, 128, 0, 1),
    # L over one block's rows, so that the tensor-core kernels' ring wraps;
    # hd = 128; pad tails longer than one tile of 32 keys
    (3, 2, 200, 64, 0, 1), (2, 2, 513, 32, 0, 1), (2, 2, 96, 128, 0, 1),
    (4, 2, 160, 64, 48, 1),
    # the embed path's batch: 200 is no multiple of 64, so the last tile
    # of keys is partly empty; EncoderEmbedder's batch at L = 200, MLM
    # pretraining's (and EncoderEmbedder's at L = 64), one document's dozen
    # clauses with long pad tails (the cit path) and the MLM scorer's 32
    # rows of 20-40 real tokens
    (32, 12, 200, 64, 0, 1), (256, 12, 200, 64, 0, 1),
    (256, 12, 64, 64, 0, 1), (12, 12, 64, 64, 24, 1),
    (32, 12, 64, 64, 24, 20)])
def test_flash_kernels_match_plain(cuda, B, h, L, hd, min_tail, min_len,
                                   dtype, tol_out, tol_grad):
    q, k, v, g, mask = _flash_problem(cuda, B, h, L, hd, dtype,
                                      min_tail=min_tail, min_len=min_len)
    scale = 1.0 / float(np.sqrt(hd))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    ops.reset_launch_counts()
    out = cuda_attention.flash_attention(*leaves, mask, scale)
    grads = torch.autograd.grad(out, leaves, g)
    counts = ops.launch_counts()
    assert (counts["flash_fwd"], counts["flash_bwd_dkv"],
            counts["flash_bwd_dq"]) == (1, 1, 1)
    assert out.dtype == dtype and all(t.dtype == dtype for t in grads)
    assert all(bool(torch.isfinite(t).all()) for t in (out, *grads))
    ref_leaves = [t.float().requires_grad_() for t in (q, k, v)]
    ref = cuda_attention.flash_attention_plain(*ref_leaves, mask, scale)
    ref_grads = torch.autograd.grad(ref, ref_leaves, g.float())
    assert _relnorm(out.detach().float(), ref.detach()) <= tol_out
    for a, c in zip(grads, ref_grads):
        assert _relnorm(a.float(), c) <= tol_grad

    # the packed layout reads the same values through other strides, and
    # its gradient is one packed buffer
    qkv = torch.stack([t.transpose(1, 2) for t in (q, k, v)],
                      dim=2).contiguous().requires_grad_()
    ctx = cuda_attention.flash_attention_packed(qkv, mask, scale)
    assert ctx.shape == (B, L, h * hd)
    assert torch.equal(ctx.view(B, L, h, hd).transpose(1, 2), out)
    (dqkv,) = torch.autograd.grad(
        ctx, qkv, g.transpose(1, 2).reshape(B, L, h * hd))
    assert dqkv.shape == qkv.shape and dqkv.is_contiguous()
    for a, c in zip(dqkv.unbind(2), grads):
        assert torch.equal(a.transpose(1, 2), c)


@pytest.mark.parametrize("B,h,L,hd,min_tail", [
    (64, 12, 96, 64, 0), (5, 4, 37, 16, 0), (3, 2, 45, 16, 0),
    (3, 2, 200, 64, 0), (2, 2, 513, 32, 0), (2, 2, 96, 128, 0),
    (4, 2, 160, 64, 48)])
def test_flash_dq_kernel_on_tensor_cores_matches_plain(cuda, B, h, L, hd,
                                                       min_tail):
    """K9 alone for bf16: dq against the plain version's (8e-3 normwise),
    delta against the fp32 sum of the rounded output times the cotangent,
    all-pad rows finite, two runs bit-equal."""
    q, k, v, g, mask = _flash_problem(cuda, B, h, L, hd, torch.bfloat16,
                                      min_tail=min_tail)
    scale = 1.0 / float(np.sqrt(hd))
    seg = cuda_attention.segment_ids(mask)
    out = torch.empty_like(q)
    lse = cuda_attention.flash_forward_kernel(q, k, v, seg, scale, out)
    runs = []
    for _ in range(2):
        dq = torch.empty_like(q)
        delta = cuda_attention.flash_backward_dq_kernel(
            q, k, v, seg, out, g, lse, scale, dq)
        runs.append((dq, delta))
    assert all(torch.equal(a, c) for a, c in zip(*runs))
    dq, delta = runs[0]
    assert bool(torch.isfinite(dq).all()) and bool(torch.isfinite(delta).all())
    torch.testing.assert_close(delta, (out.float() * g.float()).sum(-1),
                               rtol=1e-5, atol=1e-5)
    leaves = [t.float().requires_grad_() for t in (q, k, v)]
    ref = cuda_attention.flash_attention_plain(*leaves, mask, scale)
    (ref_dq,) = torch.autograd.grad(ref, leaves[:1], g.float())
    assert _relnorm(dq.float(), ref_dq) <= 8e-3


def test_flash_kernels_repeat_bit_for_bit(cuda):
    q, k, v, g, mask = _flash_problem(cuda, 8, 12, 96, 64, torch.bfloat16)
    runs = []
    for _ in range(2):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        out = cuda_attention.flash_attention(*leaves, mask, 0.125)
        runs.append((out.detach(), *torch.autograd.grad(out, leaves, g)))
    assert all(torch.equal(a, c) for a, c in zip(*runs))


def test_flash_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    q, k, v, _, mask = _flash_problem(cuda, 2, 2, 16, 16, torch.float32)
    seg = cuda_attention.segment_ids(mask)
    out = torch.empty_like(q)
    with pytest.raises(TypeError):
        cuda_attention.flash_forward_kernel(q.half(), k.half(), v.half(), seg,
                                            0.25, out.half())
    with pytest.raises(TypeError):
        cuda_attention.flash_forward_kernel(q, k.bfloat16(), v, seg, 0.25,
                                            out)
    with pytest.raises(ValueError, match="head dim"):
        wide = torch.zeros(2, 2, 16, 48, device=cuda)
        cuda_attention.flash_forward_kernel(wide, wide, wide, seg, 0.25,
                                            torch.empty_like(wide))
    with pytest.raises(ValueError, match="last dimension"):
        qt = q.transpose(2, 3).contiguous().transpose(2, 3)
        cuda_attention.flash_forward_kernel(qt, k, v, seg, 0.25, out)
    with pytest.raises(ValueError, match="strides"):
        kt = k.transpose(1, 2).contiguous().transpose(1, 2)
        cuda_attention.flash_forward_kernel(q, kt, v, seg, 0.25, out)
    with pytest.raises(ValueError, match="shape"):
        cuda_attention.flash_forward_kernel(q, k, v, seg[:, :8], 0.25, out)
    with pytest.raises(TypeError):
        cuda_attention.flash_forward_kernel(q, k, v, mask.float(), 0.25, out)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_attention.flash_forward_kernel(q.cpu(), k.cpu(), v.cpu(),
                                            seg.cpu(), 0.25, out.cpu())
    # the public wrapper copies what is not addressable instead
    kt = k.transpose(1, 2).contiguous().transpose(1, 2)
    assert torch.equal(cuda_attention.flash_attention(q, kt, v, mask, 0.25),
                       cuda_attention.flash_attention(q, k, v, mask, 0.25))
    # bf16 rows must start on 8 elements (16 bytes: cp.async, ldmatrix): a
    # view that starts on a 4- but not an 8-element boundary is refused by
    # the kernel wrapper and copied by the public one
    wide = torch.randn(2, 2, 16, 24, device=cuda).bfloat16()
    q8, k8, v8 = (wide[..., 8:].contiguous() for _ in range(3))
    q4 = wide[..., 4:20]
    assert q4.data_ptr() % 16 == 8 and q4.stride(2) % 8 == 0
    out16 = torch.empty_like(q8)
    with pytest.raises(ValueError, match="8-element boundary"):
        cuda_attention.flash_forward_kernel(q4, q4, q4, seg, 0.25, out16)
    with pytest.raises(ValueError, match="8-element boundary"):
        cuda_attention.flash_forward_kernel(q8, k8, v8, seg, 0.25,
                                            wide[..., 4:20])
    assert torch.equal(
        cuda_attention.flash_attention(q4, q4, q4, mask, 0.25),
        cuda_attention.flash_attention(*(q4.contiguous() for _ in range(3)),
                                       mask, 0.25))


def test_flash_encoder_on_the_card_matches_the_cpu(cuda):
    """The tiny fp32 encoder with attention_impl="flash": kernels on the
    card against the plain version on the CPU, same weights and inputs."""
    from carel_tpu_torch.models.encoder import (TransformerEncoder,
                                                init_flax_,
                                                tiny_encoder_config)

    enc = TransformerEncoder(tiny_encoder_config(
        vocab_size=128, dropout=0.0, attention_impl="flash"))
    init_flax_(enc, torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    ids = torch.tensor(rng.integers(2, 128, (4, 24)))
    mask = torch.ones(4, 24, dtype=torch.int32)
    mask[1, 10:] = 0
    mask[2, :] = 0
    with torch.no_grad():
        want = enc(ids, mask)
        ops.reset_launch_counts()
        got = enc.to(cuda)(ids.to(cuda), mask.to(cuda))
    assert ops.launch_counts()["flash_fwd"] == 2  # one per layer
    for a, c in zip(got, want):
        torch.testing.assert_close(a.cpu(), c, rtol=0, atol=1e-5)


def test_attention_scores_match_the_upcast_product(cuda):
    """Not a hand-written kernel: the encoder's bf16 scores on CUDA (the
    tensor-core GEMM with an fp32 output) against the fp32 product of the
    upcast q and k, which the CPU runs; both sum the exact bf16 products in
    fp32. Forward and backward, normwise 1e-5."""
    from carel_tpu_torch.ops.xla_attention import attention_scores, scores_upcast

    gen = torch.Generator(device=cuda).manual_seed(0)
    q, k = (torch.randn(2, 3, 40, 16, device=cuda, generator=gen)
            .to(torch.bfloat16) for _ in range(2))
    g = torch.randn(2, 3, 40, 40, device=cuda, generator=gen)
    got = []
    for fn in (attention_scores, scores_upcast):
        leaves = (q.clone().requires_grad_(), k.clone().requires_grad_())
        s = fn(*leaves)
        got.append((s.detach(), *torch.autograd.grad(s, leaves, g)))
    assert got[0][0].dtype == torch.float32
    assert got[0][1].dtype == torch.bfloat16
    for a, c in zip(*got):
        assert _relnorm(a, c) <= 1e-5


def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    x, y, mask = _mmd_problem(cuda, 8, 0)
    with pytest.raises(TypeError):
        cuda_pairwise.mmd_forward_kernel(x.double(), y, mask, (0.1,))
    with pytest.raises(ValueError, match="contiguous"):
        cuda_pairwise.mmd_forward_kernel(x.T.contiguous().T, y, mask, (0.1,))
    with pytest.raises(ValueError, match="shape"):
        cuda_pairwise.mmd_forward_kernel(x, y[:4], mask, (0.1,))
    with pytest.raises(ValueError, match="exceeds"):
        wide = torch.zeros(8, 40, device=cuda)
        cuda_pairwise.mmd_forward_kernel(wide, wide, mask, (0.1,))
    with pytest.raises(ValueError, match="alphas"):
        cuda_pairwise.mmd_forward_kernel(x, y, mask, (0.1,) * 5)
    _, res = cuda_pairwise.mmd_forward_kernel(x, y, mask, (0.1,))
    one = torch.ones((), device=cuda)
    with pytest.raises(ValueError, match="shape"):
        cuda_pairwise.mmd_backward_kernel(x, y, mask, res[1:], one, (0.1,))
    with pytest.raises(TypeError):
        cuda_pairwise.mmd_backward_kernel(x, y, mask, res.double(), one,
                                          (0.1,))
    with pytest.raises(ValueError, match="exceeds"):
        cuda_pairwise.mmd_backward_kernel(wide, wide, mask, res, one, (0.1,))
    h, W, b, *_ = _bow_problem(cuda, V=100)
    with pytest.raises(ValueError, match="shape"):
        cuda_bow.bow_forward_kernel(h, W, b[:50])
    with pytest.raises(TypeError):
        cuda_pairwise.hsic_forward_kernel(x.double(), y, mask, 1.0, 1.0)
    with pytest.raises(ValueError, match="contiguous"):
        cuda_pairwise.hsic_forward_kernel(x.T.contiguous().T, y, mask, 1.0,
                                          1.0)
    with pytest.raises(ValueError, match="shape"):
        cuda_pairwise.hsic_forward_kernel(x, y, mask[:4], 1.0, 1.0)
    with pytest.raises(ValueError, match="sigmas"):
        cuda_pairwise.hsic_forward_kernel(x, y, mask, 0.0, 1.0)
    with pytest.raises(ValueError, match="exceeds"):
        wide = torch.zeros(8, 40, device=cuda)
        cuda_pairwise.hsic_forward_kernel(wide, wide, mask, 1.0, 1.0)
    _, res = cuda_pairwise.hsic_forward_kernel(x, y, mask, 1.0, 1.0)
    with pytest.raises(ValueError, match="residual"):
        cuda_pairwise.hsic_backward_kernel(x, y, mask, 1.0, 1.0, res.float(),
                                           torch.ones((), device=cuda))


def test_flash_kernels_replay_from_a_cuda_graph(cuda):
    """K7, K8 and K9 (bf16, at the training step's head shape), through the
    autograd function as the encoder calls them, captured in one CUDA graph:
    each replay writes the bits of the eager call."""
    q, k, v, g, mask = _flash_problem(cuda, 8, 12, 96, 64, torch.bfloat16)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]

    def step():
        out = cuda_attention.flash_attention(*leaves, mask, 0.125)
        return (out.detach(), *torch.autograd.grad(out, leaves, g))

    ops.reset_launch_counts()
    _assert_replays_bit_equal(step)
    counts = ops.launch_counts()  # the eager call and the capture
    assert (counts["flash_fwd"], counts["flash_bwd_dkv"],
            counts["flash_bwd_dq"]) == (2, 2, 2)


def _tiny_cfg(reg, attention_impl="xla", kl_ann_iterations=4):
    from carel_tpu_torch.config import (CarelConfig, DataConfig, LossConfig,
                                        ModelConfig, Regularizer,
                                        TrainConfig)
    from carel_tpu_torch.models.encoder import tiny_encoder_config

    return CarelConfig(
        model=ModelConfig(encoder=tiny_encoder_config(
            vocab_size=128, dropout=0.1, attention_impl=attention_impl),
            ec_dim=8, bow_dim=300, dropout=0.1,
            binary_emotion=reg in ("hsic", "gan")),
        loss=LossConfig(regularizer=Regularizer(reg),
                        kl_ann_iterations=kl_ann_iterations,
                        vi_beta_step=0.5),
        data=DataConfig(max_len=16),
        train=TrainConfig(batch_size=8, vae_lr=1e-3, adv_lr=2e-3,
                          aprx_lr=5e-2, seed=11))


def _tiny_arrays(n=45, L=16, vocab=128, bow=300, seed=0):
    from carel_tpu_torch.data.batching import PairArrays

    rng = np.random.default_rng(seed)
    mask = np.ones((n, L), np.int32)
    mask[::3, L // 2:] = 0
    idx = rng.integers(0, bow, (n, 6)).astype(np.int32)
    idx[:, -2:] = -1
    return PairArrays(
        input_ids=(rng.integers(2, vocab, (n, L)) * mask).astype(np.int32),
        attention_mask=mask, token_type_ids=np.zeros((n, L), np.int32),
        pair_labels=(rng.random(n) < 0.4).astype(np.float32),
        emotion_labels=rng.integers(0, 6, n).astype(np.int32),
        temporal_order=np.zeros(n, bool), bow_indices=idx,
        bow_weights=np.where(idx >= 0, 0.25, 0.0).astype(np.float32))


def _eager_epoch(cfg, state, stacked, vi_beta):
    from carel_tpu_torch.train.steps import make_train_step

    step = make_train_step(cfg)
    nb = stacked["input_ids"].shape[0]
    return torch.stack([step(state, {k: torch.from_numpy(v[i]).to(cuda_dev(
        state)) for k, v in stacked.items()}, i, vi_beta)["loss"]
        for i in range(nb)])


def cuda_dev(state):
    return next(state.model.parameters()).device


def _assert_states_agree(a, b, cfg, steps):
    """Params within 2 lr a step everywhere (Adam moves an entry whose
    gradient is rounding noise by ~lr a step, each run its own way) and
    the 99th percentile of each tensor within 0.05 lr."""
    from carel_tpu_torch.train.state import CLUB, DISC

    lrs = {DISC: cfg.train.adv_lr, CLUB: cfg.train.aprx_lr}
    pa = dict(a.model.named_parameters())
    for name, p in b.model.named_parameters():
        lr = lrs.get(b.labels[name], cfg.train.vae_lr)
        err = ((pa[name] - p).detach().abs().flatten() / lr).double()
        assert float(err.max()) <= 2.0 * steps, name
        if name.endswith("attention.qkv.bias"):  # zero gradient: key bias
            hidden = err.numel() // 3
            err = torch.cat([err[:hidden], err[2 * hidden:]])
        assert float(torch.quantile(err, 0.99)) <= 0.05, name


@pytest.mark.parametrize("reg,impl", [("mmd", "xla"), ("hsic", "xla"),
                                      ("gan", "xla"), ("vi", "xla"),
                                      ("mmd", "flash")])
def test_captured_epoch_equals_the_eager_one(cuda, reg, impl):
    """Two epochs of six batches (the KL weight ramps over iterations 0-3,
    vi_beta 0 then 0.5, the main lr halved between the epochs) through the
    captured epoch step and through the eager per-step loop, from equal
    seeds and dropout generator states on the card: losses rel 1e-5,
    params as _assert_states_agree, the sampling generators and the dropout
    generator advanced alike.
    One capture serves both epochs, and the launch counts hold the
    captured step's launches once a replay."""
    from carel_tpu_torch.pipeline import init_state
    from carel_tpu_torch.train.scan_epoch import make_epoch_step, stack_epoch
    from carel_tpu_torch.train.state import dropout_generator, set_lr

    cfg = _tiny_cfg(reg, impl)
    arrays = _tiny_arrays()
    epochs = [stack_epoch(arrays, 8, np.random.default_rng(e))
              for e in range(2)]
    captured, eager = init_state(cfg, cuda), init_state(cfg, cuda)
    step = make_epoch_step(cfg)
    ops.reset_launch_counts()
    got, want = [], []
    # both runs draw dropout from the one default generator: each epoch
    # starts both from its state, and both must leave it in the same one
    dropout = dropout_generator(cuda)
    for e, stacked in enumerate(epochs):
        start = dropout.get_state()
        got.append(step(captured, stacked, 0.5 * e))
        end = dropout.get_state()
        dropout.set_state(start)
        want.append(_eager_epoch(cfg, eager, stacked, 0.5 * e))
        assert torch.equal(dropout.get_state(), end)
        set_lr(captured.optimizer, 5e-4)
        set_lr(eager.optimizer, 5e-4)
    torch.testing.assert_close(torch.cat(got), torch.cat(want), rtol=1e-5,
                               atol=0)
    assert step.captures == 1 and step.replays == 12
    assert captured.step == eager.step == 12
    assert torch.equal(captured.generator.get_state(),
                       eager.generator.get_state())
    _assert_states_agree(captured, eager, cfg, 12)
    assert step.captured_launches["bow_fwd"] == 1
    counts = ops.launch_counts()  # eager steps count through the wrappers
    for name, n in step.captured_launches.items():
        assert counts[name] == 2 * 12 * n, name


@pytest.mark.parametrize("reg", ["mmd", "vi"])
def test_captured_epoch_on_a_mesh_of_one_gives_the_bits_of_no_mesh(cuda,
                                                                   reg):
    """A world of one rank (NCCL over 127.0.0.1): the tiny model's epoch
    captured through a (1, 1) mesh, whose graph holds the gather of the
    latents and of the loss inputs and the gradient sum, gives the losses
    and params of the same epoch captured without a mesh, bit for bit, one
    capture each."""
    import torch.distributed as dist

    from carel_tpu_torch.parallel.mesh import (free_port, init_distributed,
                                               make_mesh)
    from carel_tpu_torch.parallel.sharding import shard_stacked
    from carel_tpu_torch.pipeline import init_state
    from carel_tpu_torch.train.scan_epoch import make_epoch_step, stack_epoch

    cfg = _tiny_cfg(reg)
    stacked = stack_epoch(_tiny_arrays(), 8, np.random.default_rng(0))
    init_distributed(0, 1, free_port(), cuda)
    try:
        mesh = make_mesh(1, shape=(1, 1))
        runs = []
        for m in (None, mesh):
            state = init_state(cfg, cuda, mesh=m)  # seeds dropout alike
            step = make_epoch_step(cfg)
            losses = step(state, stacked if m is None
                          else shard_stacked(m, stacked), 0.5)
            assert step.captures == 1 and step.replays == 6
            runs.append((losses, state.model.state_dict()))
    finally:
        dist.destroy_process_group()
    (la, pa), (lb, pb) = runs
    assert torch.equal(la, lb)
    for k in pa:
        assert torch.equal(pa[k], pb[k]), k


def test_stale_capture_is_captured_again(cuda, tmp_path):
    """The best reload (load_state_dict, in place) keeps the capture; a
    load_state replaces the optimizers' state tensors, and the next epoch
    captures again and then equals an eager epoch from the same snapshot."""
    from carel_tpu_torch.pipeline import init_state
    from carel_tpu_torch.train import checkpoint as ckpt
    from carel_tpu_torch.train.scan_epoch import make_epoch_step, stack_epoch

    cfg = _tiny_cfg("mmd")
    arrays = _tiny_arrays()
    epoch = [stack_epoch(arrays, 8, np.random.default_rng(e))
             for e in range(3)]
    state, step = init_state(cfg, cuda), make_epoch_step(cfg)
    step(state, epoch[0], 0.0)
    ckpt.save_state(str(tmp_path), "m", state)
    best = {k: v.clone() for k, v in state.model.state_dict().items()}
    step(state, epoch[1], 0.0)
    state.model.load_state_dict(best)
    step(state, epoch[1], 0.0)
    assert step.captures == 1
    ckpt.load_state(str(tmp_path), "m", state)
    got = step(state, epoch[2], 0.0)
    assert step.captures == 2
    eager = ckpt.load_state(str(tmp_path), "m", init_state(cfg, cuda))
    want = _eager_epoch(cfg, eager, epoch[2], 0.0)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=0)
    _assert_states_agree(state, eager, cfg, 6)


def test_entmax_on_the_card_matches_the_cpu_and_replays(cuda):
    """sparsemax and entmax15 (ops/entmax.py: torch.sort over the last axis,
    no value read back) on the card: the forward and the VJP within 1e-6 of
    the CPU's on masked rows (-1e9) and an all-masked one, and the two
    captured in one CUDA graph replay the same bits."""
    from carel_tpu_torch.ops.entmax import entmax15, sparsemax

    gen = torch.Generator().manual_seed(0)
    z = torch.randn(64, 1, 96, generator=gen) * 3
    lengths = torch.randint(1, 97, (64,), generator=gen)
    lengths[0] = 0  # a padded batch row
    z = torch.where(torch.arange(96)[None, None, :] < lengths[:, None, None],
                    z, torch.tensor(-1e9))
    g = torch.randn(z.shape, generator=gen)
    for fn in (sparsemax, entmax15):
        outs = []
        for dev in ("cpu", cuda):
            zz = z.to(dev).clone().requires_grad_(True)
            p = fn(zz)
            p.backward(g.to(dev))
            outs.append((p.detach().cpu(), zz.grad.cpu()))
        for want, got in zip(*outs):
            assert float((got - want).abs().max()) <= 1e-6, fn.__name__
        zc = z.to(cuda)
        want = fn(zc).clone()
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            got = fn(zc)
        got.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(got, want), fn.__name__


def test_mu_dtype_adam_captured_equals_eager(cuda):
    """MuDtypeAdam (train/state.py, --optim_mu_dtype bfloat16) with a 0-d
    device lr: three eager steps and three replays of one captured step
    from the same params and gradients give the same bits (params, bf16
    first moments, fp32 second moments), and set_lr reaches the replay."""
    from carel_tpu_torch.train.state import MuDtypeAdam, set_lr

    gen = torch.Generator().manual_seed(1)
    shapes = ((768, 768), (768,), (21128, 768), (3,))
    p0 = [torch.randn(s, generator=gen) for s in shapes]
    grads = [[torch.randn(s, generator=gen).to(cuda) for s in shapes]
             for _ in range(3)]
    runs = []
    for captured in (False, True):
        params = [torch.nn.Parameter(p.to(cuda)) for p in p0]
        opt = MuDtypeAdam(params, lr=torch.tensor(1e-3, device=cuda))
        if captured:
            for p, g in zip(params, grads[0]):
                p.grad = g.clone()
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                # the first step creates the state; it is rolled back
                saved = [p.detach().clone() for p in params]
                opt.step()
                with torch.no_grad():
                    for p, s in zip(params, saved):
                        p.copy_(s)
                for st in opt.state.values():
                    for t in st.values():
                        t.zero_()
            torch.cuda.current_stream().wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                opt.step()
            # the capture ran nothing: roll it back again
            with torch.no_grad():
                for p, s in zip(params, saved):
                    p.copy_(s)
            for st in opt.state.values():
                for t in st.values():
                    t.zero_()
        for i, gs in enumerate(grads):
            if i == 2:
                set_lr(opt, 5e-4)
            for p, g in zip(params, gs):
                if captured:
                    p.grad.copy_(g)
                else:
                    p.grad = g.clone()
            graph.replay() if captured else opt.step()
        torch.cuda.synchronize()
        runs.append(([p.detach().clone() for p in params],
                     [{k: t.clone() for k, t in opt.state[p].items()}
                      for p in params]))
    (pe, se), (pc, sc) = runs
    assert all(torch.equal(a, b) for a, b in zip(pe, pc))
    for a, b in zip(se, sc):
        assert a["exp_avg"].dtype == torch.bfloat16
        assert a["exp_avg_sq"].dtype == torch.float32
        assert all(torch.equal(a[k], b[k]) for k in a)


def test_original_step_on_the_card_matches_the_cpu(cuda):
    """A tiny fp32 original 3-latent DRL step (train/steps_original.py:
    one backward, the main Adam and the adversaries' RMSprop) on the card
    and on the CPU from the same weights, batch and noise: losses within
    rel 1e-4, gradients within 1e-3 normwise, every parameter within 2 lr
    of its group (Adam and RMSprop move an entry whose gradient is rounding
    noise by up to ~lr) and within 1e-3 lr where its gradient is over 1e-3
    of its tensor's largest (Adam's first step moves by about lr * sign(g),
    so only there does the step show the gradient), the latent heads
    bit-unchanged and the five adversaries moved on both; K10 once (one
    call for the three tables) on the card."""
    from carel_tpu_torch.models.drl_original import (ADVERSARIES,
                                                     LATENT_HEADS,
                                                     DrlOriginalModel,
                                                     OriginalModelConfig)
    from carel_tpu_torch.models.encoder import init_flax_, tiny_encoder_config
    from carel_tpu_torch.train.steps import batch_to_device
    from carel_tpu_torch.train.steps_original import (
        DISC, FROZEN, OriginalLossConfig, create_original_state,
        make_original_train_step)

    mcfg = OriginalModelConfig(
        encoder=tiny_encoder_config(vocab_size=128, dropout=0.0), ec_dim=24,
        con_dim=64, bow_dim=300, dropout=0.0)
    lcfg = OriginalLossConfig(vae_lr=1e-3)
    model = DrlOriginalModel(mcfg)
    init_flax_(model, torch.Generator().manual_seed(0))
    init = {k: v.clone() for k, v in model.state_dict().items()}
    arrays = _tiny_arrays()
    host = {k: np.asarray(getattr(arrays, k))[:8] for k in (
        "input_ids", "attention_mask", "token_type_ids", "pair_labels",
        "emotion_labels", "bow_indices", "bow_weights")}
    host["example_mask"] = np.r_[np.ones(6), np.zeros(2)].astype(np.float32)
    eps = [torch.randn(d, generator=torch.Generator().manual_seed(d))
           for d in (64, 24, 24)]
    runs = {}
    for dev in ("cpu", cuda):
        m = DrlOriginalModel(mcfg)
        m.load_state_dict(init)
        m.to(dev)
        state = create_original_state(lcfg, m, torch.Generator(device=dev))
        ops.reset_launch_counts()
        metrics = make_original_train_step(lcfg)(
            state, batch_to_device(host, torch.device(dev)), 0,
            eps=[e.to(dev) for e in eps])
        # neither optimizer clears .grad (None on the frozen heads)
        runs[str(dev)] = ({k: float(v) for k, v in metrics.items()},
                          {k: v.detach().cpu() for k, v in
                           m.state_dict().items()},
                          {n: p.grad.cpu() for n, p in m.named_parameters()
                           if p.grad is not None},
                          ops.launch_counts(), state.labels)
    (m_c, p_c, g_c, _, labels), (m_g, p_g, g_g, counts, _) = (
        runs["cpu"], runs[str(cuda)])
    for k in m_c:
        assert abs(m_g[k] - m_c[k]) <= 1e-4 * abs(m_c[k]), k
    assert g_c.keys() == g_g.keys()
    assert not any(labels[n] == FROZEN for n in g_c)
    for name in g_c:
        assert _relnorm(g_g[name], g_c[name]) <= 1e-3, name
    for name, label in labels.items():
        lr = lcfg.adv_lr if label == DISC else lcfg.vae_lr
        diff = (p_g[name] - p_c[name]).abs()
        assert float(diff.max()) <= 2 * lr, name
        if name in g_c:
            safe = g_c[name].abs() > 1e-3 * g_c[name].abs().max()
            assert float(diff[safe].max()) <= 1e-3 * lr, name
    for head in LATENT_HEADS:
        for p in (p_c, p_g):
            assert torch.equal(p[f"{head}.weight"], init[f"{head}.weight"])
    for adv in ADVERSARIES:
        for p in (p_c, p_g):
            assert not torch.equal(p[f"{adv}.weight"], init[f"{adv}.weight"])
    assert counts["emb_bwd"] == 1
    assert sum(counts.values()) == 1


def test_pretrain_step_on_the_card_matches_the_cpu(cuda):
    """One tiny fp32 MLM step (pretrain/mlm.py: MlmTrainer, flash
    attention), captured and replayed on the card and eager on the CPU,
    from the same weights and the same draws (draw_noise replaced) at the
    lr after warmup: loss within rel 1e-4, gradients within 1e-3 normwise,
    every parameter within 2 lr and within 1e-3 lr where its gradient is
    over 1e-3 of its tensor's largest (the attention key biases, whose
    gradient is 0 in exact arithmetic, to 2 lr only); the card's step
    launches K7-K9 once a layer and K10 once (the three tables in one
    call), in one capture."""
    from carel_tpu_torch.models.encoder import tiny_encoder_config
    from carel_tpu_torch.pretrain import mlm

    enc = tiny_encoder_config(vocab_size=128, dropout=0.0,
                              attention_impl="flash")
    cfg = mlm.MlmConfig(batch_size=8, seq_len=24, warmup_steps=4,
                        learning_rate=1e-3)
    rng = np.random.default_rng(6)
    n, B, L = 32, cfg.batch_size, cfg.seq_len
    lengths = rng.integers(6, L + 1, n)
    mask = (np.arange(L)[None, :] < lengths[:, None]).astype(np.int32)
    ids = (rng.integers(5, enc.vocab_size, (n, L)) * mask).astype(np.int32)
    ids[:, 0] = 2
    u = rng.random((B, L)).astype(np.float32)
    u[:, ::4] = 0.01
    host = (rng.integers(0, n, B), u, rng.random((B, L)).astype(np.float32),
            rng.integers(5, enc.vocab_size, (B, L)))
    draws = {dev: tuple(torch.from_numpy(np.asarray(a)).to(dev)
                        for a in host) for dev in ("cpu", "cuda")}
    init = mlm.build_mlm(enc, seed=0).state_dict()
    real = mlm.draw_noise
    mlm.draw_noise = lambda gen, n, shape, vocab, device: draws[
        torch.device(device).type]
    runs = {}
    try:
        for dev in ("cpu", "cuda"):
            model = mlm.MlmModel(enc)
            model.load_state_dict(init)
            trainer = mlm.MlmTrainer(model.to(dev), cfg, ids, mask, None, 4,
                                     dev)
            trainer.count.fill_(cfg.warmup_steps)
            ops.reset_launch_counts()
            loss = float(trainer.dispatch(1))
            runs[dev] = (loss, {k: v.detach().cpu() for k, v in
                                model.state_dict().items()},
                         {k: p.grad.cpu() for k, p in
                          model.named_parameters()},
                         ops.launch_counts(), trainer.captures)
    finally:
        mlm.draw_noise = real
    (l_c, p_c, g_c, _, _), (l_g, p_g, g_g, counts, captures) = (
        runs["cpu"], runs["cuda"])
    lr = cfg.learning_rate
    assert abs(l_g - l_c) <= 1e-4 * abs(l_c)
    for name, g in g_c.items():
        if float(g.abs().max()) > 0:
            assert _relnorm(g_g[name], g) <= 1e-3, name
        diff = (p_g[name] - p_c[name]).abs()
        assert float(diff.max()) <= 2 * lr, name
        safe = g.abs() > 1e-3 * g.abs().max()
        if name.endswith("attention.qkv.bias"):
            d = g.shape[0] // 3
            safe[d:2 * d] = False
        if bool(safe.any()):
            assert float(diff[safe].max()) <= 1e-3 * lr, name
    assert captures == 1
    layers = enc.num_layers
    assert {k: v for k, v in counts.items() if v} == {
        "flash_fwd": layers, "flash_bwd_dkv": layers,
        "flash_bwd_dq": layers, "emb_bwd": 1}


def test_pretrain_dispatch_past_capacity_repeats_eager_bits(cuda,
                                                            monkeypatch):
    """Four dispatches of three tiny fp32 MLM steps from one seed, the
    head's capacity forced to 16 rows (a step masks ~17), captured and
    eager: the same rows, the same steps past capacity (which run over
    exactly their masked rows) and the same bits of every loss and
    parameter; the captured run replays its step only where it fits."""
    from carel_tpu_torch.models.encoder import tiny_encoder_config
    from carel_tpu_torch.pretrain import mlm

    monkeypatch.setattr(mlm, "head_capacity", lambda *a: 16)
    enc = tiny_encoder_config(vocab_size=128, dropout=0.0,
                              attention_impl="flash")
    cfg = mlm.MlmConfig(batch_size=8, seq_len=24, warmup_steps=4,
                        learning_rate=1e-3)
    rng = np.random.default_rng(7)
    n, L = 32, cfg.seq_len
    lengths = rng.integers(6, L + 1, n)
    mask = (np.arange(L)[None, :] < lengths[:, None]).astype(np.int32)
    ids = (rng.integers(5, enc.vocab_size, (n, L)) * mask).astype(np.int32)
    ids[:, 0] = 2
    init = mlm.build_mlm(enc, seed=0).state_dict()
    runs = []
    for capture in (True, False):
        model = mlm.MlmModel(enc)
        model.load_state_dict(init)
        trainer = mlm.MlmTrainer(model.to(cuda), cfg, ids, mask, None, 4,
                                 cuda, capture=capture)
        losses = [trainer.dispatch(3).cpu() for _ in range(4)]
        runs.append((losses, {k: v.cpu() for k, v in
                              model.state_dict().items()},
                     (trainer.masked, trainer.head_rows,
                      trainer.full_steps), trainer.replays))
    (l_c, p_c, n_c, r_c), (l_e, p_e, n_e, r_e) = runs
    assert n_c == n_e and 0 < n_c[2] < 12, n_c
    assert r_c == 12 - n_c[2] and r_e == 0
    assert all(torch.equal(a, b) for a, b in zip(l_c, l_e))
    assert all(torch.equal(p_c[k], p_e[k]) for k in p_c)
