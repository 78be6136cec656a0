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
one CUDA graph.
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

    want = [t.clone() for t in both()]
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = both()
    for t in got:
        t.zero_()
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
    assert all(torch.equal(u, v) for u, v in zip(
        cuda_bow.bow_backward_kernel(h, W, b, rowp),
        cuda_bow.bow_backward_kernel(h, W, b, rowp)))


def _bow_backward_planned(h, W, b, rowp, cols, grid):
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
        rowp.data_ptr(), dW.data_ptr(), db.data_ptr(), dh.data_ptr(),
        scratch.data_ptr(), native.stream(h.device))
    return err, dW, db, dh


@pytest.mark.parametrize("cols,grid", [(64, 132), (256, 60), (181, 66)])
def test_bow_backward_plans_agree(cuda, cols, grid):
    """Another cut of V, or fewer blocks that own several chunks each: dW
    and db hold the same bits (each column's sums run over the rows in the
    same order), dh the same sums merged in another order."""
    from carel_tpu_torch.ops import native

    h, W, b, *_, mask = _bow_problem(cuda)
    rowp = _bow_rowp(h, W, b, mask)
    want = cuda_bow.bow_backward_kernel(h, W, b, rowp)
    err, *got = _bow_backward_planned(h, W, b, rowp, cols, grid)
    native.check(err, "bow backward kernel")
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert _relnorm(got[2], want[2]) <= 1e-6


def test_bow_backward_refuses_a_grid_that_cannot_be_resident(cuda):
    """Chunks of 8 columns in 2,976 blocks cannot all be resident: the
    entry point returns the error and launches nothing."""
    from carel_tpu_torch.ops import native

    h, W, b, *_, mask = _bow_problem(cuda)
    rowp = _bow_rowp(h, W, b, mask)
    err, dW, db, dh = _bow_backward_planned(h, W, b, rowp, 8,
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
    h, W, b, *_, mask = _bow_problem(cuda)
    rowp = _bow_rowp(h, W, b, mask)
    want = [t.clone() for t in cuda_bow.bow_backward_kernel(h, W, b, rowp)]
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = cuda_bow.bow_backward_kernel(h, W, b, rowp)
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
    h, W, bias, *_, bmask = _bow_problem(cuda)
    assert torch.equal(cuda_bow.bow_forward_kernel(h, W, bias),
                       cuda_bow.bow_forward_kernel(h, W, bias))
    rowp = _bow_rowp(h, W, bias, bmask)
    assert all(torch.equal(u, v) for u, v in zip(
        cuda_bow.bow_backward_kernel(h, W, bias, rowp),
        cuda_bow.bow_backward_kernel(h, W, bias, rowp)))
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


def _flash_problem(device, B, h, L, hd, dtype, seed=0, min_tail=0):
    rng = np.random.default_rng(seed)
    q, k, v, g = (torch.tensor(rng.normal(size=(B, h, L, hd))
                               .astype(np.float32), device=device).to(dtype)
                  for _ in range(4))
    lengths = rng.integers(1, L - min_tail + 1, B)  # pad tails >= min_tail
    lengths[0], lengths[1] = L, 0  # a row without pads, an all-pad row
    mask = (np.arange(L)[None, :] < lengths[:, None]).astype(np.int32)
    return q, k, v, g, torch.tensor(mask, device=device)


@pytest.mark.parametrize("dtype,tol_out,tol_grad", [
    (torch.float32, 1e-5, 1e-4), (torch.bfloat16, 6e-3, 8e-3)])
@pytest.mark.parametrize("B,h,L,hd,min_tail", [
    (8, 12, 96, 64, 0), (5, 4, 37, 16, 0), (3, 2, 130, 32, 0),
    (2, 2, 70, 128, 0),
    # L over one block's rows, so that the tensor-core kernels' ring wraps;
    # hd = 128; pad tails longer than one tile of 32 keys
    (3, 2, 200, 64, 0), (2, 2, 513, 32, 0), (2, 2, 96, 128, 0),
    (4, 2, 160, 64, 48)])
def test_flash_kernels_match_plain(cuda, B, h, L, hd, min_tail, dtype,
                                   tol_out, tol_grad):
    q, k, v, g, mask = _flash_problem(cuda, B, h, L, hd, dtype,
                                      min_tail=min_tail)
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
    from carel_tpu_torch.models.encoder import attention_scores, scores_upcast

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
