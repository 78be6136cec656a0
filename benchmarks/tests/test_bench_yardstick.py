"""The yardstick's arithmetic and the traffic generator: the frozen FLOP
formula, the kernels' least-work bounds against the port's table of
kernels (PERF.md), and traffic that repeats per seed with the same sizes
on every seed."""

import numpy as np
import pytest

import tiny  # noqa: F401  (puts benchmarks/ on the path)
from harness import traffic as tr
from harness.catalog import Catalog
from harness.work import (mlm_flops_per_step, score_flops_per_batch,
                          train_flops_per_step)

ZH = {"B": 64, "L": 96, "D": 768, "latent": 24, "mmd_alphas": 1,
      "bow_hidden": 48, "bow_vocab": 23808, "bow_slots": 128,
      "tables": [21128, 512, 2]}


def test_train_flops_at_the_flagship_point():
    assert train_flops_per_step(64, 96) == pytest.approx(3.197e12, rel=1e-3)
    assert train_flops_per_step(64, 128, bow_dim=40000) == pytest.approx(
        4.29e12, rel=2e-3)


def test_score_and_mlm_flops():
    assert score_flops_per_batch(512, 96) == pytest.approx(8.52e12, rel=1e-3)
    enc = 3 * 256 * 64 * 12 * (2 * 4 * 768 ** 2 + 2 * 2 * 768 * 3072
                               + 2 * 2 * 64 * 768)
    head = 3 * 100 * 2 * (768 * 768 + 768 * 21128)
    assert mlm_flops_per_step(256, 64, 100) == pytest.approx(enc + head)


@pytest.mark.parametrize("op,ms", [("bow_fwd", 0.00237), ("bow_bwd", 0.00678),
                                   ("emb_bwd", 0.02552),
                                   ("mmd_fwd", 0.00000689),
                                   ("mmd_bwd", 0.0000187)])
def test_kernel_bounds_match_the_port_table(op, ms):
    mod = Catalog().module("kernels", op)
    assert mod.bound_ms(ZH) == pytest.approx(ms, rel=3e-3)


def test_en_embedding_bound():
    en = dict(ZH, L=128, tables=[50265, 514, 1])
    assert Catalog().module("kernels", "emb_bwd").bound_ms(en) == \
        pytest.approx(0.05414, rel=1e-3)


def _pairs(seed, rows=256):
    c = tiny.tiny_config()
    t = tiny.tiny_traffic()["tiny_pairs"]
    return tr.pair_rows(t, c["tokens"], c["vocab_size"], 200, rows, seed)


@pytest.mark.parametrize("seed", [0, 7, 2 ** 31 + 11, 2 ** 40 + 3])
def test_pair_rows_repeat_per_seed(seed):
    a, b = _pairs(seed), _pairs(seed)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])


def test_pair_rows_have_the_same_sizes_on_every_seed():
    a, b = _pairs(1), _pairs(2)
    assert not np.array_equal(a["input_ids"], b["input_ids"])
    for key in ("attention_mask",):
        np.testing.assert_array_equal(np.sort(a[key].sum(1)),
                                      np.sort(b[key].sum(1)))
    np.testing.assert_array_equal(np.sort((a["bow_indices"] >= 0).sum(1)),
                                  np.sort((b["bow_indices"] >= 0).sum(1)))
    assert a["pair_labels"].sum() == b["pair_labels"].sum()
    for x in (a, b):
        w = x["bow_weights"]
        np.testing.assert_allclose(w.sum(1), 1.0, rtol=1e-6)
        k = (x["bow_indices"] >= 0).sum(1)
        for row, n in zip(x["bow_indices"], k):
            assert len(set(row[:n].tolist())) == n


def test_mlm_corpus_repeats_and_keeps_its_lengths():
    t = tiny.tiny_traffic()["tiny_mlm"]
    a, b = tr.mlm_corpus(t, 300, 5), tr.mlm_corpus(t, 300, 5)
    np.testing.assert_array_equal(a[0], b[0])
    c = tr.mlm_corpus(t, 300, 6)
    np.testing.assert_array_equal(np.sort(a[1].sum(1)), np.sort(c[1].sum(1)))
    assert (a[0][a[1] == 0] == t["pad_id"]).all()
    assert tr.mean_candidates(t) == pytest.approx(
        float(np.mean(a[1].sum(1) - 2)))
