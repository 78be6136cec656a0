"""The comparison that decides ``correct``, driven on the CPU at a tiny
size: the reference agrees with the port; each fault a cell can have,
planted in the program underneath, turns ``correct`` false; the control
(the reference with float8 encoder products in the program's place)
fails the limits. The harness's look for a card is skipped: these call
the run's body directly."""

import json
import time
from types import SimpleNamespace

import pytest
import torch
import torch.nn.functional as F

import tiny
from harness.catalog import Catalog
from harness.runner import run_cell

SEED = 2 ** 31 + 77


@pytest.fixture(scope="module")
def catalog(tmp_path_factory):
    return Catalog([tiny.write_root(tmp_path_factory.mktemp("tiny"))])


def run(catalog, cell, seed=SEED, trace=False):
    result, lines = run_cell(cell, seed, 0.3, trace, "cpu", catalog,
                             tiny.tiny_bench(), time.perf_counter())
    json.dumps(result)
    return result, lines


@pytest.mark.parametrize("cell", ["tiny_train", "tiny_score",
                                  "tiny_pretrain"])
@pytest.mark.parametrize("seed", [1, SEED])
def test_port_agrees_with_the_reference(catalog, cell, seed):
    result, lines = run(catalog, cell, seed)
    assert result["correct"], lines
    assert result["failed"] == 0 and result["attempted"] > 0
    assert list(result)[-1] == "compared"
    assert lines[-1] == "correct True"
    assert all(line.startswith("compared ") for line in
               lines[-1 - len(result["compared"]):-1])
    names = {m["name"] for m in tiny.tiny_bench()["end_to_end"]
             if cell in m.get("workloads", [cell])}
    assert set(result["metrics"]) == names


def _half_loss(original):
    def loss(cfg, out, batch, *args, **kw):
        mask = batch["example_mask"].clone()
        mask[mask.shape[0] // 2:] = 0.0
        return original(cfg, out, dict(batch, example_mask=mask), *args,
                        **kw)
    return loss


def test_state_left_unchanged_fails_training(catalog, monkeypatch):
    monkeypatch.setattr(torch.optim.Adam, "step",
                        lambda self, closure=None: None)
    result, _ = run(catalog, "tiny_train")
    assert not result["correct"]


def test_half_the_batch_fails_training(catalog, monkeypatch):
    from carel_tpu_torch.train import steps

    monkeypatch.setattr(steps, "vae_and_classifier_loss",
                        _half_loss(steps.vae_and_classifier_loss))
    result, _ = run(catalog, "tiny_train")
    assert not result["correct"]


def test_an_altered_answer_fails_scoring(catalog, monkeypatch):
    from carel_tpu_torch.models.drl import DrlModel

    original = DrlModel.pair_probabilities

    def altered(self, *args, **kw):
        p = original(self, *args, **kw).clone()
        p[3] = 1.0 - p[3]
        return p

    monkeypatch.setattr(DrlModel, "pair_probabilities", altered)
    result, _ = run(catalog, "tiny_score")
    assert not result["correct"]


def test_state_left_unchanged_fails_pretraining(catalog, monkeypatch):
    monkeypatch.setattr(torch.optim.AdamW, "step",
                        lambda self, closure=None: None)
    result, _ = run(catalog, "tiny_pretrain")
    assert not result["correct"]


def test_half_the_batch_fails_pretraining(catalog, monkeypatch):
    from carel_tpu_torch.pretrain import mlm

    def half(logits, ids, reduction):
        nll = F.cross_entropy(logits, ids, reduction=reduction)
        n = nll.shape[0]
        return torch.cat([2 * nll[:n // 2], 0 * nll[n // 2:]])

    monkeypatch.setattr(mlm, "F", SimpleNamespace(cross_entropy=half,
                                                  gelu=F.gelu))
    result, _ = run(catalog, "tiny_pretrain")
    assert not result["correct"]


@pytest.mark.parametrize("cell", ["tiny_train", "tiny_score",
                                  "tiny_pretrain"])
def test_the_control_fails_the_limits(catalog, cell):
    """The control kept at a size a test run holds: the reference with
    float8 encoder products in the program's place reads over the cell's
    limits, where the program reads far under them."""
    import calibrate

    rec = calibrate.calibrate(cell, [SEED], {SEED}, 0.3, "cpu", catalog)[0]
    limits = catalog.workload(cell)["limits"]
    assert any(rec["control_fp8"][k] > limits[k] for k in limits)
    assert all(rec["program"][k] <= limits[k] for k in limits)


def test_lower_numerics_round_both_products():
    """The control and the lower precisions of the fp32 parts round every
    operand of the forward and backward products; fp32 leaves them as
    they are."""
    from reference.numerics import (Numerics, round_bf16, round_fp8,
                                    round_tf32)

    one = 1.0 + 2 ** -11
    x = torch.tensor([one, 1.0 + 2 ** -12, -one, 3.0])
    assert round_tf32(x).tolist() == [1.0 + 2 ** -10, 1.0, -1.0 - 2 ** -10,
                                      3.0]
    gen = torch.Generator().manual_seed(5)
    a = torch.randn(6, 9, generator=gen, requires_grad=True)
    b = torch.randn(9, 4, generator=gen, requires_grad=True)
    g = torch.randn(6, 4, generator=gen)
    for num, rnd in ((Numerics(head="tf32").head_mm, round_tf32),
                     (Numerics(head="bf16").head_mm, round_bf16),
                     (Numerics("fp8").bmm, round_fp8)):
        y = num(a, b)
        torch.testing.assert_close(y, rnd(a) @ rnd(b), rtol=0, atol=0)
        ga, gb = torch.autograd.grad(y, (a, b), g)
        torch.testing.assert_close(ga, rnd(g) @ rnd(b).T, rtol=0, atol=0)
        torch.testing.assert_close(gb, rnd(a).T @ rnd(g), rtol=0, atol=0)
    w = torch.randn(4, 9, generator=gen)
    torch.testing.assert_close(Numerics().head_linear(a, w, None),
                               F.linear(a, w), rtol=0, atol=0)
