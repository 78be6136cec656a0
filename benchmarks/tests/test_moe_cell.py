"""The cells ``dsv2lite_train`` and ``zh_train_bf16mu`` on the CPU at a tiny
size: the program agrees with its reference and the float8 control fails
the limits; the readers of ``expert_fill_pct.moe_train`` and
``expert_gemm_roofline.moe_train`` on hand-made spans and traces;
``kernels/expert_gemm.py`` left out of ``train_kernels_roofline``; the
frozen FLOP count of ``harness/work_moe.py``."""

import json
import time

import pytest

import tiny
from carel_tpu_torch.utils import profiling
from harness.catalog import Catalog
from harness.runner import run_cell
from harness.trace import Trace
from harness.work_moe import (expert_gemm_bound_ms, moe_train_flops_per_step,
                              token_fwd_flops)

SEED = 2 ** 31 + 77
# the bf16 first moment reads the program's first gradient rounded to bf16
# (2^-8 of each entry), so that cell's gradient limit is 1e-2
LIMITS = {"tiny_moe_train": {"loss": 1e-4, "grad": 1e-4, "change": 1e-4,
                             "routing_flip_share": 0.3},
          "tiny_bf16mu_train": {"loss": 1e-4, "grad": 1e-2, "change": 1e-4}}


def tiny_moe_config() -> dict:
    c = tiny._load("configs", "deepseek-v2-lite")
    c.update(vocab_size=300, hidden_size=32, num_hidden_layers=3,
             num_attention_heads=2, intermediate_size=48, kv_lora_rank=16,
             qk_nope_head_dim=8, qk_rope_head_dim=4, v_head_dim=8,
             moe_intermediate_size=16, n_routed_experts=4,
             num_experts_per_tok=3)
    c["experts_held"] = dict(c["experts_held"], first=2, router_experts=8)
    c["rope_scaling"] = dict(c["rope_scaling"],
                             original_max_position_embeddings=32)
    c["tokens"] = {"pad": 299, "cls": 298, "sep": 299, "first_content": 0,
                   "content_below": 290}
    c["carel"] = dict(c["carel"], ec_dim=8, bow_vocab=200)
    c["precision"] = {"encoder": "float32", "heads": "float32"}
    return c


@pytest.fixture(scope="module")
def catalog(tmp_path_factory):
    root = tiny.write_root(tmp_path_factory.mktemp("tiny"))
    (root / "configs" / "tiny_moe.json").write_text(
        json.dumps(tiny_moe_config()))
    for cell, config, traffic, driver in (
            ("tiny_moe_train", "tiny_moe", "tiny_pairs", "train_moe"),
            ("tiny_bf16mu_train", "tiny", "tiny_pairs",
             "train_bf16mu")):
        (root / "workloads" / f"{cell}.json").write_text(json.dumps(
            {"config": config, "traffic": traffic, "driver": driver,
             "chips": 1, "why": "a CPU test", "limits": LIMITS[cell]}))
    return Catalog([root])


def bench() -> dict:
    b = tiny.tiny_bench()
    for m in b["end_to_end"] + b["per_layer"]:
        if "tiny_train" in m.get("workloads", []):
            m["workloads"] += ["tiny_moe_train", "tiny_bf16mu_train"]
    return b


@pytest.mark.parametrize("cell", ["tiny_moe_train", "tiny_bf16mu_train"])
def test_program_agrees_with_the_reference(catalog, cell):
    result, lines = run_cell(cell, SEED, 0.3, False, "cpu", catalog, bench(),
                             time.perf_counter())
    json.dumps(result)
    assert result["correct"], lines
    assert result["failed"] == 0 and result["attempted"] > 0
    if cell == "tiny_moe_train":
        # both fp32 on the CPU: the same experts on every token
        assert "compared routing_flip_share 0.000000e+00 limit " \
            "3.000000e-01" in lines
        assert any(line.startswith("counters ") and "'held_rows'" in line
                   for line in lines)


@pytest.mark.parametrize("cell", ["tiny_moe_train", "tiny_bf16mu_train"])
def test_the_control_fails_the_limits(catalog, cell):
    import calibrate

    rec = calibrate.calibrate(cell, [SEED], {SEED}, 0.3, "cpu", catalog)[0]
    limits = LIMITS[cell]
    # the control computes the program's routes: no flip share of its own
    assert any(rec["control_fp8"][k] > limits[k] for k in limits
               if k != "routing_flip_share")
    assert all(rec["program"][k] <= limits[k] for k in limits)
    json.dumps(rec)


def test_a_gate_that_picks_other_experts_fails_the_flip_limit(
        catalog, monkeypatch):
    """A planted fault: every layer's gate hands on the experts one above
    its scores' top-k (mod the router's width). The reference computes the
    experts the program chose, so only routing_flip_share sees it: every
    choice flips, against a limit of 0.3."""
    from carel_tpu_torch.models import deepseek_v2 as ds

    route = ds.MoE.route

    def shifted(self, x):
        w, ids = route(self, x)
        return w, (ids + 1) % self.gate.shape[0]

    monkeypatch.setattr(ds.MoE, "route", shifted)
    result, lines = run_cell("tiny_moe_train", SEED, 0.3, False, "cpu",
                             catalog, bench(), time.perf_counter())
    assert not result["correct"], lines
    assert result["compared"]["routing_flip_share"]["value"] == 1.0


def test_the_bf16mu_traffic_is_the_flagship_mix():
    """zh_train_bf16mu's traffic holds flagship_b64_s96's numbers under a
    name of its own (a configuration and traffic pair once)."""
    cat = Catalog()
    same = cat.traffic("flagship_b64_s96")
    copy = cat.traffic("flagship_b64_s96_bf16mu")
    same.pop("why"), copy.pop("why")
    assert copy == same
    assert cat.workload("zh_train_bf16mu")["driver"] == "train_bf16mu"


@pytest.mark.parametrize("kernels,want", [
    ([("multi_tensor_apply_kernel<TensorListMetadata<2>, "
       "BinaryOpListAlphaFunctor<float>>", 0.0, 3.0),
      ("multi_tensor_apply_kernel<FusedOptimizerTensorListMetadata<4>, "
       "FusedAdamMathFunctor<float>>", 3.0, 9.0),
      ("multi_tensor_apply_kernel<TensorListMetadata<1>, "
       "BinaryOpScalarFunctor<float>>", 9.0, 10.0),
      ("bow_fwd_kernel", 10.0, 11.0)], 4.0 / 1e3 / 2),
    ([("multi_tensor_apply_kernel<FusedOptimizerTensorListMetadata<4>, "
       "FusedAdamMathFunctor<float>>", 0.0, 6.0)], None)])
def test_foreach_adam_reads_the_foreach_kernels_alone(kernels, want):
    tr = Trace(kernels, (0.0, 100.0), [], 1, {"steps": 2.0})
    run = type("Run", (), {"trace": tr, "notes": []})()
    got = Catalog().module("metrics", "foreach_adam_ms_per_step.train").read(
        run)
    assert got == (pytest.approx(want) if want is not None else None)


def test_the_frozen_flop_count():
    c = tiny._load("configs", "deepseek-v2-lite")
    keys = dict(c, n_routed_experts=c["experts_held"]["router_experts"])
    assert token_fwd_flops(keys, 8, 96) == 1155530752.0
    assert moe_train_flops_per_step(128, 96, keys, 8, 23808, 24) == \
        42598514460672.0


# (name, start us, end us, counts) in a window of 0-100 us; the last moe
# span lies after the window
SPANS = [("epoch_step.moe", 40.0, 41.0,
          {"held_rows": 119000, "buffer_rows": 971776, "max_expert_rows": 1300,
           "steps": 16, "layers": 13}),
         ("epoch_step.replays", 1.0, 39.0, {}),
         ("epoch_step.moe", 150.0, 151.0,
          {"held_rows": 1, "buffer_rows": 10, "max_expert_rows": 1,
           "steps": 16, "layers": 13})]
KERNELS = [("expert_gemm_kernel", 5.0, 15.0),
           ("expert_gemm_wgrad_kernel", 15.0, 20.0),
           ("bow_fwd_kernel", 20.0, 21.0)]


class _Driver:
    def shapes(self):
        return {"B": 128, "L": 96, "D": 2048, "moe_width": 1408,
                "held_experts": 8}


def _run(trace=True):
    tr = Trace(list(KERNELS), (0.0, 100.0), [], 1, {"steps": 16.0}) \
        if trace else None
    return type("Run", (), {"trace": tr, "notes": [], "catalog": Catalog(),
                            "driver": _Driver()})()


def _use(monkeypatch, spans):
    monkeypatch.setattr(profiling, "spans", lambda: [
        profiling.Span(n, int(s * 1e3), int(e * 1e3), i + 1, None, 0, c)
        for i, (n, s, e, c) in enumerate(spans)])


@pytest.mark.parametrize("case", ["read", "no spans", "no moe spans",
                                  "no trace", "no recorder"])
@pytest.mark.parametrize("metric", ["expert_fill_pct.moe_train",
                                    "expert_gemm_roofline.moe_train"])
def test_moe_readers_read_the_moe_spans(monkeypatch, case, metric):
    _use(monkeypatch, {"no spans": [],
                       "no moe spans": SPANS[1:2]}.get(case, SPANS))
    if case == "no recorder":
        monkeypatch.delattr(profiling, "spans")
    got = Catalog().module("metrics", metric).read(_run(case != "no trace"))
    if case != "read":
        assert got is None
    elif metric == "expert_fill_pct.moe_train":
        assert got == pytest.approx(100.0 * 119000 / 971776)
    else:
        want = expert_gemm_bound_ms(119000, 16 * 13, 2048, 1408, 8) / 0.015
        assert got == pytest.approx(100.0 * want)


def test_expert_gemm_bound_counts_flops_and_bytes():
    # 9,216 rows a layer and step: 3 x 2 x 9216 x 2048 x 4224 FLOPs
    flops = 3 * 2 * 9216 * 2048 * 3 * 1408
    assert expert_gemm_bound_ms(9216, 1, 2048, 1408, 8) == pytest.approx(
        flops / 989e12 * 1e3)
    # few rows: the weights' bytes bound it
    nbytes = 3 * (8 * 3 * 2048 * 1408 * 2 + 1 * 2 * 2048 * 2)
    assert expert_gemm_bound_ms(1, 1, 2048, 1408, 8) == pytest.approx(
        nbytes / 3.35e12 * 1e3)


def test_expert_gemm_is_left_out_of_train_kernels_roofline():
    op = Catalog().module("kernels", "expert_gemm")
    shapes = {"B": 64, "L": 96, "D": 768, "latent": 24, "mmd_alphas": 1,
              "bow_hidden": 48, "bow_vocab": 23808, "bow_slots": 128,
              "tables": [21128, 512, 2]}
    assert op.bound_ms(shapes) is None
    reader = Catalog().module("metrics", "train_kernels_roofline")

    def run(kernels):
        tr = Trace(kernels, (0.0, 100.0), [], 1, {"steps": 1.0})
        driver = type("D", (), {"shapes": lambda self: shapes})()
        return type("Run", (), {"trace": tr, "notes": [],
                                "catalog": Catalog(), "driver": driver})()

    base = [("bow_fwd_kernel", 0.0, 3.0), ("mmd_fwd_kernel", 3.0, 4.0)]
    with_moe = base + [("expert_gemm_kernel", 5.0, 50.0)]
    assert reader.read(run(with_moe)) == reader.read(run(base))
