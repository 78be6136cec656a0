"""The yardstick's arithmetic for a DeepSeek-V2 encoder under the CAREL
heads: the model FLOPs of a training step and the least-work bound of the
held experts' grouped products. Frozen here so that a change to the
program cannot move it.

Per token, forward, at a sequence of L (matmul FLOPs, 2 a multiply-add):
multi-head latent attention's four projections (q, kv_a, kv_b, o) and its
two products over L keys (q k^T at the nope + rope head size, p v at the
v head size); the dense layers' SwiGLU (three products at
``intermediate_size``); a mixture layer's gate, shared experts (three
products at ``n_shared_experts x moe_intermediate_size``) and the routed
rows it computes here, ``num_experts_per_tok x held / n_routed_experts`` a
token on average (each three products at ``moe_intermediate_size``). The
backward counts twice the forward. At DeepSeek-V2-Lite's widths, 14
layers, 8 of 64 experts held and L 96: 1.155 GFLOP a token, and at b128 x
s96 with the heads over BoW V 23,808 and ec_dim 24, 4.2599e13 a step.
"""

from __future__ import annotations

from harness.work import PEAK_BF16_FLOPS, PEAK_BYTES, carel_heads_fwd_flops


def token_fwd_flops(c: dict, held: int, L: int) -> float:
    """Forward matmul FLOPs of one token through the encoder of config
    ``c`` (``n_routed_experts`` the router's width) holding ``held``
    routed experts."""
    d, h = c["hidden_size"], c["num_attention_heads"]
    qk = c["qk_nope_head_dim"] + c["qk_rope_head_dim"]
    vd, lora = c["v_head_dim"], c["kv_lora_rank"]
    attn = 2 * d * (h * qk + lora + c["qk_rope_head_dim"]) \
        + 2 * lora * h * (c["qk_nope_head_dim"] + vd) + 2 * h * vd * d \
        + 2 * L * h * (qk + vd)
    dense = 3 * 2 * d * c["intermediate_size"]
    mi = c["moe_intermediate_size"]
    rows = c["num_experts_per_tok"] * held / c["n_routed_experts"]
    mix = 2 * d * c["n_routed_experts"] \
        + 3 * 2 * d * mi * (c["n_shared_experts"] + rows)
    n_dense = c["first_k_dense_replace"]
    n_mix = c["num_hidden_layers"] - n_dense
    return n_dense * (attn + dense) + n_mix * (attn + mix)


def moe_train_flops_per_step(B: int, L: int, c: dict, held: int,
                             bow_dim: int, ec_dim: int) -> float:
    """Model FLOPs of one CAREL training step over the encoder (backward =
    2 x forward)."""
    return 3.0 * (B * L * token_fwd_flops(c, held, L)
                  + carel_heads_fwd_flops(B, c["hidden_size"], ec_dim, 6,
                                          bow_dim))


def expert_gemm_bound_ms(held_rows: float, layer_steps: float, d: int,
                         width: int, held: int) -> float:
    """The least time in ms of the held experts' grouped products of a
    training window: ``held_rows`` routed rows (summed over steps and
    layers) through the gate/up and down products forward (2 x rows x d x
    3 width) and twice that backward, at the dense bf16 peak; or the bytes,
    every layer-step's held bf16 weights and each row's input and output
    (2 d bf16) read or written once in each of the three passes, at 3.35
    TB/s, whichever is larger."""
    flops = 3 * 2.0 * held_rows * d * 3 * width
    nbytes = 3 * (layer_steps * held * 3 * d * width * 2
                  + held_rows * 2 * d * 2)
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES) * 1e3
