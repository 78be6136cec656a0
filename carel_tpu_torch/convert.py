"""JAX params -> this package's ``state_dict``: DrlModel (with or without
attention adapters), the plain PairClassifier, the stage-1 DocEmotionModel,
the clause-level ClauseEmotionDANN, the original 3-latent DrlOriginalModel
(its latent heads ``content_mu`` ... ``cause_log_var``, five adversaries,
four classifiers and ``decoder`` are Dense layers), the IDEC AutoEncoder
(``enc_0`` ... ``out``), the MLM of pretraining (``encoder``, then the
Dense ``mlm_transform`` and ``mlm_output`` and the LayerNorm ``mlm_ln``),
the ``DomainDiscriminator`` (Dense ``fc1``, ``fc2``, ``out``) and a bare
TransformerEncoder. ``jax_params_to_tp_shard`` gives one tensor-parallel
rank's part of the DrlModel's (``parallel/tp.py``).

The JAX params arrive as a nested dict of numpy arrays (e.g. the Flax tree
passed through ``np.asarray``). Layouts (carel_tpu/models/hf_port.py:10-14
and Flax's own modules):

- fused qkv kernel [hidden, 3, heads, head_dim] -> qkv ``Linear`` weight
  [3*hidden, hidden] (the output keeps the (3, heads, head_dim) order);
- attention out kernel [heads, head_dim, hidden] -> weight [hidden, hidden]
  (the encoder's and the clause mixer's ``MultiHeadDotProductAttention``
  ``out``);
- ``MultiHeadDotProductAttention`` query/key/value kernel [in, heads,
  head_dim] -> weight [heads*head_dim, in], bias [heads, head_dim] -> [-1];
- Dense kernel [in, out] -> weight [out, in];
- Embed ``embedding`` -> weight; LayerNorm and BatchNorm ``scale`` ->
  weight;
- the attention adapters (``emotion_adapter``, ``cause_adapter``): their
  ``query`` param [1, 1, D] as it is; the raw kind's ``mha`` holds
  ``query``, ``key``, ``value`` and ``out`` as above, the sparse kinds'
  ``q_proj``, ``k_proj`` and ``v_proj`` are Dense;
- the stage-1 BiLSTM: Flax names its cells ``OptimizedLSTMCell_0``
  (forward) and ``OptimizedLSTMCell_1`` (backward) under ``mixer``, each
  with input kernels ``ii, if, ig, io`` [in, h] (no bias) and hidden
  kernels ``hi, hf, hg, ho`` [h, h] with biases. They become
  ``torch.nn.LSTM``'s ``weight_ih_l0[_reverse]`` (the four transposed and
  stacked in i, f, g, o order), ``weight_hh_l0[_reverse]``, ``bias_hh`` (the
  hidden biases) and ``bias_ih`` = 0.

Module paths match except the encoder layers: ``layer_{i}`` ->
``layers.{i}``. ``attention_impl="flash"`` adds no parameters, so the same
keys serve both attention paths. ``jax_batch_stats_to_state_dict`` takes
Flax's ``batch_stats`` ({mean, var}) into the batch norm's running
buffers. Both raise on a leaf they do not know.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

_LSTM_CELLS = {"OptimizedLSTMCell_0": "_l0",
               "OptimizedLSTMCell_1": "_l0_reverse"}
_LSTM_LEAVES = {(f"{kind}{gate}", leaf)
                for gate in "ifgo"
                for kind, leaves in (("i", ("kernel",)),
                                     ("h", ("kernel", "bias")))
                for leaf in leaves}
_BATCH_STATS = {"mean": "running_mean", "var": "running_var"}


def _flatten(tree: Mapping, prefix=()) -> Dict[tuple, np.ndarray]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v)
    return out


def _module_path(path: tuple) -> str:
    parts = []
    for p in path:
        if p.startswith("layer_") and p[len("layer_"):].isdigit():
            parts += ["layers", p[len("layer_"):]]
        else:
            parts.append(p)
    return ".".join(parts)


def _lstm_state(name: str, suffix: str, leaves: dict) -> dict:
    if set(leaves) != _LSTM_LEAVES:
        raise KeyError(f"unexpected LSTM cell leaves under {name}: "
                       f"{sorted(set(leaves) ^ _LSTM_LEAVES)}")

    def stack(kind, leaf, transpose):
        return np.concatenate([leaves[(kind + g, leaf)].T if transpose
                               else leaves[(kind + g, leaf)] for g in "ifgo"])

    bias_hh = stack("h", "bias", False)
    return {
        f"{name}.weight_ih{suffix}": stack("i", "kernel", True),
        f"{name}.weight_hh{suffix}": stack("h", "kernel", True),
        f"{name}.bias_ih{suffix}": np.zeros_like(bias_hh),
        f"{name}.bias_hh{suffix}": bias_hh,
    }


def jax_params_to_state_dict(params: Mapping) -> Dict[str, torch.Tensor]:
    state, cells = {}, {}
    for path, arr in _flatten(params).items():
        *mod, leaf = path
        arr = np.asarray(arr, np.float32)
        if len(mod) >= 2 and mod[-2] in _LSTM_CELLS:
            cells.setdefault(tuple(mod[:-1]), {})[(mod[-1], leaf)] = arr
            continue
        name = _module_path(tuple(mod))
        if leaf == "kernel":
            if mod[-1] == "out" and arr.ndim == 3:  # [h, hd, H]
                arr = arr.reshape(-1, arr.shape[-1]).T
            elif arr.ndim > 2:  # qkv [H, 3, h, hd]; query/key/value [H, h, hd]
                arr = arr.reshape(arr.shape[0], -1).T
            else:
                arr = arr.T
            key = "weight"
        elif leaf == "bias":
            arr = arr.reshape(-1)
            key = "bias"
        elif leaf in ("embedding", "scale"):
            key = "weight"
        elif leaf == "query" and mod[-1].endswith("_adapter"):
            key = "query"  # an attention adapter's learnt query [1, 1, D]
        else:
            raise KeyError(f"unexpected JAX param {'/'.join(path)}")
        state[f"{name}.{key}"] = torch.tensor(arr)
    for (*mod, cell), leaves in cells.items():
        state.update({k: torch.tensor(v) for k, v in _lstm_state(
            _module_path(tuple(mod)), _LSTM_CELLS[cell], leaves).items()})
    return state


def jax_batch_stats_to_state_dict(batch_stats: Mapping
                                  ) -> Dict[str, torch.Tensor]:
    """Flax ``batch_stats`` ({module: {mean, var}}) -> the running buffers
    of ``FlaxBatchNorm`` (models/dann.py)."""
    state = {}
    for path, arr in _flatten(batch_stats).items():
        *mod, leaf = path
        if leaf not in _BATCH_STATS:
            raise KeyError(f"unexpected JAX batch stat {'/'.join(path)}")
        state[f"{_module_path(tuple(mod))}.{_BATCH_STATS[leaf]}"] = \
            torch.tensor(np.asarray(arr, np.float32))
    return state


def jax_params_to_tp_shard(params: Mapping, rank: int, tp: int,
                           num_heads: int) -> Dict[str, torch.Tensor]:
    """Tp rank ``rank``'s part of ``jax_params_to_state_dict(params)``
    under the Megatron split of parallel/tp.py (``tp`` ranks on 'model')."""
    from carel_tpu_torch.parallel.tp import shard_tensor

    return {k: shard_tensor(k, v, rank, tp, num_heads).clone()
            for k, v in jax_params_to_state_dict(params).items()}
