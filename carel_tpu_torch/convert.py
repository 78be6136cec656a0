"""JAX DrlModel params -> this package's DrlModel ``state_dict``.

The JAX params arrive as a nested dict of numpy arrays (e.g. the Flax tree
passed through ``np.asarray``). Layouts (carel_tpu/models/hf_port.py:10-14):

- fused qkv kernel [hidden, 3, heads, head_dim] -> qkv ``Linear`` weight
  [3*hidden, hidden] (the output keeps the (3, heads, head_dim) order);
- attention out kernel [heads, head_dim, hidden] -> weight [hidden, hidden];
- Dense kernel [in, out] -> weight [out, in];
- Embed ``embedding`` -> weight; LayerNorm ``scale`` -> weight.

Module paths match except the encoder layers: ``layer_{i}`` ->
``layers.{i}``. ``attention_impl="flash"`` adds no parameters, so the same
keys serve both attention paths.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch


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


def jax_params_to_state_dict(params: Mapping) -> Dict[str, torch.Tensor]:
    state = {}
    for path, arr in _flatten(params).items():
        *mod, leaf = path
        name = _module_path(tuple(mod))
        arr = np.asarray(arr, np.float32)
        if leaf == "kernel":
            if mod[-1] == "qkv":  # [H, 3, h, hd]
                arr = arr.reshape(arr.shape[0], -1).T
            elif mod[-1] == "out" and arr.ndim == 3:  # [h, hd, H]
                arr = arr.reshape(-1, arr.shape[-1]).T
            else:
                arr = arr.T
            key = "weight"
        elif leaf == "bias":
            arr = arr.reshape(-1)
            key = "bias"
        elif leaf in ("embedding", "scale"):
            key = "weight"
        else:
            raise KeyError(f"unexpected JAX param {'/'.join(path)}")
        state[f"{name}.{key}"] = torch.tensor(arr)
    return state
