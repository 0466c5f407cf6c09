"""Flax parameters (as numpy) → a state_dict of the port's modules.

The port names its submodules after the flax tree, so the mapping is a
flatten with these renames:

  * `blocks_{i}` (flax list naming) → `blocks.{i}`, except the CLIP text
    block's LayerNorms `ln_1`/`ln_2` and the dVAE's `dgcnn_1`/`dgcnn_2`,
    whose digit is part of the name;
  * Dense `kernel` (in, out) → `weight` (out, in);
  * LayerNorm `scale` → `weight` (`bias` stays);
  * BatchNormInference `mean`/`var`/`scale`/`bias` and the bare
    parameters `cls_token`/`cls_pos` keep their names.

The JAX package's block-kernel parameter holders build the same
Dense/LayerNorm tree, so one mapping covers both of its attention paths.
`from_jax_stacked` carries the pipeline's stacked trunk parameters
(`parallel/pp.py`'s two layouts) into the same per-block names.
No JAX is imported: the input is the nested dict of numpy arrays that
`jax.tree_util.tree_map(np.asarray, params)` gives.
"""
from __future__ import annotations

import re
from collections.abc import Mapping

import numpy as np
import torch

_BN_KEYS = {"mean", "var", "scale", "bias"}
#: Module names that end in `_{digit}` without being list elements.
_NOT_LISTS = {"ln_1", "ln_2", "dgcnn_1", "dgcnn_2"}


def _module_name(part: str) -> str:
    m = re.fullmatch(r"(.+)_(\d+)", part)
    if m and part not in _NOT_LISTS:
        return f"{m.group(1)}.{m.group(2)}"
    return part


def from_jax_params(tree: Mapping) -> dict[str, torch.Tensor]:
    """Flax params (with or without the top-level "params" key) → state_dict."""
    if set(tree) == {"params"}:
        tree = tree["params"]
    out: dict[str, torch.Tensor] = {}

    def walk(node: Mapping, path: list[str]) -> None:
        is_bn = set(node) == _BN_KEYS
        for name, val in node.items():
            if isinstance(val, Mapping):
                walk(val, path + [_module_name(name)])
                continue
            arr = np.asarray(val, dtype=np.float32)
            if name == "kernel":
                name, arr = "weight", arr.T
            elif name == "scale" and not is_bn:
                name = "weight"
            out[".".join(path + [name])] = torch.from_numpy(
                np.ascontiguousarray(arr))

    walk(tree, [])
    return out


def _map_leaves(fn, tree: Mapping):
    return {k: _map_leaves(fn, v) if isinstance(v, Mapping) else fn(v)
            for k, v in tree.items()}


def _first_leaf(tree: Mapping):
    for v in tree.values():
        return _first_leaf(v) if isinstance(v, Mapping) else v
    raise ValueError("an empty parameter tree")


def from_jax_stacked(stacked: Mapping, prefix: str,
                     interleaved: bool = False) -> dict[str, torch.Tensor]:
    """The JAX pipeline's stacked trunk blocks → the port's state_dict
    entries `{prefix}.{i}.…` of each block i: GPipe's (S, L/S, ...)
    leaves hold block s·L/S + j at [s, j] (`stack_trunk_params`), the
    interleaved (S, V, L/(S·V), ...) leaves block (v·S + s)·Lc + c at
    [s, v, c] (`stack_trunk_params_interleaved`)."""
    shape = np.shape(_first_leaf(stacked))
    if interleaved:
        S, V, Lc = shape[:3]
        where = {(v * S + s) * Lc + c: (s, v, c) for s in range(S)
                 for v in range(V) for c in range(Lc)}
    else:
        S, n = shape[:2]
        where = {s * n + j: (s, j) for s in range(S) for j in range(n)}
    out: dict[str, torch.Tensor] = {}
    for i in sorted(where):
        block = _map_leaves(lambda a: np.asarray(a)[where[i]], stacked)
        for name, t in from_jax_params(block).items():
            out[f"{prefix}.{i}.{name}"] = t
    return out
