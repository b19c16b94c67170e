"""Load a JAX parameter pytree (as numpy arrays) into the port's modules.

The port's module attributes mirror the JAX pytree keys, so the tree maps
onto the modules by name.  Two layout differences are bridged here:

  * a dense weight ``w`` is stored (d_in, d_out) in JAX
    (``repro/layers/nn.py:27``) and (d_out, d_in) here: it is transposed;
  * ``params["layers"]`` holds every layer's parameters stacked on a
    leading ``n_layers`` axis (``repro/models/pointcloud.py`` builds it with
    ``jax.vmap``): it is unstacked into ``model.layers[i]``.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

__all__ = ["params_from_jax"]


def _load(module: nn.Module, tree: dict, where: str) -> None:
    for key, value in tree.items():
        path = f"{where}.{key}" if where else key
        if isinstance(value, dict):
            child = getattr(module, key, None)
            if not isinstance(child, nn.Module):
                raise KeyError(f"the port has no module {path!r}")
            _load(child, value, path)
            continue
        param = getattr(module, key, None)
        if not isinstance(param, torch.Tensor):
            raise KeyError(f"the port has no parameter {path!r}")
        arr = np.asarray(value)
        if key == "w":                              # dense: (d_in, d_out) → (d_out, d_in)
            arr = arr.T
        if tuple(arr.shape) != tuple(param.shape):
            raise ValueError(f"{path}: JAX shape {arr.shape} vs port "
                             f"{tuple(param.shape)}")
        with torch.no_grad():
            param.copy_(torch.from_numpy(np.array(arr)).to(param.dtype))


def params_from_jax(tree: dict, model: nn.Module) -> nn.Module:
    """Copy ``tree`` (the JAX parameter pytree with numpy leaves) into
    ``model`` in place and return it.  A key the port lacks, or a shape
    that disagrees, raises."""
    tree = dict(tree)
    stacked = tree.pop("layers", None)
    _load(model, tree, "")
    if stacked is not None:
        depth = {np.asarray(a).shape[0] for a in _leaves(stacked)}
        if depth != {len(model.layers)}:
            raise ValueError(f"JAX tree stacks {depth} layers, the port has "
                             f"{len(model.layers)}")
        for i, layer in enumerate(model.layers):
            _load(layer, _take(stacked, i), f"layers.{i}")
    return model


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def _take(tree, i: int):
    if isinstance(tree, dict):
        return {k: _take(v, i) for k, v in tree.items()}
    return np.asarray(tree)[i]
