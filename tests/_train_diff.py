"""Helpers of the training differential tests (``tests/test_torch_train_
*.py``): the reference's trees by dotted path, the port's trees and the
distance between two float32 arrays in units in the last place."""
from __future__ import annotations

from typing import Any, Dict

import jax
import numpy as np
import torch

from repro_torch.models import params as P


def ref_items(tree) -> Dict[str, Any]:
    """A reference pytree (of arrays or Specs) as ``{dotted path: leaf}``
    in ``jax.tree.flatten``'s order."""
    from repro.models.params import is_spec
    flat, _ = jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_spec)
    return {".".join(str(k.key) for k in path): leaf for path, leaf in flat}


def port_items(tree) -> Dict[str, Any]:
    """A port tree (nested dicts, a stacked value a list of layers) as
    ``{dotted path: numpy}``, in the reference's order."""
    def arr(v):
        if isinstance(v, list):
            return np.stack([P.host_array(t) for t in v])
        return P.host_array(v)
    return {k: arr(v) for k, v in P.tree_items(tree)}


def ulps(got, want, before=None) -> np.ndarray:
    """|got - want| in float32 units in the last place of ``want`` — or,
    given the value ``before`` an update, of the larger of the two (an
    update that cancels, p - lr * u near 0, is exact only to the ulps of
    its terms)."""
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    scale = np.abs(want)
    if before is not None:
        scale = np.maximum(scale, np.abs(np.asarray(before, np.float32)))
    return np.abs(got.astype(np.float64) - want) / np.spacing(
        np.maximum(scale, np.finfo(np.float32).tiny))


def groups_of(model) -> Dict[str, Any]:
    """The model's parameters by reference path, as numpy (stacked)."""
    return port_items(P.leaf_groups(model))


def grads_like(groups: Dict[str, Any], seed: int) -> Dict[str, np.ndarray]:
    """A numpy-seeded gradient for every leaf (shapes of ``groups``)."""
    rng = np.random.default_rng(seed)
    return {k: (rng.standard_normal(v.shape) * 0.01).astype(np.float32)
            for k, v in groups.items()}


def as_port_tree(flat: Dict[str, np.ndarray], like: Dict[str, Any]):
    """Numpy leaves by path as a port tree shaped like ``like`` (a
    stacked leaf split into its layers)."""
    out = {}
    for k, a in flat.items():
        t = torch.from_numpy(np.array(a))
        out[k] = list(t.unbind(0)) if isinstance(like[k], list) else t
    return out
