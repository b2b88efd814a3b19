"""Parameter specification trees, and the modules that hold them.

Every module of the LM stack declares its parameters as a nested dict of
``Spec`` entries (shape + logical axes + initializer), as the
reference's ``repro.models.params`` does, entry for entry.  From one
spec tree come:

  * parameter counts and bytes (``count_params``, ``param_bytes``) —
    equal to the reference's for every config, full size included;
  * stand-ins on the ``meta`` device (``shapes``) — no allocation;
  * real tensors (``init``) drawn from an explicit ``torch.Generator``;
  * ``ParamTree``, an ``nn.Module`` holding the parameters, in which a
    subtree stacked over ``layers`` (the reference's scan over layers)
    becomes an ``nn.ModuleList`` of per-layer trees;
  * ``params_from_numpy``: the reference's parameter tree (numpy
    arrays) as a ``state_dict`` of that module; ``lm_params_from_numpy``
    does it for an LM config's whole tree, ``params_to_numpy`` the way
    back, and ``opt_state_from_numpy`` carries the reference's optimizer
    state;
  * ``leaf_groups``: a module's parameters by the reference's leaf
    paths, in the reference's leaf order (``tree_items``: dict keys
    sorted as strings at every level), a stacked leaf as the list of its
    layers' tensors — what the optimizers and the checkpoint work on.

A ``ParamTree`` and a plain dict of tensors are read the same way
(``p["w"]``, ``"b" in p``), so the layer functions take either.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Iterator, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch.device import to_device

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "int8": torch.int8, "int32": torch.int32}
STACK_AXIS = "layers"


class Spec(NamedTuple):
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]
    init: str = "fan_in"      # fan_in | zeros | ones | normal | embed
    dtype: Optional[str] = None


def is_spec(x) -> bool:
    return isinstance(x, Spec)


def torch_dtype(name: str) -> torch.dtype:
    """A dtype name of the configs (``"bfloat16"``) as a torch dtype."""
    return DTYPES[name]


def leaves(tree, prefix: str = "") -> Iterator[Tuple[str, Spec]]:
    """``(dotted path, Spec)`` of every leaf, in key order."""
    for k, v in tree.items():
        path = f"{prefix}{k}"
        if is_spec(v):
            yield path, v
        else:
            yield from leaves(v, path + ".")


def _map(fn, tree):
    return {k: fn(v) if is_spec(v) else _map(fn, v) for k, v in tree.items()}


class Stacked(dict):
    """A subtree made by ``stack``: every leaf leads with a stacking
    dim (the reference's scan-over-layers layout)."""


def stack(tree, n: int, axis_name: str = STACK_AXIS):
    """Prepend a stacking dim of size ``n``."""
    return Stacked(_map(lambda s: Spec((n,) + s.shape, (axis_name,) + s.axes,
                                       s.init, s.dtype), tree))


def is_stacked(tree) -> bool:
    return isinstance(tree, Stacked)


def unstack(tree) -> Tuple[int, Dict[str, Any]]:
    """Inverse of ``stack``: ``(n, the per-layer tree)``."""
    n = next(s for _, s in leaves(tree)).shape[0]
    return n, _map(lambda s: Spec(s.shape[1:], s.axes[1:], s.init, s.dtype),
                   tree)


def shapes(tree, param_dtype: str):
    """The tree as tensors on the ``meta`` device: shapes and dtypes,
    no storage (the reference's ShapeDtypeStruct tree)."""
    return _map(lambda s: torch.empty(
        s.shape, dtype=torch_dtype(s.dtype or param_dtype), device="meta"),
        tree)


def axes(tree):
    """The tree's logical axes tuple at every leaf (for
    ``sharding.tree_shardings``)."""
    return _map(lambda s: s.axes, tree)


def _fan_in(spec: Spec) -> int:
    """Axes-aware fan-in (the reference's rule): leading batch-like dims
    (scan stacking, expert dims) do not count; the output side is the
    trailing head block, or everything but the input when the last axis
    is "embed" (projections back into the residual stream)."""
    core_shape, core_axes = [], []
    for d, a in zip(spec.shape, spec.axes):
        if a in (STACK_AXIS, "expert", "expert2d") and not core_shape:
            continue
        core_shape.append(d)
        core_axes.append(a)
    if not core_shape:
        core_shape, core_axes = list(spec.shape), list(spec.axes)
    if len(core_shape) == 1:
        return core_shape[0]
    if core_axes and core_axes[-1] == "embed":
        return int(np.prod(core_shape[:-1]))
    if len(core_shape) >= 3:
        return int(np.prod(core_shape[:-2]))
    return core_shape[0]


def init_one(spec: Spec, generator: torch.Generator, param_dtype: str,
             device=None) -> torch.Tensor:
    """One leaf: drawn in float32 on the generator's device, then cast
    and moved to ``device`` (default the generator's)."""
    dtype = torch_dtype(spec.dtype or param_dtype)
    gdev = generator.device
    device = gdev if device is None else torch.device(device)
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=dtype, device=device)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=dtype, device=device)
    if spec.init in ("normal", "embed"):
        std = 0.02
    elif spec.init == "fan_in":
        std = 1.0 / math.sqrt(max(_fan_in(spec), 1))
    else:
        raise ValueError(f"unknown init {spec.init}")
    x = torch.randn(spec.shape, generator=generator, device=gdev,
                    dtype=torch.float32)
    return (std * x).to(device=device, dtype=dtype)


def init(tree, generator: torch.Generator, param_dtype: str, device=None):
    """Real parameters (smoke tests, examples): one draw a leaf, in key
    order, from ``generator``."""
    return _map(lambda s: init_one(s, generator, param_dtype, device), tree)


def count_params(tree) -> int:
    return sum(int(np.prod(s.shape)) for _, s in leaves(tree))


def param_bytes(tree, param_dtype: str) -> int:
    return sum(int(np.prod(s.shape))
               * torch.empty((), dtype=torch_dtype(s.dtype or param_dtype)
                             ).element_size()
               for _, s in leaves(tree))


class ParamTree(nn.Module):
    """The parameters of a spec tree: each ``Spec`` an ``nn.Parameter``
    (allocated, not initialised: ``init_from`` or ``load_state_dict``
    fills it), each dict a ``ParamTree``, each stacked subtree an
    ``nn.ModuleList`` of per-layer ``ParamTree``s.  Read like a dict."""

    def __init__(self, tree, param_dtype: str, device):
        super().__init__()
        self._specs: Dict[str, Spec] = {}
        for name, sub in tree.items():
            if is_spec(sub):
                self._specs[name] = sub
                self.register_parameter(name, nn.Parameter(torch.empty(
                    sub.shape, dtype=torch_dtype(sub.dtype or param_dtype),
                    device=device)))
            elif is_stacked(sub):
                n, layer = unstack(sub)
                self.add_module(name, nn.ModuleList(
                    [ParamTree(layer, param_dtype, device)
                     for _ in range(n)]))
            else:
                self.add_module(name, ParamTree(sub, param_dtype, device))

    def __getitem__(self, name: str):
        return getattr(self, name)

    def __contains__(self, name: str) -> bool:
        return name in self._parameters or name in self._modules

    @torch.no_grad()
    def init_from(self, generator: torch.Generator, param_dtype: str):
        """Draw every parameter from ``generator`` (in ``named_parameters``
        order) by its spec's rule, and copy it in place."""
        for mod in self.modules():
            if isinstance(mod, ParamTree):
                for name, spec in mod._specs.items():
                    p = mod._parameters[name]
                    p.copy_(init_one(spec, generator, param_dtype,
                                     p.device))
        return self


def params_from_numpy(tree, spec, device, param_dtype: str
                      ) -> Dict[str, torch.Tensor]:
    """A reference parameter tree (numpy arrays, the structure of
    ``spec``) as a ``state_dict`` of ``ParamTree(spec, ...)``: a stacked
    subtree's arrays are split along their leading ``layers`` axis into
    the ``ModuleList``'s entries."""
    out: Dict[str, torch.Tensor] = {}

    def walk(t, s, prefix):
        for k, sub in s.items():
            if is_spec(sub):
                dtype = torch_dtype(sub.dtype or param_dtype)
                a = t[k]
                if not torch.is_tensor(a):
                    a = np.asarray(a)
                    if a.dtype != np.float32 and dtype.is_floating_point:
                        a = a.astype(np.float32)      # bf16 from ml_dtypes
                out[prefix + k] = to_device(a, device, dtype)
            elif is_stacked(sub):
                n, layer = unstack(sub)
                for i in range(n):
                    walk(_index(t[k], i), layer, f"{prefix}{k}.{i}.")
            else:
                walk(t[k], sub, f"{prefix}{k}.")

    walk(tree, spec, "")
    return out


def lm_params_from_numpy(tree, cfg, device=None) -> Dict[str, torch.Tensor]:
    """The reference's parameter tree for the LM config ``cfg`` (numpy
    arrays, e.g. ``jax.tree.map(np.asarray, Model(cfg).init_params(key))``)
    as a ``state_dict`` of the port's ``Model(cfg)``, on ``device``
    (default the card).  The stacked ``decoder.blocks`` (and
    ``encoder.blocks``) are split along their leading ``layers`` axis."""
    from repro_torch.device import resolve_device
    from repro_torch.models.model import param_spec
    return params_from_numpy(tree, param_spec(cfg), resolve_device(device),
                             cfg.param_dtype)


def _index(tree, i: int):
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i] if torch.is_tensor(tree) else np.asarray(tree)[i]


def tree_items(tree, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    """``(dotted path, leaf)`` of a nested dict in the reference's pytree
    order: keys sorted as strings at every level.  (A dict keyed by
    dotted paths comes out in the same order as the nested dict they
    name: "." sorts below every character of a key.)"""
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from tree_items(v, f"{prefix}{k}.")
        else:
            yield prefix + k, v


def leaf_groups(tree: ParamTree, prefix: str = "") -> Dict[str, Any]:
    """The parameters of ``tree`` keyed by the reference's leaf paths, in
    its leaf order: a tensor for a leaf, and for a leaf of a stacked
    subtree (path without a layer index) the list of its layers'
    tensors — the reference's ``(layers, ...)`` leaf, unstacked."""
    out: Dict[str, Any] = {}
    for name in sorted(list(tree._specs) + list(tree._modules)):
        path = prefix + name
        if name in tree._specs:
            out[path] = tree._parameters[name]
        elif isinstance(tree[name], nn.ModuleList):
            layers = [leaf_groups(m) for m in tree[name]]
            for sub in layers[0]:
                out[f"{path}.{sub}"] = [layer[sub] for layer in layers]
        else:
            out.update(leaf_groups(tree[name], path + "."))
    return out


def nest(flat: Dict[str, Any]) -> Dict[str, Any]:
    """A dict keyed by dotted paths as the nested dict they name."""
    out: Dict[str, Any] = {}
    for path, v in flat.items():
        *head, last = path.split(".")
        node = out
        for k in head:
            node = node.setdefault(k, {})
        node[last] = v
    return out


def host_array(x) -> np.ndarray:
    """A host copy of a tensor (or array) as numpy; bfloat16, which numpy
    lacks, as float32 (the reference's checkpoint does the same)."""
    if torch.is_tensor(x):
        dtype = torch.float32 if x.dtype == torch.bfloat16 else x.dtype
        return x.detach().to("cpu", dtype, copy=True).numpy()
    a = np.array(x)
    return a.astype(np.float32) if a.dtype.kind not in "fiub" else a


def params_to_numpy(tree: ParamTree) -> Dict[str, Any]:
    """The parameters of ``tree`` as the reference's parameter tree of
    numpy arrays (a copy): a stacked subtree's layers stacked along a
    leading ``layers`` axis — the inverse of ``params_from_numpy``."""
    return nest({path: (np.stack([host_array(t) for t in v])
                        if isinstance(v, list) else host_array(v))
                 for path, v in leaf_groups(tree).items()})


def opt_state_from_numpy(tree, cfg, device=None) -> Dict[str, Any]:
    """The reference's optimizer state for the LM config ``cfg`` (numpy
    arrays: ``{"slots": <the parameter tree's structure, each leaf a
    dict of slots>, "count"}``) as the port's: ``{"slots": {path:
    {slot: tensor}}, "count"}``, keyed by the reference's leaf paths,
    the stacked slots kept whole, float32 (the count int32), on
    ``device`` (default the card)."""
    from repro_torch.device import resolve_device
    from repro_torch.models.model import param_spec
    dev = resolve_device(device)
    slots = {}
    for path, _ in tree_items(param_spec(cfg)):
        node = tree["slots"]
        for k in path.split("."):
            node = node[k]
        slots[path] = {k: to_device(np.asarray(a, np.float32), dev)
                       for k, a in node.items()}
    return {"slots": slots,
            "count": to_device(np.asarray(tree["count"]), dev, torch.int32)}
