"""Logical-axis sharding with divisibility-checked fallback — the
reference's ``repro.parallel.sharding``, rule for rule.

Model code never names mesh axes directly; it tags tensor dimensions with
*logical* names ("batch", "heads", "d_ff", "expert", ...).  A rule table
maps each logical name to an ordered list of candidate mesh-axis tuples;
resolution picks the first candidate whose axes (a) exist in the mesh,
(b) are not already used by another dimension of the same tensor, and
(c) evenly divide the dimension.  Anything that cannot shard falls back
to replication and is recorded in ``FALLBACK_LOG``, so the dry run can
show exactly what got replicated and why.

The port's placement model: one process per device, a
``torch.distributed.device_mesh.DeviceMesh`` over the world's ranks, and
the collectives written out (the shard_map MoE, the trainer's gradient
all-reduce) where the reference had GSPMD insert them.  So placement is
explicit, and ``constrain`` moves nothing: with a mesh active it resolves
the tensor's spec — the fallback log fills exactly as the reference's
does while its step is traced — and returns the tensor as it is.  A value
never depends on placement.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Optional, Sequence, Tuple

import torch

Candidate = Optional[Tuple[str, ...]]
Rules = dict  # logical name -> tuple of Candidate, tried in order


def _c(*names) -> Tuple[Candidate, ...]:
    """Helper: each arg is either a tuple of mesh axes or None."""
    out = []
    for n in names:
        if n is None:
            out.append(None)
        elif isinstance(n, str):
            out.append((n,))
        else:
            out.append(tuple(n))
    return tuple(out)


# ---------------------------------------------------------------------------
# Rule tables.  "pod" exists only on the multi-pod mesh; candidates naming it
# are skipped automatically on the single-pod mesh.
# ---------------------------------------------------------------------------

# Training: DP(+pod) over batch, FSDP over the embed dim of weights along
# "data", TP over heads / d_ff / vocab along "model", EP over "data".
TRAIN_RULES: Rules = {
    "batch":    _c(("pod", "data"), "data", None),
    "seq":      _c(None),
    "kv_seq":   _c(None),
    "embed":    _c("data", None),          # FSDP shard dim of weights
    "embed_tp": _c("model", None),         # activation d_model when TP'd
    "d_model":  _c(None),                  # activation d_model (replicated)
    "heads":    _c("model", None),
    "kv_heads": _c("model", None),
    "head_dim": _c(None),
    "d_ff":     _c("model", None),
    "vocab":    _c("model", None),
    "expert":   _c("data", None),          # EP: experts over data
    "expert2d": _c(("data", "model"), "data", None),  # EP over both axes
    "expert_ff": _c("model", None),        # TP inside each expert
    "expert_rows": _c("data", None),       # dispatch rows (one per data shard)
    "lru":      _c("model", None),
    "layers":   _c(None),
    "lora":     _c(None),
    "stack":    _c(None),
}

# Decode / prefill: batch over data(+pod); weights TP over "model" only —
# serving keeps dense/attn weights replicated over "data", because
# FSDP-style sharding would re-all-gather every parameter on every decode
# step.  Expert weights stay EP-sharded over "data" via the separate
# "expert" axis.  KV cache: batch over data, heads over model; long
# context shards the cache sequence instead.
SERVE_RULES: Rules = dict(TRAIN_RULES)
SERVE_RULES.update({
    "batch":    _c(("pod", "data"), "data", None),
    "kv_seq":   _c(None),
    "cache_seq": _c(None),       # overridden to ("model",) for long_500k
    "expert":   _c("data", None),
    "embed":    _c(None),
})

LONG_CONTEXT_OVERRIDES = {
    # batch=1: nothing to DP over -> shard the KV cache sequence instead.
    "cache_seq": _c("model", None),
    "kv_seq":    _c(None),
    "batch":     _c(None),
}


def make_rules(kind: str, *, long_context: bool = False) -> Rules:
    rules = dict(TRAIN_RULES if kind == "train" else SERVE_RULES)
    if long_context:
        rules.update(LONG_CONTEXT_OVERRIDES)
    return rules


# ---------------------------------------------------------------------------
# Specs and shardings
# ---------------------------------------------------------------------------

class PartitionSpec(tuple):
    """One entry a tensor dimension: a mesh-axis name, a tuple of names
    (the dimension split over several axes, major first), or ``None``
    (replicated) — ``jax.sharding.PartitionSpec``'s entries."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self):
        return f"PartitionSpec{tuple.__repr__(self)}"


def _axis_sizes(mesh) -> dict:
    """Mesh-axis name -> size, of a ``DeviceMesh`` or of anything with
    ``mesh_dim_names`` and a ``shape``."""
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


def entry_axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


class NamedSharding:
    """A spec on a mesh: where each block of a tensor lives."""

    def __init__(self, mesh, spec: PartitionSpec):
        self.mesh = mesh
        self.spec = spec

    def __repr__(self):
        return f"NamedSharding({_axis_sizes(self.mesh)}, {self.spec!r})"

    def placements(self) -> list:
        """The DTensor placement of each mesh dimension: ``Shard(i)``
        where tensor dim ``i`` is split over it, else ``Replicate()``."""
        from torch.distributed.tensor import Replicate, Shard
        dim_of = {a: i for i, e in enumerate(self.spec)
                  for a in entry_axes(e)}
        return [Shard(dim_of[a]) if a in dim_of else Replicate()
                for a in self.mesh.mesh_dim_names]

    def local_shape(self, global_shape: Sequence[int]) -> Tuple[int, ...]:
        """The shape of one device's block."""
        sizes = _axis_sizes(self.mesh)
        out = list(global_shape)
        for i, e in enumerate(self.spec):
            for a in entry_axes(e):
                out[i] //= sizes[a]
        return tuple(out)

    def local_block(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's block of the global tensor ``x`` (a view): each
        dimension cut by the rank's coordinate on its axes, major first."""
        sizes = _axis_sizes(self.mesh)
        for dim, e in enumerate(self.spec):
            for a in entry_axes(e):
                size = x.shape[dim] // sizes[a]
                x = x.narrow(dim, self.mesh.get_local_rank(a) * size, size)
        return x

    def block_bounds(self, global_shape: Sequence[int]
                     ) -> Tuple[Tuple[int, int], ...]:
        """``(start, size)`` of this rank's block in each dimension of a
        tensor of ``global_shape`` (the ranges ``local_block`` cuts).
        A dimension that its axes do not divide raises, as the
        reference's ``device_put`` under a ``NamedSharding`` does."""
        sizes = _axis_sizes(self.mesh)
        out = []
        for dim, n in enumerate(global_shape):
            e = self.spec[dim] if dim < len(self.spec) else None
            start = 0
            for a in entry_axes(e):
                if n % sizes[a]:
                    raise ValueError(
                        f"{self!r}: dimension {dim} of shape "
                        f"{tuple(global_shape)} is not divisible by the "
                        f"{sizes[a]} shards of mesh axis {a!r}")
                n //= sizes[a]
                start += self.mesh.get_local_rank(a) * n
            out.append((start, n))
        return tuple(out)

    def dtensor(self, block: torch.Tensor, global_shape: Sequence[int]):
        """This rank's ``block`` of a ``global_shape`` tensor as a
        ``DTensor`` on the mesh (the counterpart of a sharded
        ``jax.Array``).  A dimension split over several mesh axes must
        name them in the mesh's order (major first), the one order a
        DTensor placement list can express."""
        from torch.distributed.tensor import DTensor
        names = list(self.mesh.mesh_dim_names)
        for e in self.spec:
            order = [names.index(a) for a in entry_axes(e)]
            if order != sorted(order):
                raise ValueError(f"{self!r}: axes {e} are not in the "
                                 f"mesh's order {tuple(names)}")
        stride, acc = [], 1
        for n in reversed(tuple(global_shape)):
            stride.insert(0, acc)
            acc *= n
        return DTensor.from_local(block, self.mesh, self.placements(),
                                  run_check=False,
                                  shape=torch.Size(global_shape),
                                  stride=tuple(stride))

    def check_device(self, device: torch.device):
        """A block lives on a device of the mesh's type: no silent
        fallback to another."""
        if self.mesh.device_type != device.type:
            raise ValueError(f"{self!r} is on a {self.mesh.device_type!r} "
                             f"mesh, not on {device}")

    def distribute(self, x: torch.Tensor, device: torch.device,
                   dtype: Optional[torch.dtype] = None):
        """This rank's block of the whole tensor ``x`` (on the host),
        copied to ``device`` (cast to ``dtype``), as a ``DTensor`` of
        ``x``'s shape."""
        self.check_device(device)
        block = x
        for d, (start, n) in enumerate(self.block_bounds(x.shape)):
            block = block.narrow(d, start, n)
        block = block.to(device=device, dtype=dtype or x.dtype, copy=True)
        return self.dtensor(block.contiguous(), x.shape)

    def local_bytes(self, global_shape: Sequence[int],
                    dtype: torch.dtype) -> int:
        """The bytes of one device's block of a ``dtype`` tensor."""
        n = 1
        for d in self.local_shape(global_shape):
            n *= d
        return n * torch.empty((), dtype=dtype).element_size()


# ---------------------------------------------------------------------------
# Resolution
# ---------------------------------------------------------------------------

FALLBACK_LOG: list = []  # (context, dim_name, dim_size, candidate, reason)


class _Active(threading.local):
    def __init__(self):
        self.mesh = None
        self.rules: Optional[Rules] = None
        self.context: str = ""


_ACTIVE = _Active()


@contextlib.contextmanager
def activate(mesh, rules: Rules, context: str = ""):
    """Make (mesh, rules) visible to ``constrain`` inside model code."""
    prev = (_ACTIVE.mesh, _ACTIVE.rules, _ACTIVE.context)
    _ACTIVE.mesh, _ACTIVE.rules, _ACTIVE.context = mesh, rules, context
    try:
        yield
    finally:
        _ACTIVE.mesh, _ACTIVE.rules, _ACTIVE.context = prev


def active_mesh():
    """The mesh of the innermost ``activate``, or ``None``."""
    return _ACTIVE.mesh


def resolve_spec(
    dims: Sequence[int],
    names: Sequence[Optional[str]],
    mesh,
    rules: Rules,
    context: str = "",
) -> PartitionSpec:
    """Resolve logical dimension names to a PartitionSpec for ``mesh``."""
    assert len(dims) == len(names), (dims, names)
    used: set = set()
    spec = []
    axis_sizes = _axis_sizes(mesh)
    for dim, name in zip(dims, names):
        chosen: Candidate = None
        if name is not None:
            for cand in rules.get(name, (None,)):
                if cand is None:
                    chosen = None
                    break
                if any(a not in axis_sizes for a in cand):
                    continue            # axis absent on this mesh (e.g. "pod")
                if any(a in used for a in cand):
                    continue            # axis already used by another dim
                size = 1
                for a in cand:
                    size *= axis_sizes[a]
                if dim % size != 0:
                    FALLBACK_LOG.append((context, name, dim, cand, "indivisible"))
                    continue
                chosen = cand
                break
        if chosen is None:
            spec.append(None)
        else:
            used.update(chosen)
            spec.append(chosen if len(chosen) > 1 else chosen[0])
    return PartitionSpec(*spec)


def named_sharding(
    dims: Sequence[int],
    names: Sequence[Optional[str]],
    mesh=None,
    rules: Optional[Rules] = None,
    context: str = "",
) -> Optional[NamedSharding]:
    mesh = mesh or _ACTIVE.mesh
    rules = rules or _ACTIVE.rules
    if mesh is None or rules is None:
        return None
    return NamedSharding(mesh, resolve_spec(dims, names, mesh, rules, context))


def constrain(x: torch.Tensor, *names: Optional[str]) -> torch.Tensor:
    """The reference's ``with_sharding_constraint`` by logical names: the
    spec is resolved under an active mesh (filling the fallback log) and
    ``x`` is returned unmoved (see the module docstring)."""
    if _ACTIVE.mesh is not None and _ACTIVE.rules is not None:
        resolve_spec(x.shape, names, _ACTIVE.mesh, _ACTIVE.rules,
                     _ACTIVE.context)
    return x


def tree_shardings(shape_tree, axes_tree, mesh, rules, context: str = ""):
    """A ``NamedSharding`` for each leaf of a nested dict of tensors (or
    shapes), by the matching leaf of a nested dict of axes tuples; the
    leaves are resolved in the reference's pytree order (keys sorted at
    every level)."""
    def walk(s, a):
        if isinstance(s, dict):
            return {k: walk(s[k], a[k]) for k in sorted(s)}
        return NamedSharding(
            mesh, resolve_spec(tuple(s.shape), a, mesh, rules, context))
    return walk(shape_tree, axes_tree)


def clear_fallback_log():
    FALLBACK_LOG.clear()


def fallback_summary() -> str:
    if not FALLBACK_LOG:
        return "no sharding fallbacks"
    lines = []
    seen = set()
    for ctx, name, dim, cand, reason in FALLBACK_LOG:
        key = (ctx, name, dim, cand)
        if key in seen:
            continue
        seen.add(key)
        lines.append(f"  [{ctx}] {name}={dim} !-> {cand} ({reason})")
    return "sharding fallbacks:\n" + "\n".join(lines)
