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
all-reduce) where the reference had GSPMD insert them.  With a mesh
active, ``constrain`` resolves the tensor's spec — the fallback log fills
exactly as the reference's does while its step is traced — and returns a
plain tensor as it is: a value never depends on placement.  A ``DTensor``
(the dry run places the whole step so: ``place_meta``) is redistributed
to the spec, the reference's ``with_sharding_constraint``; under
``gspmd_partitioning`` the dry run's step is partitioned as the
reference's partitioner does it (weights gathered at use, their
gradients cut into slabs).
"""
from __future__ import annotations

import contextlib
import copy
import math
import threading
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch.overrides import TorchFunctionMode

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


# the meshes with an axis cut into factors (``launch.mesh.factor_axis``):
# mesh -> axis name -> its mesh dims; keyed by the mesh's value, which
# every DeviceMesh object of those ranks and names shares
FACTORED: dict = {}


def factored_axes(mesh) -> Optional[dict]:
    """Mesh-axis name -> mesh dims, of a mesh with a factored axis; None
    for any other."""
    try:
        return FACTORED.get(mesh)
    except TypeError:             # not a DeviceMesh: no hash
        return None


def mesh_axes(mesh) -> dict:
    """Mesh-axis name -> the mesh dims it spans: one each, but for an
    axis cut into factors (``launch.mesh.factor_axis``: "model" as 8 x 2
    dims), its factors', major first."""
    return factored_axes(mesh) or {
        a: (m,) for m, a in enumerate(mesh.mesh_dim_names)}


def _axis_sizes(mesh) -> dict:
    """Mesh-axis name -> size, of a ``DeviceMesh`` or of anything with
    ``mesh_dim_names`` and a ``shape`` (a factored axis: its factors'
    product)."""
    shape = tuple(mesh.shape)
    return {a: math.prod(shape[m] for m in ms)
            for a, ms in mesh_axes(mesh).items()}


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
        out = [Replicate()] * len(self.mesh.mesh_dim_names)
        for a, ms in mesh_axes(self.mesh).items():
            for m in ms:
                if a in dim_of:
                    out[m] = Shard(dim_of[a])
        return out

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
        names = list(mesh_axes(self.mesh))
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


def replicated_on(x: torch.Tensor, mesh):
    """A plain tensor as the ``DTensor`` replicated on ``mesh`` it is
    (every rank holds it whole)."""
    from torch.distributed.tensor import DTensor, Replicate
    return DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def is_distributed(x) -> bool:
    """Whether ``x`` is a ``DTensor`` (the dry run's placed step)."""
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def constrain(x: torch.Tensor, *names: Optional[str]) -> torch.Tensor:
    """The reference's ``with_sharding_constraint`` by logical names: the
    spec is resolved under an active mesh (filling the fallback log); a
    ``DTensor`` is redistributed to it, and a plain tensor is returned as
    the same object (see the module docstring)."""
    if _ACTIVE.mesh is not None and _ACTIVE.rules is not None:
        spec = resolve_spec(x.shape, names, _ACTIVE.mesh, _ACTIVE.rules,
                            _ACTIVE.context)
        if is_distributed(x):
            want = NamedSharding(x.device_mesh, spec).placements()
            if list(x.placements) != want:
                x = x.redistribute(x.device_mesh, want)
            elif _GSPMD.active and x.requires_grad:
                # the constraint holds for the cotangent too (GSPMD's
                # transpose of a sharding constraint is one)
                x = _ConstrainedGrad.apply(x)
    return x


class _ConstrainedGrad(torch.autograd.Function):
    """``x`` as it is, its gradient redistributed to ``x``'s placements:
    the reference's sharding constraint on an output already laid out
    as it asks (an xLSTM block's output, whole over "model"), whose
    cotangent — split over "model" as the residual it came from — GSPMD
    gathers there (its f32[16,4096,768] all-gather "sharding_constraint"
    of xlstm-125m train_4k's backward)."""

    @staticmethod
    def forward(ctx, x):
        ctx.placements = list(x.placements)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        if is_distributed(g) and list(g.placements) != ctx.placements:
            g = g.redistribute(g.device_mesh, ctx.placements)
        return g


def set_slot(buf: torch.Tensor, dim: int, index: int,
             value: torch.Tensor) -> None:
    """``buf``'s entry ``index`` along ``dim`` (size 1 there) set to
    ``value`` in place: a decode step's write into its cache.  A
    ``DTensor`` split along ``dim`` is written by the rank whose block
    holds the entry, into that block, as the reference's partitioned
    dynamic-update-slice does, the entry first made whole along the
    buffer's split on every rank."""
    if not is_distributed(buf) or not any(
            p.is_shard(dim) for p in buf.placements):
        buf.narrow(dim, index, 1).copy_(value)
        return
    from torch.distributed.tensor import DTensor, Replicate
    mesh, block = buf.device_mesh, buf.to_local()
    if not isinstance(value, DTensor):
        value = DTensor.from_local(value, mesh, [Replicate()] * mesh.ndim,
                                   run_check=False)
    # every rank takes the entry whole over the mesh dims that split the
    # buffer along ``dim`` (a collective: gemma2-27b's (1, 1, 16, 128)
    # keys, split over "model" by their heads, all-gathered for the
    # cache whose sequence "model" splits), the one that holds it writes
    want = [Replicate() if p.is_shard(dim) else p for p in buf.placements]
    value = value.redistribute(mesh, want).to_local()
    coord, at = mesh.get_coordinate(), 0
    for m, p in enumerate(buf.placements):
        if p.is_shard(dim):
            at = at * mesh.size(m) + coord[m]
    start = at * block.shape[dim]
    if start <= index < start + block.shape[dim]:
        block.narrow(dim, index - start, 1).copy_(value)


# the logical axes of a weight's FSDP dimension: split over "data" where
# it is stored, gathered where a product uses it
FSDP_AXES = ("embed",)


def fsdp_dims(axes: Sequence[Optional[str]], placements) -> Tuple[int, ...]:
    """The dims of a weight, by its spec's logical ``axes``, that are
    FSDP dims its ``placements`` split."""
    split = {q.dim for q in placements if q.is_shard()}
    return tuple(i for i, a in enumerate(axes)
                 if a in FSDP_AXES and i in split)


def _mesh_group(mesh):
    """A process group over every rank of ``mesh`` (a collective-permute
    across its axes), made once a mesh."""
    import torch.distributed as dist
    group = getattr(mesh, "_every_rank_group", None)
    if group is None:
        group = dist.new_group(mesh.mesh.flatten().tolist())
        mesh._every_rank_group = group
    return group


def _flat_coordinate(mesh, dims, coord=None) -> int:
    """This rank's index over the mesh dims ``dims`` (major first)."""
    coord = mesh.get_coordinate() if coord is None else coord
    at = 0
    for m in dims:
        at = at * mesh.size(m) + coord[m]
    return at


def _move_split(x, a: Tuple[int, ...], b: Tuple[int, ...], placements):
    """``x``'s split moved from the mesh dims ``a`` (one mesh axis: one
    dim, or a factored axis's) to the mesh dims ``b``, whose ranks are
    p >= 1 times ``a``'s — the rank at index i over ``a`` and j over
    ``b`` sends part j mod p of its block (cut in p along the split dim)
    to the rank at j // p over ``a`` and i p + j mod p over ``b``, so
    that the rank at index k over ``b`` holds part k of the dim (p = 1:
    it takes the block of the rank at j over ``a`` and i over ``b``; p
    = 2: an xLSTM residual's "model" split moved to "pod" x "data" in
    halves, the reference's f32[1,1,24] of xlstm-125m long_500k) — as
    ``placements``: one collective-permute, issued as the all-to-all
    that sends the whole part to one rank (``launch.cost_analysis``
    counts it as a collective-permute)."""
    from torch.distributed import _functional_collectives as funcol
    from torch.distributed.tensor import DTensor
    mesh = x.device_mesh
    p = math.prod(mesh.size(m) for m in b) // math.prod(mesh.size(m)
                                                         for m in a)
    coord = list(mesh.get_coordinate())
    i, j = _flat_coordinate(mesh, a, coord), _flat_coordinate(mesh, b, coord)
    for dims, v in ((a, j // p), (b, i * p + j % p)):
        for m in reversed(dims):
            coord[m], v = v % mesh.size(m), v // mesh.size(m)
    flat = _flat_coordinate(mesh, range(mesh.ndim), coord)
    block = x.to_local()
    if p > 1:
        d = x.placements[a[0]].dim
        width = block.shape[d] // p
        block = block.narrow(d, (j % p) * width, width)
    block = block.contiguous()
    splits = [0] * mesh.size()
    splits[flat] = block.shape[0]
    moved = funcol.all_to_all_single(block, splits, splits, _mesh_group(mesh))
    return DTensor.from_local(moved, mesh, placements, run_check=False,
                              shape=x.shape, stride=x.stride())


def _use_axes(p, dims) -> Optional[Tuple[Tuple[int, ...], Tuple[int, ...]]]:
    """The mesh dims (stored, use) between which a weight's FSDP split
    moves for its use: where its one FSDP dim is split over one mesh
    axis (all of its mesh dims) and the weight is replicated over
    another axis of that size.  None: it stays where it is stored."""
    mesh, stored = p.device_mesh, list(p.placements)
    axes = list(mesh_axes(mesh).values())
    split = [ms for ms in axes
             if any(stored[m].is_shard() and stored[m].dim in dims
                    for m in ms)]
    if len(dims) != 1 or len(split) != 1 \
            or sum(q.is_shard(dims[0]) for q in stored) != len(split[0]) \
            or not all(stored[m].is_shard(dims[0]) for m in split[0]):
        return None
    size = math.prod(mesh.size(m) for m in split[0])
    b = next((ms for ms in axes
              if all(stored[m].is_replicate() for m in ms)
              and math.prod(mesh.size(m) for m in ms) == size), None)
    return None if b is None else (split[0], b)


class _Gather(torch.autograd.Function):
    """A weight's FSDP dims gathered for an op that uses it, as the
    reference's partition of gemma2-2b train_4k does before each product
    (its HLO: ``all-gather`` before every ``dot_general`` of a weight).
    Where the weight is replicated over another mesh axis of the FSDP
    axis's size (``_use_axes``), its split first moves there (a
    collective-permute: the attention projections' f32[144,8,256]
    blocks, whose heads cannot split over "model") and is gathered
    there, or only moved (``gather=False``: an embedding lookup); that
    axis is then its use axis, over which its gradient is computed in
    slabs (``weight_grad_slab``).  ``use``: the mesh dims to move it to
    instead, whose ranks are p >= 1 times the stored axis's, in parts
    (``_move_split``; the router's contraction over "pod" x "model",
    ``_contract_split``), the gather there one over them at once
    (``_whole_over``).  Backward, as that HLO reduces the
    gradient: its partial sums all-reduced (XLA's CPU pipeline forms no
    reduce-scatter), moved back to the stored axis or sliced to it.  A
    gradient gathered where it is stored and partial over more axes
    than the FSDP one (the batch over "pod" x "data" on the 2x16x16
    mesh) is reduced over the FSDP axis and sliced to its block first,
    and that block then over the rest (the reference's all-reduce over
    "data" of each FFN weight's gathered gradient, then over "pod" of
    its shard)."""

    @staticmethod
    def forward(ctx, p, dims, gather: bool, use=None):
        from torch.distributed.tensor import Replicate
        mesh, stored = p.device_mesh, list(p.placements)
        ctx.stored, ctx.shape, ctx.use = stored, tuple(p.shape), None
        ctx.fsdp = [m for m, q in enumerate(stored)
                    if q.is_shard() and q.dim in dims]
        axes = _use_axes(p, dims)
        if axes is not None and use is not None:
            axes = (axes[0], tuple(use))
        if axes is not None:
            a, b = axes
            moved = list(stored)
            for m in a:
                moved[m] = Replicate()
            for m in b:
                moved[m] = stored[a[0]]
            p = _move_split(p, a, b, moved)
            ctx.use, ctx.axis, ctx.dim, ctx.moved = b, a, dims[0], moved
        if not gather:
            return p
        if ctx.use is not None and len(ctx.use) > 1:
            return _whole_over(p, ctx.use)
        return p.redistribute(mesh, [
            Replicate() if q.is_shard() and q.dim in dims else q
            for q in p.placements])

    @staticmethod
    def backward(ctx, g):
        from torch.distributed.tensor import Replicate
        mesh = g.device_mesh
        partial = {m for m, q in enumerate(g.placements) if q.is_partial()}
        if ctx.use is None and ctx.fsdp and set(ctx.fsdp) < partial:
            g = g.redistribute(mesh, [Replicate() if m in ctx.fsdp else q
                                      for m, q in enumerate(g.placements)])
            g = g.redistribute(mesh, [ctx.stored[m] if m in ctx.fsdp else q
                                      for m, q in enumerate(g.placements)])
        g = g.redistribute(mesh, [Replicate() if q.is_partial() else q
                                  for q in g.placements])
        if ctx.use is not None and list(g.placements) == ctx.moved:
            g = _move_split(g, ctx.use, ctx.axis, ctx.stored)
        return g.redistribute(mesh, ctx.stored), None, None, None


def at_use(x, gather: bool = True, use=None):
    """``x`` as an op uses it: a placed weight (``place_meta``) with its
    FSDP dims gathered (or, ``gather=False``, only moved to its use
    axis, or to the mesh dims ``use``), anything else as it is.
    ``gspmd_partitioning`` reads every weight so; a caller that takes a
    weight's block itself (``DTensor.to_local``) calls it first."""
    dims = getattr(x, "fsdp_dims", ())
    if not dims or not (gather or _use_axes(x, dims)):
        return x
    return _Gather.apply(x, dims, gather, use)


def _funcol():
    from torch.distributed import _functional_collectives as funcol
    return funcol


def _all_gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The blocks of ``group``'s ranks concatenated along ``dim``, in rank
    order."""
    funcol = _funcol()
    # all_gather_single is the newer name of all_gather_tensor
    gather = getattr(funcol, "all_gather_single", funcol.all_gather_tensor)
    out = funcol.wait_tensor(gather(x.movedim(dim, 0).contiguous(), 0,
                                    group))
    return out.movedim(0, dim)


class _ShardIn(torch.autograd.Function):
    """This rank's block of a global (replicated) tensor by ``sharding``
    (a ``shard_map`` in_spec).  The backward assembles the global
    tensor's whole gradient on every rank: the blocks all-gathered along
    their dims, and the partial sums of ``partial_over`` (the axes whose
    ranks each computed a part of this block's gradient) all-reduced."""

    @staticmethod
    def forward(ctx, x, sharding, partial_over):
        ctx.args = (sharding, partial_over)
        return sharding.local_block(x).contiguous()

    @staticmethod
    def backward(ctx, g):
        sharding, partial_over = ctx.args
        mesh, funcol = sharding.mesh, _funcol()
        for dim, e in reversed(list(enumerate(sharding.spec))):
            for a in reversed(entry_axes(e)):
                g = _all_gather(g, dim, mesh.get_group(a))
        for a in partial_over:
            g = funcol.wait_tensor(funcol.all_reduce(g, "sum",
                                                     mesh.get_group(a)))
        return g, None, None


class _GatherRows(torch.autograd.Function):
    """``out_specs=P("data")`` (``rows``): every rank's rows all-gathered
    over "data" (dim 0); every rank then holds the global output and its
    whole cotangent, so the backward keeps this rank's block of it."""

    @staticmethod
    def forward(ctx, y, rows):
        ctx.rows = rows
        return _all_gather(y, 0, rows.mesh.get_group("data"))

    @staticmethod
    def backward(ctx, g):
        return ctx.rows.local_block(g), None


class ShardMap:
    """The reference's ``shard_map`` over the mesh for a call whose token
    stream is ``like``, as the port holds a step's tensors.  On a real
    mesh (plain tensors, the active mesh's) every rank holds the whole of
    each: it routes every token, cuts its block of each argument by the
    in_spec (``_ShardIn``) and all-gathers the rows of the result
    (``_GatherRows``), each with the backward that leaves every rank the
    whole gradient of every global input.  In the dry run (``DTensor``s
    on ``like``'s mesh, one rank's share of the step) a rank holds its
    block of each already: a placed weight is read at use and
    redistributed to the in_spec, and a result is the ``DTensor`` its
    blocks make."""

    def __init__(self, like: torch.Tensor):
        self.placed = is_distributed(like)
        self.mesh = like.device_mesh if self.placed else _ACTIVE.mesh
        # the mesh dims that split the tokens
        self.split = [q.is_shard() for q in like.placements] \
            if self.placed else []

    def size(self, axis: str) -> int:
        return _axis_sizes(self.mesh).get(axis, 1)

    def groups(self, spec: PartitionSpec, dim: int) -> list:
        """The process groups of the mesh dims that split ``dim`` of an
        argument of in_spec ``spec``, major first."""
        return [self.mesh.get_group(m) for m, q in enumerate(
            NamedSharding(self.mesh, spec).placements()) if q.is_shard(dim)]

    def _local(self, t, placements=None):
        """A placed ``t``'s block (redistributed to ``placements``); its
        gradient is partial over the mesh dims that split the tokens but
        not ``t``."""
        from torch.distributed.tensor import Partial
        t = at_use(t)
        if placements is not None and list(t.placements) != placements:
            t = t.redistribute(self.mesh, placements)
        return t.to_local(grad_placements=[
            Partial() if q.is_replicate() and split else q
            for q, split in zip(t.placements, self.split)])

    def block(self, t: torch.Tensor, spec: PartitionSpec,
              partial_over: Tuple[str, ...] = ()) -> torch.Tensor:
        """This rank's block of the argument ``t`` by the in_spec ``spec``;
        ``partial_over``: the axes whose ranks each compute a part of the
        block's gradient."""
        if is_distributed(t):
            return self._local(t, NamedSharding(self.mesh,
                                                spec).placements())
        return _ShardIn.apply(t, NamedSharding(self.mesh, spec),
                              partial_over)

    def rows_out(self, y: torch.Tensor, spec: PartitionSpec,
                 like: torch.Tensor) -> torch.Tensor:
        """The result from each rank's block ``y`` by the out_spec
        ``spec`` (rows over "data"): all-gathered on a real mesh; the
        ``DTensor`` of ``like``'s placements in the dry run."""
        if not self.placed:
            return _GatherRows.apply(y, NamedSharding(self.mesh, spec))
        from torch.distributed.tensor import DTensor
        return DTensor.from_local(y, self.mesh, like.placements,
                                  run_check=False)


def _row_split(x) -> Optional[Tuple[int, ...]]:
    """The mesh dims that split dim 0 of the DTensor ``x`` (major first),
    where nothing else is split or partial; else None."""
    from torch.distributed.tensor import Shard
    over = tuple(m for m, q in enumerate(x.placements) if q.is_shard())
    if any(x.placements[m] != Shard(0) for m in over) \
            or any(q.is_partial() for q in x.placements):
        return None
    return over


def _send_block(block, mesh, over, to: int, frm: int):
    """``block`` sent to the rank at index ``to`` over the mesh dims
    ``over``, the one from index ``frm`` received: one
    collective-permute (its whole block to one rank)."""
    send, recv = [0] * mesh.size(), [0] * mesh.size()
    send[_rank_along(mesh, over, to)] = block.shape[0]
    recv[_rank_along(mesh, over, frm)] = block.shape[0]
    return _funcol().wait_tensor(_funcol().all_to_all_single(
        block.contiguous(), recv, send, _mesh_group(mesh)))


def rows_in_chunks(x: torch.Tensor, r: int, nc: int) -> torch.Tensor:
    """``x`` (n_rows, ...) viewed as (r, nc, ...): the chunked MoE's rows,
    chunk c the rows c, nc + c, ...  Under ``gspmd_partitioning``, where
    the rows are split over more ranks than ``r`` (256 rows over the 32
    of "pod" x "data", r = 16: GSPMD's view cuts "data" 8 x 2, and its
    scan then takes each chunk's rows over "data" alone), laid out as
    the reference's scan reads them (``_RowsInChunks``): each chunk's
    rows over the minor mesh dims that split ``r`` ("data"), the chunks
    whole, the major mesh dims ("pod") replicating them.  Elsewhere the
    view (DTensor places it)."""
    if _GSPMD.active and is_distributed(x):
        over = _row_split(x)
        if over:
            mesh = x.device_mesh
            n = math.prod(mesh.size(m) for m in over)
            keep = next((over[i:] for i in range(len(over))
                         if math.prod(mesh.size(m) for m in over[i:]) == r),
                        None)
            if n > r and keep and nc == n // r * (x.shape[0] // n):
                return _RowsInChunks.apply(x, r, nc, over, len(over)
                                           - len(keep))
    return x.reshape(r, nc, *x.shape[1:])


class _RowsInChunks(torch.autograd.Function):
    """The rows (split over the mesh dims ``over``, ``f`` major ones of
    them left to replicate the chunks) laid out as (r, nc, ...) for the
    chunk loop, as the reference's partition moves them before its scan
    (deepseek-v3-671b prefill_32k on the 2x16x16 mesh: an f32[8,1,4096,
    7168] collective-permute and an f32[16,1,4096,7168] all-gather over
    "pod" a layer): the rank at index k over ``over`` holds row k // p
    of each chunk, for chunks (k % p) B .. (k % p + 1) B (p ranks of
    the major dims, B rows a rank); it sends them to the rank at that
    index over the major dims and k // p over the minor ones (one
    collective-permute), and the p parts are all-gathered over the
    major dims.  Backward: the gradient left in the chunk loop's layout,
    the rows split over the minor dims alone (nothing moves), as the
    reference's partition assembles the MoE input's gradient there
    (deepseek-v3-671b train_4k's backward); the ops that meet it with
    a tensor in the rows' own layout move one of the two
    (``rows_regrouped_pointwise``)."""

    @staticmethod
    def forward(ctx, x, r, nc, over, f):
        from torch.distributed.tensor import Replicate, Shard
        mesh = x.device_mesh
        # the inverse of ``_RowsRegrouped``'s permute
        back, to, _, _ = _regrouping(mesh, over, f)
        block = _send_block(x._local_tensor, mesh, over, to, back)
        parts = [q if m not in over else Shard(1) if m in over[:f]
                 else Shard(0) for m, q in enumerate(x.placements)]
        y = _placed(block.reshape(1, -1, *block.shape[1:]), mesh, parts,
                    (r, nc) + tuple(x.shape[1:]))
        ctx.args = (list(x.placements), tuple(x.shape), parts, over, f)
        return y.redistribute(mesh, [Replicate() if m in over[:f] else q
                                     for m, q in enumerate(parts)])

    @staticmethod
    def backward(ctx, g):
        from torch.distributed.tensor import Replicate
        placements, shape, parts, over, f = ctx.args
        mesh = g.device_mesh
        chunks = [Replicate() if m in over[:f] else q
                  for m, q in enumerate(parts)]
        if list(g.placements) != chunks:
            g = g.redistribute(mesh, chunks)
        block = g._local_tensor
        return (_placed(block.reshape(-1, *block.shape[2:]), mesh,
                        [Replicate() if m in over[:f] else q
                         for m, q in enumerate(placements)], shape),
                None, None, None, None)


def rows_split_as(x: torch.Tensor, like: torch.Tensor,
                  dim: int = 0) -> torch.Tensor:
    """``x``, whole on every rank (positions made from an iota), its dim
    ``dim`` split as the ``DTensor`` ``like`` splits its rows (dim 0),
    every other mesh dim replicating it: GSPMD gives an iota the split
    of the ops it meets, so the reference's attention mask and rotary
    angles hold the rank's own rows, where a plain tensor joins a
    ``DTensor`` whole (``implicit_replication``) and the mask built from
    it carries the global batch ((32, 32768, 32768) bool blocks on every
    rank of recurrentgemma-9b x prefill_32k).  Nothing moves: each rank
    keeps its part.  ``x`` as it is where it is a ``DTensor`` already or
    ``like`` is a plain tensor."""
    if is_distributed(x) or not is_distributed(like):
        return x
    from torch.distributed.tensor import DTensor, Replicate, Shard
    mesh = like.device_mesh
    want = [Shard(dim) if q.is_shard(0) else Replicate()
            for q in like.placements]
    return DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                              run_check=False).redistribute(mesh, want)


def rows_laid_out_as(x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``x`` (a DTensor of ``like``'s shape) placed as ``like`` is: the
    chunked MoE's rows, split over "data" alone where the batch is split
    over ("pod", "data"), rejoined as the batch is split.  Under
    ``gspmd_partitioning``, where ``like`` splits dim 0 over mesh dims
    whose minor ones split ``x`` there and whose major ones replicate
    it, as the reference's scan leaves them (``_RowsRegrouped``); else
    by way of the whole: DTensor's own move between the two runs
    through a strided split whose every redistribution its planner
    sizes by splitting an index tensor of the whole dim (tens of
    seconds a walk); the whole is an all-gather, then a slice.  ``x`` as
    it is where the placements agree or ``x`` is a plain tensor."""
    from torch.distributed.tensor import Replicate
    if not (is_distributed(x) and is_distributed(like)) \
            or list(x.placements) == list(like.placements):
        return x
    mesh = x.device_mesh
    if _GSPMD.active:
        over, mine = _row_split(like), _row_split(x)
        f = len(over or ()) - len(mine or ())
        if over and mine and f > 0 and over[f:] == mine \
                and x.shape[0] % math.prod(mesh.size(m) for m in over) == 0:
            return _RowsRegrouped.apply(x, list(like.placements), over, f)
    return x.redistribute(mesh, [Replicate()] * mesh.ndim).redistribute(
        mesh, like.placements)


class _RowsRegrouped(torch.autograd.Function):
    """Rows split over the minor mesh dims of ``over`` and replicated
    over its ``f`` major ones, split over all of ``over`` (major first),
    as the reference's chunk loop leaves its output (deepseek-v3-671b
    prefill_32k on the 2x16x16 mesh: each chunk's combined rows, an
    f32[1,4097,7168] collective-permute a chunk): the rank at index i
    over the major dims and j over the minor ones sends its whole block
    to the rank at index j p + i over ``over`` (p ranks of the major
    dims), which keeps its part of it.  In a rematerialized block's
    recompute nothing moves: no gradient reads the result, and the
    reference's recompute leaves the permute out.  Backward
    (``_into_chunks``): the gradient's blocks all-gathered over runs of
    p ranks of ``over`` and each run's rows sent back, so that every
    copy of the chunk loop's rows takes its gradient whole (the
    reference's f32[16,1,4096,7168] all-gather over pairs of "data"
    ranks a layer before its chunks' collective-permutes, in
    deepseek-v3-671b train_4k's backward)."""

    @staticmethod
    def forward(ctx, x, placements, over, f):
        mesh = x.device_mesh
        to, frm, part, p = _regrouping(mesh, over, f)
        block = x._local_tensor
        if torch._C._current_graph_task_id() == -1:
            block = _send_block(block, mesh, over, to, frm)
        b = block.shape[0] // p
        ctx.args = (list(x.placements), over, f)
        return _placed(block.narrow(0, part * b, b), mesh, placements,
                       x.shape)

    @staticmethod
    def backward(ctx, g):
        placements, over, f = ctx.args
        mesh = g.device_mesh
        p = math.prod(mesh.size(m) for m in over[:f])
        block = _all_gather(g._local_tensor, 0, _dims_group(mesh, over, p))
        return (_placed(_into_chunks(block, mesh, over, f), mesh,
                        placements, g.shape), None, None, None)


def _into_chunks(block, mesh, over, f: int):
    """This rank's ``block`` of the rows of its run of p consecutive
    ranks of the mesh dims ``over`` (major first; p ranks of the ``f``
    major ones), gathered over the run, as the chunk loop takes them
    (``_RowsRegrouped``'s layout: split over the minor dims, replicated
    over the major ones): sent to the rank at this one's index within
    its run over the major dims and the run's index over the minor ones
    (one collective-permute), the inverse of ``_RowsRegrouped``'s."""
    to, frm, _, _ = _regrouping(mesh, over, f)
    return _send_block(block, mesh, over, frm, to)


def _regrouping(mesh, over, f: int):
    """``_RowsRegrouped``'s forward permute for this rank: the index over
    ``over`` it sends to and the one it receives from, the part of the
    received block it keeps, and the ranks p of the major dims."""
    major, minor = over[:f], over[f:]
    p = math.prod(mesh.size(m) for m in major)
    n = math.prod(mesh.size(m) for m in minor)
    k = _flat_coordinate(mesh, over)
    to = _flat_coordinate(mesh, minor) * p + _flat_coordinate(mesh, major)
    return to, (k % p) * n + k // p, k % p, p


def grad_in_chunks(x: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """``x``, the chunked MoE's input, for a product beside its chunk
    loop (the shared expert): under ``gspmd_partitioning``, where
    ``rows`` (``rows_in_chunks`` of ``x``'s rows) took the chunk loop's
    layout (``_RowsInChunks``), ``x`` marked (``_GradInChunks``) so that
    the products of it make their input gradient in that layout too
    (``product_into_chunks``), where the loop leaves its own; ``x`` as
    it is elsewhere."""
    node = getattr(rows, "grad_fn", None)
    if not _GSPMD.active or type(node).__name__ != "_RowsInChunksBackward":
        return x
    *_, over, f = node.args
    return _GradInChunks.apply(x, over, f)


class _GradInChunks(torch.autograd.Function):
    """``x`` as it is, its node naming the mesh dims ``over`` that split
    its rows and the ``f`` major ones of them that the chunk loop's
    layout leaves replicated (``grad_in_chunks``); its gradient, the
    sum of its uses' in that layout, passed on."""

    @staticmethod
    def forward(ctx, x, over, f):
        ctx.over, ctx.f, ctx.shape = over, f, tuple(x.shape)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def product_into_chunks(func, args):
    """The input gradient of a product of a marked input
    (``grad_in_chunks``: the shared expert's up and gate projections of
    the chunked MoE's input), as the reference's partition makes it:
    the output's gradient all-gathered over runs of p ranks of the
    rows' mesh dims (16 rows a rank of the 8), its product with the
    weight on those rows, the partial sums all-reduced over the mesh
    dims that split the contraction, and the rows sent into the chunk
    loop's layout (``_into_chunks``), where the rest of the input's
    gradient is (deepseek-v3-671b train_4k on the 2x16x16 mesh, a layer:
    two f32[16,4096,128] all-gathers over pairs of "data" ranks, an
    all-reduce of two f32[16,4096,7168] over "model", two
    collective-permutes of them).  The product of ``mm`` under
    autograd's ``MmBackward0`` whose first operand came from a marked
    input, the output's gradient by the weight; None for any other
    op."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    if not _GSPMD.active or func is not torch.ops.aten.mm.default:
        return None
    node = torch._C._current_autograd_node()
    if type(node).__name__ != "MmBackward0":
        return None
    src = node.next_functions[0][0]
    while src is not None and type(src).__name__ in _VIEW_NODES:
        src = src.next_functions[0][0]
    g, wt = args
    if type(src).__name__ != "_GradInChunksBackward" \
            or not (isinstance(g, DTensor) and isinstance(wt, DTensor)) \
            or g.shape[0] != math.prod(src.shape[:-1]) \
            or wt.shape[1] != src.shape[-1]:
        return None
    mesh, over, f = g.device_mesh, src.over, src.f
    k = tuple(m for m, q in enumerate(g.placements) if q.is_shard(1))
    if any(not g.placements[m].is_shard(0) for m in over) \
            or any(not wt.placements[m].is_shard(0) for m in k) \
            or any(not (m in over or m in k) and not q.is_replicate()
                   for m, q in enumerate(g.placements)) \
            or any(m not in k and not q.is_replicate()
                   for m, q in enumerate(wt.placements)):
        return None
    p = math.prod(mesh.size(m) for m in over[:f])
    rows = _all_gather(g._local_tensor, 0, _dims_group(mesh, over, p))
    dx = torch.mm(rows, wt._local_tensor)
    if k:
        dx = _funcol().wait_tensor(_funcol().all_reduce(
            dx, "sum", _dims_group(mesh, k)))
    dx = _into_chunks(dx, mesh, over, f)
    return _placed(dx, mesh, [Shard(0) if m in over[f:] else Replicate()
                              for m in range(mesh.ndim)],
                   (g.shape[0], wt.shape[1]))


def _regrouped_pair(args):
    """For two DTensors of one rank whose dim 0 (and no other dim) one
    splits over the mesh dims ``over`` (major first) and the other over
    its minor ones alone, replicated over the ``f`` major ones — the
    chunk loop's layout of the rows beside their own
    (``rows_in_chunks``) —: (the index of the latter, ``over``, ``f``);
    else None."""
    from torch.distributed.tensor import DTensor
    if len(args) < 2 or not all(isinstance(a, DTensor) for a in args[:2]):
        return None
    a, b = args[:2]
    if a.ndim != b.ndim or not a.ndim or a.shape[0] != b.shape[0]:
        return None
    sa, sb = _row_split(a), _row_split(b)
    for i, (mine, over) in enumerate(((sa, sb), (sb, sa))):
        if mine and over and len(over) > len(mine) \
                and over[len(over) - len(mine):] == mine:
            return i, over, len(over) - len(mine)
    return None


def involuntary_full_remat(func, args):
    """XLA's involuntary full rematerialization, reproduced because the
    dry run is held to the reference's compiled step: the product of a
    norm's output gradient and its normalized input, which the norm's
    scale gradient sums over the rows, where the gradient arrives in
    the chunk loop's layout (``rows_in_chunks``: the rows over "data",
    replicated over "pod") and the input in the rows' own (over "pod" x
    "data"), the MoE's norm of deepseek-v2-236b and v3-671b train_4k on
    the 2x16x16 mesh.  XLA's partitioner finds no partition of the
    product the two agree on, logs an "involuntary full
    rematerialization", and gathers both whole on every device (an
    f32[256,4096,7168] all-gather over "pod" x "data" and one over
    "data", a layer); the product and its sum run whole.  Here: a
    ``mul`` of two DTensors of one shape in those two layouts
    (``_regrouped_pair``), in autograd's ``MulBackward0`` of a product
    with a vector (the norm's scale), both gathered whole
    (``_whole_over``).  None for any other op: the gradient of a norm
    whose output's gradient comes back in its input's layout (every
    other cell) takes DTensor's and ``reduced_product``'s partition."""
    if not _GSPMD.active or func is not torch.ops.aten.mul.Tensor:
        return None
    node = torch._C._current_autograd_node()
    pair = _regrouped_pair(args)
    if type(node).__name__ != "MulBackward0" or pair is None \
            or args[0].shape != args[1].shape:
        return None
    # the factors' shapes, from the nodes that take their gradients (a
    # rematerialized block's saved tensors unpack once)
    if not any(len(getattr(fn, "_input_metadata", ())) > k
               and len(fn._input_metadata[k].shape) == 1
               for fn, k in node.next_functions):
        return None
    i, over, f = pair
    ops = list(args[:2])
    ops[i] = _whole_over(ops[i], over[f:])
    ops[1 - i] = _whole_over(ops[1 - i], over)
    return func(*ops)


def rows_regrouped_pointwise(func, args):
    """An elementwise ``mul`` or ``add`` in the backward whose two
    operands split their rows in the chunk loop's layout and in the
    rows' own (``_regrouped_pair``; the MoE input's gradient meeting the
    norm's input and statistics), as the reference's partition runs it:
    the operand whose move costs less goes to the other's layout — the
    chunk loop's (half of its rows a rank) by a slice and one
    collective-permute (``_out_of_chunks``), the rows' own by a
    collective-permute and an all-gather over the major dims
    (``_RowsInChunks``'s) — and the op runs on the blocks (in
    deepseek-v3-671b train_4k's backward a layer: the norm's f32[8,4096,1]
    statistic permuted and all-gathered over "pod" into the chunk
    loop's layout, two f32[8,4096,7168] gradients sliced and permuted
    out of it).  None for any other op."""
    if not _GSPMD.active or func not in (torch.ops.aten.mul.Tensor,
                                         torch.ops.aten.add.Tensor) \
            or torch._C._current_autograd_node() is None:
        return None
    pair = _regrouped_pair(args)
    if pair is None:
        return None
    i, over, f = pair
    ops = list(args[:2])
    c, b = ops[i], ops[1 - i]
    mesh = c.device_mesh
    p = math.prod(mesh.size(m) for m in over[:f])
    if c._local_tensor.numel() // p <= b._local_tensor.numel() * (1 + p):
        ops[i] = _placed(_out_of_chunks(c._local_tensor, mesh, over, f),
                         mesh, b.placements, c.shape)
    else:
        to, frm, _, _ = _regrouping(mesh, over, f)
        block = _send_block(b._local_tensor, mesh, over, frm, to)
        block = _all_gather(block, 0, _dims_group(mesh, over[:f]))
        ops[1 - i] = _placed(block, mesh, c.placements, b.shape)
    return func(*ops, *args[2:])


def _out_of_chunks(block, mesh, over, f: int):
    """This rank's ``block`` of rows in the chunk loop's layout
    (``_RowsRegrouped``'s) as the rows' own split over ``over`` takes
    them: the part of it at this rank's index over the major dims
    sliced off and sent where ``_RowsRegrouped`` sends the whole (one
    collective-permute of half the rows, where p = 2)."""
    to, frm, _, p = _regrouping(mesh, over, f)
    b = block.shape[0] // p
    part = _flat_coordinate(mesh, over[:f])
    return _send_block(block.narrow(0, part * b, b), mesh, over, to, frm)


def reduced_product(func, out):
    """A product's (``mm``, ``bmm``) partial sums all-reduced where it
    makes them, under ``gspmd_partitioning``, and so a broadcast's
    gradient (its sum over the broadcast dims: MLA's key-rope gradient
    summed over the heads, into the latent's) and a norm's (the
    gradient of its (..., 1) scale, summed over xlstm-125m's d_model
    split over "model"; of its (d_model,) scale and bias, summed over
    the tokens, over every mesh axis that splits them at once: the
    reference's all-reduce over "pod" x "data" in the backward of each
    norm of whisper-base train_4k): GSPMD reduces a partial sum before
    another op consumes it, where DTensor would carry it on through
    linear ops (a norm's backward, the latent's product, the gradient's
    cast) and reduce it at each later consumer (the optimizer's three
    reads of a norm's gradient)."""
    from torch.distributed.tensor import DTensor, Replicate
    name = func.__name__.split(".")[0]
    if name == "sum":
        node = torch._C._current_autograd_node()
        kind = type(node).__name__
        # a broadcast's gradient; a product's with an operand that a
        # feature dim broadcasts (a norm's (..., 1) scale), summed over
        # that dim; or a product's or a sum's with a vector operand that
        # every leading dim broadcasts (a norm's scale or bias), summed
        # over them
        if not (kind == "ExpandBackward0"
                or kind == "MulBackward0" and out.ndim > 1
                and out.shape[-1] == 1
                or kind in ("MulBackward0", "AddBackward0")
                and out.ndim > 1 and math.prod(out.shape[:-1]) == 1):
            return out
    if not _GSPMD.active or _GSPMD.keep_partial \
            or name not in ("mm", "bmm", "sum") \
            or not isinstance(out, DTensor) \
            or not any(q.is_partial() for q in out.placements) \
            or _reduced_in_stages(out):
        return out
    return out.redistribute(out.device_mesh, [
        Replicate() if q.is_partial() else q for q in out.placements])


def _reduced_in_stages(out) -> bool:
    """Whether ``out``, a product's partial sums, is the gradient of a
    weight gathered where it is stored (``_Gather``, no use axis) and
    partial over more mesh dims than its FSDP ones: ``_Gather``'s
    backward reduces it, over the FSDP axis first.  The product is
    autograd's, or ``_RegatheredInput``'s weight gradient (an xLSTM up
    projection's, the tied unembedding's: the reference's all-reduce
    over "data" of f32[768,192], then over "pod" of its f32[48,192]
    block, in xlstm-125m train_4k on the 2x16x16 mesh)."""
    node = torch._C._current_autograd_node()
    if type(node).__name__ not in ("MmBackward0", "BmmBackward0",
                                   "_RegatheredInputBackward"):
        return False
    partial = {m for m, q in enumerate(out.placements) if q.is_partial()}
    for fn, _ in node.next_functions:
        while fn is not None and type(fn).__name__ in _VIEW_NODES:
            fn = fn.next_functions[0][0]
        if fn is not None and type(fn).__name__ == "_GatherBackward" \
                and fn.use is None and fn.fsdp \
                and set(fn.fsdp) < partial \
                and out.numel() == math.prod(fn.shape):
            return True
    return False


# the autograd nodes between a gathered weight and the product using it
# that only view or cast it
_VIEW_NODES = {"ViewBackward0", "UnsafeViewBackward0", "PermuteBackward0",
               "UnsqueezeBackward0", "TransposeBackward0", "TBackward0",
               "ToCopyBackward0", "CloneBackward0", "AliasBackward0",
               "ExpandBackward0"}


def _dims_back(node, shape):
    """Through one of ``_VIEW_NODES`` from its output (of ``shape``) to
    its input: the input's shape and, for each output dim, the input dim
    it is (None: a new or merged one)."""
    name, n = type(node).__name__, len(shape)
    if name in ("ToCopyBackward0", "CloneBackward0", "AliasBackward0"):
        return list(shape), list(range(n))
    if name == "PermuteBackward0":
        dims = [d % n for d in node._saved_dims]
        sizes = [0] * n
        for j, d in enumerate(dims):
            sizes[d] = shape[j]
        return sizes, dims
    if name in ("TransposeBackward0", "TBackward0"):
        d0, d1 = ((node._saved_dim0 % n, node._saved_dim1 % n)
                  if name == "TransposeBackward0" else (0, n - 1))
        perm = list(range(n))
        perm[d0], perm[d1] = d1, d0
        return [shape[p] for p in perm], perm
    if name == "UnsqueezeBackward0":
        d = node._saved_dim % n
        return ([s for j, s in enumerate(shape) if j != d],
                [None if j == d else j - (j > d) for j in range(n)])
    sizes = list(node._saved_self_sym_sizes)
    if name == "ExpandBackward0":
        off = n - len(sizes)
        return sizes, [j - off if j >= off and sizes[j - off] == shape[j]
                       else None for j in range(n)]
    # a view: an output dim is the input dim starting at the same offset
    # with the same extent
    if math.prod(sizes) != math.prod(shape):
        raise ValueError("not this view's output")
    starts = {}
    for i in range(len(sizes)):
        starts.setdefault((math.prod(sizes[:i]), sizes[i]), i)
    return sizes, [starts.get((math.prod(shape[:j]), shape[j]))
                   for j in range(n)]


def _weight_dim(chain, gather, shape):
    """The dim of a product's operand (of ``shape``, reached from the
    ``gather`` node through ``chain``, nearest the product first) that is
    the gathered weight's FSDP dim, or None when ``shape`` is not that
    operand's."""
    src = list(range(len(shape)))
    try:
        for node in chain:
            shape, back = _dims_back(node, shape)
            src = [None if s is None else back[s] for s in src]
    except ValueError:
        return None
    if tuple(shape) != gather.shape:
        return None
    return next((j for j, s in enumerate(src) if s == gather.dim), None)


def weight_grad_slab(func, args):
    """A weight gradient's product, partitioned as the reference's
    partition of gemma2-2b train_4k computes the attention projections'
    gradients: cut over the weight's use axis (``_Gather``) into slabs
    along its FSDP dim (144-row slabs, 2304 / 16 over "model"), the sum
    over the tokens left partial over the axes that split them.  ``func``
    is ``mm`` or ``bmm`` run by autograd for the weight's use; the
    weight and its FSDP dim are found by walking from the running
    autograd node through the views and casts to the weight's gather.
    Returns None for any other product (DTensor partitions it)."""
    from torch.distributed.tensor import DTensor, Partial, Shard
    if not _GSPMD.active or func.__name__.split(".")[0] not in ("mm", "bmm"):
        return None
    node = torch._C._current_autograd_node()
    kind = type(node).__name__
    if kind not in ("MmBackward0", "BmmBackward0"):
        return None
    a, b = args[:2]
    if not (isinstance(a, DTensor) and isinstance(b, DTensor)):
        return None
    mesh, ka, kb = a.device_mesh, a.ndim - 1, b.ndim - 2
    partial = {m for m in range(mesh.ndim)
               if a.placements[m].is_shard(ka) and b.placements[m].is_shard(kb)}
    if not partial:
        return None                 # not a sum over split tokens
    out_shape = tuple(a.shape[:-1]) + (b.shape[-1],)
    for i, (fn, _) in enumerate(node.next_functions):
        chain = []
        while fn is not None and type(fn).__name__ in _VIEW_NODES:
            chain.append(fn)
            fn = fn.next_functions[0][0]
        if fn is None or type(fn).__name__ != "_GatherBackward" \
                or fn.use is None:
            continue
        # the weight-side operand's shape, and whether this product
        # computes its gradient transposed (torch's mm backward does so
        # for a column-major operand)
        shape, flip = out_shape, False
        if kind == "MmBackward0":
            side = "mat2" if i == 1 else "self"
            shape = tuple(getattr(node, f"_saved_{side}_sym_sizes"))
            stride = tuple(getattr(node, f"_saved_{side}_sym_strides"))
            flip = stride[0] == 1 and stride[1] >= max(1, shape[0])
            if (shape[::-1] if flip else shape) != out_shape:
                continue
        d = _weight_dim(chain, fn, shape)
        if d is None:
            continue
        cut = (len(shape) - 1 - d) if flip else d
        n = math.prod(mesh.size(m) for m in fn.use)
        if out_shape[cut] % n:
            return None
        placements = []
        for m in range(mesh.ndim):
            if m in partial:
                placements.append(Partial())
            elif m in fn.use and a.placements[m].is_replicate() \
                    and b.placements[m].is_replicate():
                placements.append(Shard(cut))
            elif kind == "BmmBackward0" and a.placements[m].is_shard(0) \
                    and b.placements[m].is_shard(0) and cut != 0:
                placements.append(Shard(0))
            else:
                return None
        la, lb = a.to_local(), b.to_local()
        k = _flat_coordinate(mesh, fn.use)
        if cut == len(out_shape) - 1:
            size = lb.shape[-1] // n
            lb = lb.narrow(-1, k * size, size)
        elif cut == len(out_shape) - 2:
            size = la.shape[-2] // n
            la = la.narrow(-2, k * size, size)
        else:
            return None
        return DTensor.from_local(func(la, lb), mesh, placements,
                                  run_check=False, shape=torch.Size(out_shape),
                                  stride=torch.empty(out_shape,
                                                     device="meta").stride())
    return None


def _view_groups(src: Sequence[int], dst: Sequence[int]):
    """The pairs (input dims, output dims) of a view from shape ``src`` to
    ``dst``: runs of adjacent dims with equal products, size-1 dims
    joined to the run before them."""
    out, i, j = [], 0, 0
    while i < len(src) and j < len(dst):
        gi, gj, pi, pj = [i], [j], src[i], dst[j]
        i, j = i + 1, j + 1
        while pi != pj:
            if pi < pj:
                gi.append(i)
                pi, i = pi * src[i], i + 1
            else:
                gj.append(j)
                pj, j = pj * dst[j], j + 1
        out.append((gi, gj))
    if not out:
        return [(list(range(len(src))), list(range(len(dst))))]
    out[-1][0].extend(range(i, len(src)))
    out[-1][1].extend(range(j, len(dst)))
    return out


def split_factors(x, shape) -> Optional[Tuple[str, Tuple[int, int]]]:
    """For a view of the DTensor ``x`` to ``shape`` that DTensor cannot
    partition because it unflattens a dim split over a mesh axis of n
    ranks into dims (a, b, ..) with a < n (granite's 32 heads over
    "model"'s 16 as 8 KV heads x 4): the axis and its factors (a, n /
    a), where a divides n and n / a divides b — the sub-axes GSPMD cuts
    to keep the dim split (KV over 8, the group over 2); else None (and
    on a mesh already cut)."""
    from torch._prims_common import infer_size
    mesh = x.device_mesh
    if factored_axes(mesh):
        return None
    shape = list(infer_size(shape, x.numel()))
    if 0 in shape:
        return None
    groups = _view_groups(list(x.shape), shape)
    for m, q in enumerate(x.placements):
        if not q.is_shard():
            continue
        gi, gj = next(g for g in groups if q.dim in g[0])
        sizes = [shape[j] for j in gj if shape[j] > 1]
        n = mesh.size(m)
        if len(gi) == 1 and len(sizes) > 1 and sizes[0] < n \
                and n % sizes[0] == 0 and sizes[1] % (n // sizes[0]) == 0:
            return mesh.mesh_dim_names[m], (sizes[0], n // sizes[0])
    return None


def split_view(func, args):
    """A view of a DTensor on a mesh with a factored axis (``split_factors``)
    that moves that axis's split between dims, partitioned as GSPMD
    keeps it: the dims' splits taken major first over the run of dims
    the view regroups, and given to the output dims in that order, each
    factor to the dim it divides (8 KV heads over the first factor of
    "model", the group of 4 over the second).  DTensor's own rule
    mislays a dim split over two mesh dims.  Returns None for any
    other view, and for one whose split would be strided."""
    from torch.distributed.tensor import DTensor, Shard
    aten = torch.ops.aten
    if not _GSPMD.active or func not in (aten.view.default,
                                         aten._unsafe_view.default):
        return None
    x = args[0]
    if not isinstance(x, DTensor):
        return None
    mesh = x.device_mesh
    factor_of = {m: a for a, ms in mesh_axes(mesh).items() if len(ms) > 1
                 for m in ms}
    if not factor_of:
        return None
    from torch._prims_common import infer_size
    shape = list(infer_size(args[1], x.numel()))
    if 0 in shape:
        return None
    by_dim: dict = {}
    for m, q in enumerate(x.placements):
        if q.is_shard():
            if type(q) is not Shard:
                return None
            by_dim.setdefault(q.dim, []).append(m)
    groups = _view_groups(list(x.shape), shape)

    def factored(gi):
        axes = [factor_of.get(m) for d in gi for m in by_dim.get(d, ())]
        return any(a is not None and axes.count(a) > 1 for a in axes)
    if not any(factored(gi) for gi, gj in groups
               if len(gi) > 1 or len(gj) > 1):
        return None
    placements, local = list(x.placements), list(shape)
    for gi, gj in groups:
        seq, whole = [], False
        for d in gi:
            ms = by_dim.get(d, [])
            if ms and whole:
                return None           # a split under an unsplit dim
            seq += ms
            whole = whole or x.shape[d] > math.prod(mesh.size(m)
                                                    for m in ms)
        k, rest, dims_of = 0, shape[gj[0]], {}
        for m in seq:
            while rest == 1 and k + 1 < len(gj):
                k += 1
                rest = shape[gj[k]]
            if rest % mesh.size(m):
                return None
            rest //= mesh.size(m)
            dims_of.setdefault(gj[k], []).append(m)
        for o, ms in dims_of.items():
            if ms != sorted(ms):
                return None
            for m in ms:
                placements[m] = Shard(o)
                local[o] //= mesh.size(m)
    try:
        stride = torch.empty_strided(x.shape, x.stride(),
                                     device="meta").view(shape).stride()
    except RuntimeError:
        stride = torch.empty(shape, device="meta").stride()
    return DTensor.from_local(func(x._local_tensor, local), mesh, placements,
                              run_check=False, shape=torch.Size(shape),
                              stride=stride)


def _split_parts(func, args, shape):
    """The (offset, length) of each part that ``split`` (``torch.chunk``'s)
    or a unit-step ``slice`` takes along its dim, and that dim; None for
    any other op."""
    aten = torch.ops.aten
    n = len(shape)
    if func is aten.split.Tensor:
        dim = (args[2] if len(args) > 2 else 0) % n
        size = args[1]
        return dim, [(o, min(size, shape[dim] - o))
                     for o in range(0, shape[dim], size)]
    if func is aten.slice.Tensor:
        dim, start, end, step = (list(args[1:]) + [0, None, None, 1][
            len(args) - 1:])[:4]
        dim %= n
        start = 0 if start is None else (start + shape[dim] if start < 0
                                         else start)
        end = shape[dim] if end is None else min(
            end + shape[dim] if end < 0 else end, shape[dim])
        if step != 1:
            return None
        return dim, [(start, end - start)]
    return None


def split_kept(func, args):
    """A split (``torch.chunk``'s ``split``, a ``slice``) of a DTensor along
    a dim split over mesh dims into parts those mesh dims divide, as
    GSPMD partitions it: each part keeps the input's split, and each
    rank fetches its block of a part from the rank whose block holds it
    — collective-permutes, grouped as XLA groups them (``_permute_plan``:
    the mLSTM's ``up`` cut into its two halves, f32[8,1,192] and three
    f32[8,1,96] on xlstm-125m decode_32k; the sLSTM's four gate
    pre-activations, ten f32[8,48] and six f32[8,96]), where DTensor
    gathers the dim whole.  None for any other op, a part the mesh dims
    do not divide, or one whose blocks straddle the input's."""
    from torch.distributed.tensor import DTensor, Shard
    if not _GSPMD.active or not args or not isinstance(args[0], DTensor):
        return None
    x = args[0]
    found = _split_parts(func, args, tuple(x.shape))
    if found is None:
        return None
    dim, parts = found
    mesh = x.device_mesh
    over = [m for m, q in enumerate(x.placements) if q.is_shard(dim)]
    if not over or any(type(x.placements[m]) is not Shard for m in over) \
            or any(q.is_partial() for q in x.placements) \
            or over != sorted(over):
        return None
    n = math.prod(mesh.size(m) for m in over)
    b = x.shape[dim] // n
    if x.shape[dim] % n or all(length == x.shape[dim] for _, length in parts):
        return None
    if any(length % n or b % (length // n) or o % (length // n)
           for o, length in parts):
        return None
    block = x._local_tensor
    me = _flat_coordinate(mesh, over)
    outs = []
    for o, length in parts:
        got = _permuted_part(block, mesh, over, dim, b, o, length // n, me)
        shape = list(x.shape)
        shape[dim] = length
        outs.append(_placed(got, mesh, list(x.placements), shape))
    if func is torch.ops.aten.slice.Tensor:
        return outs[0]
    return tuple(outs)


def cat_kept(func, args):
    """The gradient of ``split_kept``'s split — autograd's concatenation
    of its parts' gradients along the dim they split alike — as GSPMD
    partitions that concatenation: each part's block exchanged over the
    mesh dims that split it (an all-to-all), the blocks joined, and the
    joined block exchanged again (an all-to-all), its split kept (the
    reference's sLSTM step: four f32[16,48] all-to-alls and one
    f32[16,192] a step of xlstm-125m train_4k's backward).  Where no
    other dim of a part's block divides among those ranks (the sLSTM
    step's 8 rows a rank against "model"'s 16 on the 2x16x16 mesh), each
    part gathered whole over them (an all-gather: the reference's four
    f32[8,768] a step there), the parts joined, and the joined dim
    sliced to the split.  None for any other op."""
    from torch.distributed.tensor import DTensor, Shard
    if not _GSPMD.active or func is not torch.ops.aten.cat.default:
        return None
    node = torch._C._current_autograd_node()
    if type(node).__name__ != "SplitBackward0":
        return None
    ts = list(args[0])
    dim = args[1] if len(args) > 1 else 0
    if not ts or not all(isinstance(t, DTensor) for t in ts):
        return None
    x = ts[0]
    dim %= x.ndim
    mesh, placements = x.device_mesh, list(x.placements)
    over = [m for m, q in enumerate(placements) if q.is_shard(dim)]
    if not over or any(list(t.placements) != placements for t in ts) \
            or any(type(placements[m]) is not Shard for m in over) \
            or any(q.is_partial() for q in placements):
        return None
    if any(t._local_tensor.shape[dim] % mesh.size(m)
           for t in ts for m in over):
        return None
    shape = list(x.shape)
    shape[dim] = sum(t.shape[dim] for t in ts)
    n = math.prod(mesh.size(m) for m in over)
    if not any(size % n == 0 for d, size in
               enumerate(x._local_tensor.shape) if d != dim):
        group = _dims_group(mesh, over)
        joined = torch.cat([_all_gather(t._local_tensor, dim, group)
                            for t in ts], dim)
        b = shape[dim] // n
        return _placed(joined.narrow(dim, _flat_coordinate(mesh, over) * b,
                                     b), mesh, placements, shape)
    blocks = [_exchanged(t._local_tensor, mesh, over, dim) for t in ts]
    joined = _exchanged(torch.cat(blocks, dim), mesh, over, dim)
    return _placed(joined, mesh, placements, shape)


def slice_backward_kept(func, args):
    """The gradient of ``split_kept``'s ``slice`` (autograd's
    ``slice_backward``: the part's gradient padded with zeros to the
    whole dim), as GSPMD partitions the pad: the whole dim's gradient
    split as the part's was, each rank's block of the part sent back to
    the rank whose block it came from (the permutes of
    ``_permute_plan`` reversed: the mLSTM gates' f32[16,4096,1]
    collective-permutes of xlstm-125m train_4k's backward), where
    DTensor gathers the dim.  None for any other op."""
    from torch.distributed.tensor import DTensor, Shard
    if not _GSPMD.active \
            or func is not torch.ops.aten.slice_backward.default:
        return None
    g, sizes, dim, start, end, step = args[:6]
    if not isinstance(g, DTensor) or step != 1:
        return None
    dim %= g.ndim
    mesh, placements = g.device_mesh, list(g.placements)
    over = [m for m, q in enumerate(placements) if q.is_shard(dim)]
    whole = sizes[dim]
    end = min(end, whole)
    length = end - start
    if not over or over != sorted(over) \
            or any(type(placements[m]) is not Shard for m in over) \
            or any(q.is_partial() for q in placements):
        return None
    n = math.prod(mesh.size(m) for m in over)
    if whole % n or length % n or length == whole:
        return None
    b, b2 = whole // n, length // n
    if b % b2 or start % b2:
        return None
    plan, _ = _permute_plan(n, b, start, b2)
    block = g._local_tensor
    me = _flat_coordinate(mesh, over)
    for lo, width, pairs in plan:
        back = {t: s for s, t in pairs.items()}
        piece = block.movedim(dim, 0).contiguous()
        send, recv = [0] * mesh.size(), [0] * mesh.size()
        send[_rank_along(mesh, over, back.get(me, me))] = b2
        recv[_rank_along(mesh, over, pairs.get(me, me))] = b2
        _funcol().wait_tensor(_funcol().all_to_all_single(
            piece, recv, send, _mesh_group(mesh)))
    local = list(block.shape)
    local[dim] = b
    out = block.new_zeros(local)
    return _placed(out, mesh, placements, list(sizes))


def _exchanged(block, mesh, over, dim):
    """``block`` through an all-to-all over the mesh dims ``over`` along
    ``dim`` (one over each in turn: on a factored axis, merged into one
    over the axis, ``cost_analysis.factor_batch``); its shape kept."""
    for m in over:
        rows = block.movedim(dim, 0).contiguous()
        splits = [rows.shape[0] // mesh.size(m)] * mesh.size(m)
        rows = _funcol().wait_tensor(_funcol().all_to_all_single(
            rows, splits, splits, mesh.get_group(m)))
        block = rows.movedim(0, dim)
    return block


def _permute_plan(n: int, b: int, o: int, b2: int):
    """XLA's collective-permutes for one part (offset ``o``, a block of
    ``b2`` a rank) of a dim split over ``n`` ranks in blocks of ``b``:
    rank t's block of the part starts at ``o + b2 * t``, in the block of
    rank s = that // b.  Each source's targets but itself, in order,
    the k-th of each source making the k-th permute, which carries the
    window of the source blocks from the least offset it sends to the
    greatest plus ``b2``.  Returns [(window start, width, {source:
    target})] and, for each target, (its permute or None, its offset
    in the source's block)."""
    targets = {}
    where = []
    for t in range(n):
        s, off = divmod(o + b2 * t, b)
        where.append((s, off))
        if s != t:
            targets.setdefault(s, []).append(t)
    plan, of_target = [], [None] * n
    for k in range(max((len(v) for v in targets.values()), default=0)):
        pairs = {s: ts[k] for s, ts in targets.items() if len(ts) > k}
        offs = [where[t][1] for t in pairs.values()]
        lo = min(offs)
        plan.append((lo, max(offs) + b2 - lo, pairs))
        for t in pairs.values():
            of_target[t] = len(plan) - 1
    return plan, [(of_target[t], where[t][1]) for t in range(n)]


def _rank_along(mesh, over, i: int) -> int:
    """The global rank of the rank at index ``i`` over the mesh dims
    ``over`` (major first), this rank's coordinate elsewhere."""
    coord = list(mesh.get_coordinate())
    for m in reversed(over):
        coord[m], i = i % mesh.size(m), i // mesh.size(m)
    return _flat_coordinate(mesh, range(mesh.ndim), coord)


def _dims_group(mesh, dims, run: Optional[int] = None):
    """The process group of the ranks that differ from this one in the
    mesh dims ``dims`` alone, ranked major first: one collective over
    several mesh dims at once, as XLA issues it over "pod" x "data"
    (DTensor issues one over each mesh dim in turn).  ``run``: only
    those of them in this one's run of ``run`` consecutive indices over
    ``dims`` (a pair of "data" ranks, XLA's [256,2] groups over
    "pod" x "data").  A single mesh dim's own group; the subgroups made
    once a mesh, ``dims`` and ``run``, every one on every rank, in one
    order."""
    dims = tuple(dims)
    size = math.prod(mesh.size(m) for m in dims)
    run = size if run is None else run
    if len(dims) == 1 and run == size:
        return mesh.get_group(dims[0])
    groups = mesh.__dict__.setdefault("_dims_groups", {})
    if (dims, run) not in groups:
        import torch.distributed as dist
        grid = mesh.mesh.permute(
            [m for m in range(mesh.ndim) if m not in dims] + list(dims))
        mine, _ = dist.new_subgroups_by_enumeration(
            grid.reshape(-1, run).tolist())
        groups[dims, run] = mine
    return groups[dims, run]


def _permuted_part(block, mesh, over, dim, b, o, b2, me):
    """This rank's block of one part (``_permute_plan``): each permute of
    the plan issued (every rank issues it, as XLA's SPMD program does;
    one that sends nothing sends to itself), the block taken from the
    permute that brings it, or from the rank's own block."""
    n = math.prod(mesh.size(m) for m in over)
    plan, at = _permute_plan(n, b, o, b2)
    got = None
    for k, (lo, width, pairs) in enumerate(plan):
        frm = next((s for s, t in pairs.items() if t == me), me)
        window = block.narrow(dim, lo, width).movedim(dim, 0).contiguous()
        send, recv = [0] * mesh.size(), [0] * mesh.size()
        send[_rank_along(mesh, over, pairs.get(me, me))] = width
        recv[_rank_along(mesh, over, frm)] = width
        moved = _funcol().all_to_all_single(window, recv, send,
                                            _mesh_group(mesh))
        moved = _funcol().wait_tensor(moved).movedim(0, dim)
        if at[me][0] == k:
            got = moved.narrow(dim, at[me][1] - lo, b2)
    if got is None:                        # the rank's own block holds it
        got = block.narrow(dim, at[me][1], b2)
    return got


def _placed(block, mesh, placements, shape):
    """``block`` as the DTensor of global ``shape`` it is one rank's block
    of, the global strides laid out in the block's dim order (a view of
    it maps to a view of the block)."""
    from torch.distributed.tensor import DTensor
    order = sorted(range(block.ndim), key=lambda d: -block.stride(d))
    whole = torch.empty([shape[d] for d in order], device="meta")
    stride = whole.permute([order.index(d) for d in range(block.ndim)]) \
        .stride()
    return DTensor.from_local(block, mesh, placements, run_check=False,
                              shape=torch.Size(shape), stride=stride)


def local_pointwise(func, args, kwargs):
    """An elementwise op of DTensors on a mesh with a factored axis whose
    operands already agree — each split where the output is, or
    replicated where it broadcasts (a plain tensor only there) — run on
    their blocks, its result placed as they are: DTensor's own
    propagation weighs every placement of every mesh dim for it,
    seconds an op on a 3- or 4-dim mesh, to choose these.  None for any
    other op."""
    from torch.distributed.tensor import DTensor, Shard
    if not _GSPMD.active or not (torch.Tag.pointwise in func.tags
                                 or func.__name__ == "_to_copy.default"):
        return None
    ts = [a for a in (*args, *kwargs.values()) if isinstance(a, torch.Tensor)]
    dts = [t for t in ts if isinstance(t, DTensor)]
    if not dts or not factored_axes(dts[0].device_mesh) \
            or any(type(q) is not Shard and not q.is_replicate()
                   for t in dts for q in t.placements):
        return None
    shape = torch.broadcast_shapes(*(t.shape for t in ts))
    lead = max(dts, key=lambda t: sum(q.is_shard() for q in t.placements))
    off = len(shape) - lead.ndim
    placements = [Shard(q.dim + off) if q.is_shard() else q
                  for q in lead.placements]
    for t in ts:
        off = len(shape) - t.ndim
        for m, q in enumerate(placements):
            d = q.dim - off if q.is_shard() else -1
            split = d >= 0 and t.shape[d] != 1
            mine = t.placements[m] if isinstance(t, DTensor) else None
            if not (mine is not None and mine.is_shard(d) if split
                    else mine is None or mine.is_replicate()):
                return None
    out = func(*[a._local_tensor if isinstance(a, DTensor) else a
                 for a in args],
               **{k: v._local_tensor if isinstance(v, DTensor) else v
                  for k, v in kwargs.items()})
    if func._schema.is_mutable:
        return args[0]
    return _placed(out, lead.device_mesh, placements, shape)


def gspmd_fallback(func, args, kwargs=None):
    """An op DTensor has no sharding strategy for (or, ``OWN_RULES``, one
    that differs between torch versions), partitioned as GSPMD
    partitions it, where it can be: an elementwise op
    (``log_sigmoid_backward``) on the blocks of its input's placements,
    every operand of its shape redistributed there; an op that moves
    data along dims no mesh dim splits (``roll``, ``flip``: torch 2.11
    has no strategy for them) on each block, its placements kept; a
    constant pad (``_pad_blocks``); an op that works along the last dim
    of operands whose other dims line up (``searchsorted``,
    ``scatter``) on their blocks, each split where any of them is, the
    last dim whole.  None for any other op (it runs replicated)."""
    from torch.distributed.tensor import DTensor
    name = func.__name__
    x = args[0] if args else None
    if name in _ALIGNED:
        return _aligned_blocks(func, args, kwargs or {})
    if not _GSPMD.active or not isinstance(x, DTensor) \
            or any(q.is_partial() for q in x.placements):
        return None
    if name == "constant_pad_nd.default":
        return _pad_blocks(func, x, *args[1:])
    if name in _ELEMENTWISE:
        x = args[_ELEMENTWISE[name]]
        if not isinstance(x, DTensor) \
                or any(q.is_partial() for q in x.placements):
            return None
        blocks = [a.redistribute(x.device_mesh, x.placements)._local_tensor
                  if isinstance(a, DTensor) else a for a in args]
    elif name in _ALONG_DIMS:
        dims = args[_ALONG_DIMS[name]] if len(args) > _ALONG_DIMS[name] \
            else ()
        dims = [dims] if isinstance(dims, int) else list(dims)
        if not dims or any(q.is_shard(d % x.ndim) for q in x.placements
                           for d in dims):
            return None
        blocks = [x._local_tensor, *args[1:]]
    else:
        return None
    return _placed(func(*blocks), x.device_mesh, x.placements, x.shape)


def _pad_blocks(func, x, pad, value=0.0):
    """``constant_pad_nd`` of the DTensor ``x``: the pad run on the block,
    the placements kept, as GSPMD pads along dims no mesh dim splits
    (the causal conv's sequence, MLA's cache pad, the window pads: every
    pad of the 35 cells); a mesh dim that splits a dim the pad changes
    is gathered first (an all-gather: simpler than GSPMD's halo
    exchange, and met by no cell).  torch 2.11's redistribution planner
    raises ``IndexError`` on this op (the conv's pad of recurrentgemma-9b
    train_4k's (256, 4096, 4096) split over "data" and "model") and 2.13
    has a strategy of its own, so the port partitions it itself on
    every torch (``OWN_RULES``)."""
    from torch.distributed.tensor import Replicate
    pad = list(pad)
    shape = list(x.shape)
    changed = set()
    for i in range(0, len(pad), 2):
        d = x.ndim - 1 - i // 2
        shape[d] += pad[i] + pad[i + 1]
        if pad[i] or pad[i + 1]:
            changed.add(d)
    want = [Replicate() if q.is_shard() and q.dim in changed else q
            for q in x.placements]
    if want != list(x.placements):
        x = x.redistribute(x.device_mesh, want)
    return _placed(func(x._local_tensor, pad, value), x.device_mesh, want,
                   shape)


# the ops the port partitions itself before DTensor's own strategy is
# asked, on every torch (``gspmd_fallback``): torch 2.11 has none for
# them, one whose redistribution fails (the pad) or one that gathers
# what 2.13 leaves split (the MoE's dispatch scatter, 16 x 8192 rows a
# rank of deepseek-v3-671b's smoke prefill_32k: 16,777,216 elements
# all-gathered on 2.11, none on 2.13)
OWN_RULES = {"constant_pad_nd.default", "scatter.src"}
# the elementwise ops without a DTensor strategy: name -> the argument
# whose placements the others take; the ops that move data along given
# dims: name -> the argument that names them
_ELEMENTWISE = {"log_sigmoid_backward.default": 1}
_ALONG_DIMS = {"roll.default": 2, "flip.default": 1}
# the ops along the last dim of operands whose other dims line up:
# name -> (the tensor arguments, the one whose shape the result has)
_ALIGNED = {"searchsorted.Tensor": ((0, 1), 1),
            "scatter.src": ((0, 2, 3), 0), "scatter_add.default": ((0, 2, 3), 0)}


def _aligned_blocks(func, args, kwargs):
    """``func`` (of ``_ALIGNED``) on the blocks of its tensor operands, each
    redistributed to split every dim but the last where any of them
    splits it (a plain tensor is replicated: its slice moves nothing);
    None where two split a mesh dim differently, or one splits its last
    dim, or one is partial, or their ranks differ."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    which, like = _ALIGNED[func.__name__]
    if not _GSPMD.active or func.__name__.startswith("scatter") \
            and args[1] % args[0].ndim != args[0].ndim - 1:
        return None
    ts = [args[i] for i in which]
    dts = [t for t in ts if isinstance(t, DTensor)]
    if not dts or len({t.ndim for t in ts}) != 1:
        return None
    mesh, last = dts[0].device_mesh, ts[0].ndim - 1
    want = []
    for m in range(mesh.ndim):
        qs = [t.placements[m] for t in dts]
        if any(q.is_partial() or q.is_shard() and type(q) is not Shard
               for q in qs):
            return None
        dims = {q.dim for q in qs if q.is_shard()}
        if len(dims) > 1 or last in dims or any(
                t.shape[d] != ts[0].shape[d] for d in dims for t in ts):
            return None
        want.append(Shard(dims.pop()) if dims else Replicate())
    blocks = list(args)
    for i, t in zip(which, ts):
        if not isinstance(t, DTensor):
            t = DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                                   run_check=False)
        blocks[i] = t.redistribute(mesh, want)._local_tensor
    out = func(*blocks, **kwargs)
    return _placed(out, mesh, want, args[which[like]].shape)


def take_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[idx]`` row by row: x (..., N, d), idx (..., *shape) with the
    same leading dims -> (..., *shape, d), each leading index on its own
    (one gather)."""
    nb, d = x.dim() - 2, x.shape[-1]
    flat = idx.reshape(*idx.shape[:nb], -1, 1)
    out = torch.gather(x, -2, flat.expand(*flat.shape[:-1], d))
    return out.reshape(*idx.shape, d)


def gather_sum(src: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """``sum_j src[index[..., j]]``: src (..., N, d), index (..., T, J) ->
    (..., T, d), an index of N or more adding nothing; the terms added in
    order j = 0, 1, .., each a gather, so that the sum's order never
    depends on the device (the MoE combine).  On a DTensor whose rows a
    mesh dim splits (the decode's expert buckets over "data"), as GSPMD
    partitions the reference's scatter-add that this sum transposes
    (``_gather_sum_blocks``)."""
    if _GSPMD.active and is_distributed(src) and src.ndim == index.ndim == 2:
        out = _gather_sum_blocks(src, index)
        if out is not None:
            return out
    n, y = src.shape[-2], None
    for j in range(index.shape[-1]):
        at = index[..., j]
        got = torch.where((at < n)[..., None],
                          take_rows(src, torch.clamp_max(at, n - 1)), 0)
        y = got if y is None else y + got
    return y


def _gather_sum_blocks(src, index):
    """``gather_sum`` of rows split over one mesh dim by a replicated index,
    as GSPMD partitions the reference's scatter-add of the decode's
    expert outputs into its token rows: the output rows split over a
    mesh dim of that size on which both are whole (the scatter's
    operand; a slice of the index) and over every other mesh dim on
    which both are whole ("pod" on the 2x16x16 mesh: the output's rows
    over "pod" x "model"), each rank summing the terms its block of
    ``src`` holds, the partial sums all-reduced over the rows' mesh
    dim, and the output's split moved from the same-size mesh dim to
    that one (a collective-permute).  None where src's rows are not
    split over one mesh dim, or no such other mesh dim exists."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    mesh = src.device_mesh
    split = [m for m, q in enumerate(src.placements) if q.is_shard()]
    if len(split) != 1 or src.placements[split[0]] != Shard(0) \
            or factored_axes(mesh) \
            or any(not q.is_replicate() for q in index.placements):
        return None
    m = split[0]
    free = next((f for f in range(mesh.ndim) if f != m
                 and mesh.size(f) == mesh.size(m)), None)
    if free is None:
        return None
    rows = [Shard(0) if f == free or f != m and q.is_replicate()
            and index.placements[f].is_replicate() else Replicate()
            for f, q in enumerate(src.placements)]
    at = index.redistribute(mesh, rows)._local_tensor
    block = src._local_tensor
    start = compute_local_shape_and_global_offset(
        src.shape, mesh, src.placements)[1][0]
    n, y = block.shape[0], None
    at = at - start
    for j in range(at.shape[-1]):
        a = at[..., j]
        got = torch.where(((a >= 0) & (a < n))[..., None],
                          take_rows(block, torch.clamp(a, 0, max(n - 1, 0))),
                          0)
        y = got if y is None else y + got
    partial = list(rows)
    partial[m] = Partial()
    shape = (index.shape[0], src.shape[1])
    y = _placed(y, mesh, partial, shape).redistribute(mesh, rows)
    moved = list(rows)
    moved[m], moved[free] = Shard(0), Replicate()
    return _move_split(y, (free,), (m,), moved)


def _permute_rows(t, mesh, m: int, shift: int, dim: int):
    """``t`` sent to the rank ``shift`` further along mesh dim ``m`` (its
    rows along ``dim``), the one from the rank ``shift`` before received:
    one collective-permute."""
    from torch.distributed import _functional_collectives as funcol
    coord = list(mesh.get_coordinate())
    n = mesh.size(m)
    rows = t.movedim(dim, 0).contiguous()
    send, recv = [0] * mesh.size(), [0] * mesh.size()
    to, frm = list(coord), list(coord)
    to[m], frm[m] = (coord[m] + shift) % n, (coord[m] - shift) % n
    send[_flat_coordinate(mesh, range(mesh.ndim), to)] = rows.shape[0]
    recv[_flat_coordinate(mesh, range(mesh.ndim), frm)] = rows.shape[0]
    out = funcol.all_to_all_single(rows, recv, send, _mesh_group(mesh))
    return funcol.wait_tensor(out).movedim(0, dim)


def halo_slice(func, args):
    """A slice ``[:end]`` of a dim split unevenly over one mesh dim (padded
    blocks of B rows) that leaves a length it splits evenly (blocks of
    b < B), as GSPMD re-cuts the blocks (the decode's combined 129 rows
    cut to its 128 tokens): a halo exchange, each rank's new block
    taking the rows it lacks from the ranks before it, at most B a
    collective-permute, (n - 1) * (B - b) rows in all.  None for any
    other op."""
    from torch.distributed.tensor import DTensor, Shard
    aten = torch.ops.aten
    if not _GSPMD.active or func is not aten.slice.Tensor \
            or not isinstance(args[0], DTensor):
        return None
    x = args[0]
    dim, start, end, step = (list(args[1:]) + [0, None, None, 1][
        len(args) - 1:])[:4]
    dim %= x.ndim
    mesh, total = x.device_mesh, x.shape[dim]
    end = total if end is None else min(end, total)
    split = [m for m, q in enumerate(x.placements) if q.is_shard(dim)]
    if start not in (0, None) or step != 1 or not split \
            or any(type(x.placements[m]) is not Shard for m in split) \
            or factored_axes(mesh):
        return None
    if len(split) > 1:
        return _recut(x, split, dim, end)
    m = split[0]
    n = mesh.size(m)
    big, small = -(-total // n), end // n
    if total % n == 0 or end % n or big <= small:
        return None
    block, p = x._local_tensor, mesh.get_coordinate()[m]
    left = (n - 1) * (big - small)
    halo = []
    for i in range(-(-left // big)):
        rows = min(big, left - i * big)
        piece = F.pad(block, [0, 0] * (block.ndim - 1 - dim)
                      + [0, max(0, big - block.shape[dim])])
        halo.insert(0, _permute_rows(piece.narrow(dim, big - rows, rows),
                                     mesh, m, i + 1, dim))
    joined = torch.cat(halo + [block], dim=dim)
    need = p * (big - small)
    local = joined.narrow(dim, joined.shape[dim] - block.shape[dim] - need,
                          small)
    shape = list(x.shape)
    shape[dim] = end
    return _placed(local, mesh, list(x.placements), shape)


def _recut_plan(n: int, b: int, b2: int):
    """XLA's collective-permutes that re-cut a dim split over ``n`` ranks
    in padded blocks of ``b`` into blocks of ``b2`` < ``b`` (a slice of
    its leading ``n * b2``): rank t's new block, rows b2 t .. b2 t + b2,
    starts in the block of rank s = b2 t // b and may end in the next.
    The first parts grouped as ``_permute_plan`` groups them (each
    source's targets but itself, in order, the k-th of each making the
    k-th permute, whose window runs from the least offset it sends to
    the greatest plus ``b2``, within the block), then the second parts
    so, each window from the block's start.  Returns [(window start,
    width, {source: target})], each rank's (source, offset, length) of
    its first part, and each rank's permute of each part (None: its
    own block)."""
    where, firsts, seconds = [], {}, {}
    for t in range(n):
        s, off = divmod(b2 * t, b)
        where.append((s, off, min(b2, b - off)))
        if s != t:
            firsts.setdefault(s, []).append(t)
        if where[t][2] < b2 and s + 1 != t:
            seconds.setdefault(s + 1, []).append(t)
    plan, of_target = [], [[None, None] for _ in range(n)]
    for part, targets in enumerate((firsts, seconds)):
        for k in range(max(map(len, targets.values()), default=0)):
            pairs = {s: ts[k] for s, ts in targets.items() if len(ts) > k}
            if part == 0:
                offs = [where[t][1] for t in pairs.values()]
                lo, hi = min(offs), min(max(offs) + b2, b)
            else:
                lo, hi = 0, max(b2 - where[t][2] for t in pairs.values())
            plan.append((lo, hi - lo, pairs))
            for t in pairs.values():
                of_target[t][part] = len(plan) - 1
    return plan, where, of_target


def _recut(x, over, dim: int, end: int):
    """``x[:end]`` along ``dim``, which the mesh dims ``over`` (several)
    split in padded blocks, cut to the blocks ``end`` leaves, as GSPMD
    re-cuts them (``_recut_plan``: the decode's 129 combined rows over
    the 32 of "pod" x "data", 5 a rank, cut to its 128 tokens, 4 a
    rank, by f32[5,7168], f32[1,7168] and f32[3,7168]
    collective-permutes).  None where ``end`` is not split evenly."""
    mesh = x.device_mesh
    n = math.prod(mesh.size(m) for m in over)
    b, b2 = -(-x.shape[dim] // n), end // n
    if end % n or b2 >= b:
        return None
    plan, where, of_target = _recut_plan(n, b, b2)
    me = _flat_coordinate(mesh, over)
    block = x._local_tensor
    block = F.pad(block, [0, 0] * (block.ndim - 1 - dim)
                  + [0, b - block.shape[dim]])
    s, off, length = where[me]
    parts = [block.narrow(dim, off, length) if s == me else None,
             block.narrow(dim, 0, b2 - length) if s + 1 == me else None]
    for k, (lo, width, pairs) in enumerate(plan):
        frm = next((src for src, t in pairs.items() if t == me), me)
        got = _send_block(block.narrow(dim, lo, width).movedim(dim, 0),
                          mesh, over, pairs.get(me, me), frm).movedim(0, dim)
        if of_target[me][0] == k:
            parts[0] = got.narrow(dim, off - lo, length)
        if of_target[me][1] == k:
            parts[1] = got.narrow(dim, 0, b2 - length)
    local = parts[0] if length == b2 else torch.cat(parts, dim=dim)
    shape = list(x.shape)
    shape[dim] = end
    return _placed(local, mesh, list(x.placements), shape)


def uneven_cat(func, args):
    """A concatenation along a dim one operand splits over mesh dims
    that do not divide the result (the decode's tokens and the zero
    row: 129 rows over 16, or over the 32 of "pod" x "data"), as GSPMD
    partitions it: the split moved to the last other dim they divide
    (an all-to-all over them at once), the blocks joined there, and the
    split moved back with the joined dim padded to a multiple of their
    ranks (an all-to-all).  The other operands are whole.  None for any
    other op."""
    from torch.distributed.tensor import DTensor, Shard
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    aten = torch.ops.aten
    if not _GSPMD.active or func is not aten.cat.default:
        return None
    ts = list(args[0])
    dim = args[1] if len(args) > 1 else 0
    lead = [t for t in ts if isinstance(t, DTensor)
            and any(q.is_shard() for q in t.placements)]
    if len(lead) != 1 or factored_axes(lead[0].device_mesh):
        return None
    x = lead[0]
    dim %= x.ndim
    mesh = x.device_mesh
    split = [m for m, q in enumerate(x.placements) if q.is_shard()]
    if not split or any(x.placements[m] != Shard(dim) for m in split) \
            or any(isinstance(t, DTensor) and t is not x and any(
                not q.is_replicate() for q in t.placements) for t in ts):
        return None
    n = math.prod(mesh.size(m) for m in split)
    total = sum(t.shape[dim] for t in ts)
    other = next((d for d in reversed(range(x.ndim)) if d != dim
                  and all(t.shape[d] % n == 0 for t in ts)), None)
    if total % n == 0 or other is None:
        return None
    group = _dims_group(mesh, split).group_name
    at = _flat_coordinate(mesh, split)
    pieces = []
    for t in ts:
        if t is x:
            pieces.append(torch.ops._dtensor.shard_dim_alltoall(
                x._local_tensor, dim, other, group))
        else:
            whole = t._local_tensor if isinstance(t, DTensor) else t
            size = whole.shape[other] // n
            pieces.append(whole.narrow(other, at * size, size))
    joined = torch.cat(pieces, dim=dim)
    pad = -(-total // n) * n - total
    joined = torch.cat([joined, joined.new_zeros(
        [pad if d == dim else s for d, s in enumerate(joined.shape)])],
        dim=dim)
    back = torch.ops._dtensor.shard_dim_alltoall(joined, other, dim, group)
    shape = list(x.shape)
    shape[dim] = total
    placements = list(x.placements)
    rows = compute_local_shape_and_global_offset(shape, mesh,
                                                 placements)[0][dim]
    return _placed(back.narrow(dim, 0, rows), mesh, placements, shape)


def masked_gather(func, args):
    """A ``gather`` from a DTensor split along the gathered dim (and that
    takes more than one entry there: DTensor's own masked strategy takes
    that case), as GSPMD partitions it: each rank gathers the entries
    its block holds and zeros elsewhere, and these partial results are
    all-reduced over the mesh dims that split the operand there (the
    reference's all-reduces of ``_dispatch_row``'s gathers of the
    decode's split ids); over every other mesh dim the operand and the
    index are split alike, or neither, or the index alone.  Where the
    index is split over the mesh dim that splits the operand along the
    gathered dim (the decode's tokens gathered into expert buckets, both
    over "data"), the operand's split first moves to a mesh dim of that
    size on which both are whole (a collective-permute, ``_split_off``).
    None for any other op."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    if not _GSPMD.active or func is not torch.ops.aten.gather.default:
        return None
    x, dim, index = args[:3]
    if not (isinstance(x, DTensor) and isinstance(index, DTensor)):
        return None
    dim %= x.ndim
    if index.shape[dim] == 1 or not any(q.is_shard(dim)
                                        for q in x.placements):
        return None
    x = _split_off(x, index)
    placements = []
    for qx, qi in zip(x.placements, index.placements):
        if qx.is_shard(dim) and qi.is_replicate():
            placements.append(Partial())
        elif qx.is_replicate() and (qi.is_replicate() or type(qi) is Shard):
            placements.append(qi)
        elif type(qx) is Shard and qx == qi \
                and x.shape[qx.dim] == index.shape[qx.dim]:
            placements.append(qx)
        else:
            return None
    block, at = x._local_tensor, index._local_tensor
    start = compute_local_shape_and_global_offset(
        x.shape, x.device_mesh, x.placements)[1][dim]
    n = block.shape[dim]
    at = at - start
    inside = (at >= 0) & (at < n)
    got = torch.gather(block, dim, torch.clamp(at, 0, max(n - 1, 0)))
    out = torch.where(inside, got, torch.zeros((), dtype=got.dtype,
                                               device=got.device))
    out = _placed(out, x.device_mesh, placements, index.shape)
    return out.redistribute(out.device_mesh, [
        Replicate() if q.is_partial() else q for q in placements])


def gathered_on_blocks(func, args, kwargs):
    """A ``gather`` of one entry a row (``index.shape[dim] == 1``: the
    cross-entropy's gold logit) from a DTensor under autograd, as GSPMD
    partitions its transpose (``_GatherOnBlocks``): the forward is
    DTensor's own (masked where the operand splits the gathered dim),
    the operand's gradient a block of its own, scattered where the
    entry falls in it — no collective and no block of the global shape
    (DTensor's ``gather_backward`` makes its zeros whole and replicated:
    (256, 4096, 256000) f32 on gemma2-2b train_4k).  The index must be
    split as the operand is along every other dim.  None for any other
    op."""
    from torch.distributed.tensor import DTensor, Shard
    if func not in (torch.gather, torch.Tensor.gather) \
            or not torch.is_grad_enabled():
        return None
    names = ("input", "dim", "index")
    given = dict(zip(names, args), **kwargs)
    x, dim, index = (given.get(k) for k in names)
    if set(given) - set(names) or not isinstance(x, DTensor) \
            or not isinstance(index, DTensor) or not x.requires_grad \
            or index.ndim != x.ndim:
        return None
    dim %= x.ndim
    if index.shape[dim] != 1 or any(
            index.shape[d] != x.shape[d] for d in range(x.ndim) if d != dim):
        return None
    for qx, qi in zip(x.placements, index.placements):
        if qx.is_shard(dim) and type(qx) is Shard:
            ok = qi.is_replicate()
        else:
            ok = qi == qx and (qx.is_replicate() or type(qx) is Shard)
        if not ok:
            return None
    return _GatherOnBlocks.apply(x, dim, index)


class _GatherOnBlocks(torch.autograd.Function):
    """``gathered_on_blocks``: each rank's gradient rows (as the index is
    split) scattered into zeros of the operand's block, where the index,
    less the block's offset along ``dim``, falls inside it."""

    @staticmethod
    def forward(ctx, x, dim, index):
        ctx.dim, ctx.mesh = dim, x.device_mesh
        ctx.placements, ctx.shape = list(x.placements), x.shape
        ctx.local = (x._local_tensor.shape, x.dtype)
        ctx.save_for_backward(index)
        return torch.gather(x, dim, index)

    @staticmethod
    def backward(ctx, g):
        from torch.distributed.tensor import Replicate
        from torch.distributed.tensor._utils import \
            compute_local_shape_and_global_offset
        index, = ctx.saved_tensors
        dim, mesh, shape = ctx.dim, ctx.mesh, ctx.shape
        rows = [Replicate() if q.is_shard(dim) else q
                for q in ctx.placements]
        if list(g.placements) != rows:
            g = g.redistribute(mesh, rows)
        start = compute_local_shape_and_global_offset(
            shape, mesh, ctx.placements)[1][dim]
        local, dtype = ctx.local
        n = local[dim]
        g = g._local_tensor
        at = index._local_tensor - start
        inside = (at >= 0) & (at < n)
        block = torch.zeros(local, dtype=dtype, device=g.device)
        block.scatter_add_(dim, torch.clamp(at, 0, n - 1), torch.where(
            inside, g, torch.zeros((), dtype=dtype, device=g.device)))
        return _placed(block, mesh, ctx.placements, shape), None, None


def _split_off(x, index):
    """``x`` with each split that ``index`` shares (the same mesh dim splits
    both) moved to a mesh dim of the same size on which neither is split
    (``_move_split``: one collective-permute), where there is one."""
    mesh = x.device_mesh
    for m, (qx, qi) in enumerate(zip(x.placements, index.placements)):
        if not (qx.is_shard() and qi.is_shard()):
            continue
        free = _free_dim(mesh, m, (x, index))
        if free is None or factored_axes(mesh):
            return x
        moved = list(x.placements)
        moved[m], moved[free] = moved[free], moved[m]
        x = _move_split(x, (m,), (free,), moved)
    return x


class _SortWhole(torch.autograd.Function):
    """``torch.sort`` of a split DTensor on its operand gathered whole, each
    rank keeping its block of the results (a dim split over several
    mesh dims gathered over them at once, ``_whole_over``); the
    backward scatters each rank's block of the values' gradient to its
    rows' sorted positions, where it stands (every row's gradient is in
    the rank's block)."""

    @staticmethod
    def forward(ctx, x, dim, descending, stable):
        mesh, keep = x.device_mesh, list(x.placements)
        whole = _whole_over(x, range(x.device_mesh.ndim))
        vals, ids = torch.sort(whole, dim=dim, descending=descending,
                               stable=stable)
        ids = ids.redistribute(mesh, keep)
        ctx.save_for_backward(ids)
        ctx.dim = dim
        ctx.mark_non_differentiable(ids)
        return vals.redistribute(mesh, keep), ids

    @staticmethod
    def backward(ctx, g, _):
        ids, = ctx.saved_tensors
        mesh, keep = ids.device_mesh, list(ids.placements)
        block = g.redistribute(mesh, keep)._local_tensor
        block = torch.zeros_like(block).scatter(ctx.dim, ids._local_tensor,
                                                block)
        return _placed(block, mesh, keep, g.shape), None, None, None


def _top_k_whole(func, args, kwargs):
    """A sort of a DTensor split anywhere — the port's top-k (``moe._top_k``
    sorts and keeps the first k) — partitioned as XLA partitions the
    TopK the reference's ``lax.top_k`` lowers to: its operand gathered
    whole on every rank (the reference's all-gather of each token's
    expert scores), sorted there, each rank keeping its block of the
    results (a slice: nothing moves), its backward on the blocks
    (``_SortWhole``).  None for any other op."""
    from torch.distributed.tensor import DTensor
    x = args[0] if args else None
    if func not in (torch.sort, torch.Tensor.sort) \
            or not isinstance(x, DTensor) \
            or not any(q.is_shard() for q in x.placements):
        return None
    names = ("dim", "descending", "stable")
    given = dict(zip(names, args[1:]), **kwargs)
    dim = given.get("dim", -1) % x.ndim
    if any(q.is_shard(dim) for q in x.placements):
        return None
    return torch.return_types.sort(_SortWhole.apply(
        x, dim, given.get("descending", False),
        given.get("stable", False) or False))


def _sorted_whole(func, args, kwargs):
    """A sort or argsort of a DTensor along a dim that several mesh dims
    split (the decode's dispatch: its 1,024 expert ids over "pod" x
    "data"), as XLA partitions it: the operand gathered over them in
    one all-gather (``_whole_over``), sorted whole on every rank.
    None for any other op (DTensor gathers a dim split over one)."""
    from torch.distributed.tensor import DTensor
    x = args[0] if args else None
    if func not in (torch.sort, torch.Tensor.sort, torch.argsort,
                    torch.Tensor.argsort) or not isinstance(x, DTensor):
        return None
    dim = dict(zip(("dim",), args[1:]), **kwargs).get("dim", -1) % x.ndim
    if sum(q.is_shard(dim) for q in x.placements) < 2:
        return None
    return func(_whole_over(x, range(x.device_mesh.ndim)), *args[1:],
                **kwargs)


def partial_scatter_add(func, args):
    """A ``scatter_add`` into a DTensor replicated along the scattered dim
    of an index and source split along it (the router's expert counts
    over the rank's tokens), as GSPMD partitions it: each rank adds its
    block into the operand (the first rank of each group into its
    values, the others into zeros), and the partial sums are all-reduced
    over the mesh dims that split the index.  None for any other op."""
    from torch.distributed.tensor import DTensor, Partial, Replicate
    if not _GSPMD.active or func is not torch.ops.aten.scatter_add.default:
        return None
    x, dim, index, src = args[:4]
    if not (isinstance(index, DTensor) and isinstance(src, DTensor)):
        return None
    mesh = index.device_mesh
    if not isinstance(x, DTensor):          # a plain tensor: replicated
        x = DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                               run_check=False)
    dim %= x.ndim
    placements, first = [], True
    coord = mesh.get_coordinate()
    for m, (qx, qi, qs) in enumerate(zip(x.placements, index.placements,
                                         src.placements)):
        if qx.is_replicate() and qi.is_shard(dim) and qs == qi:
            placements.append(Partial())
            first = first and coord[m] == 0
        elif qx == qi == qs and (qx.is_replicate()
                                 or qx.is_shard() and qx.dim != dim):
            placements.append(qx)
        else:
            return None
    if not any(q.is_partial() for q in placements):
        return None
    block = x._local_tensor
    if not first:
        block = torch.zeros_like(block)
    out = torch.scatter_add(block, dim, index._local_tensor,
                            src._local_tensor)
    out = _placed(out, mesh, placements, x.shape)
    return out.redistribute(mesh, [Replicate() if q.is_partial() else q
                                   for q in placements])


def _free_dims(mesh, dims, ts) -> Tuple[int, ...]:
    """Every mesh dim outside ``dims`` on which each DTensor of ``ts`` is
    replicated, major first (the long-context decode's "data", and
    "pod" on the 2x16x16 mesh, which its batch of one leaves free)."""
    return tuple(f for f in range(mesh.ndim) if f not in dims
                 and all(t.placements[f].is_replicate() for t in ts))


def _free_dim(mesh, m: int, ts) -> Optional[int]:
    """A mesh dim of ``_free_dims`` of ``m``'s size, or None."""
    return next((f for f in _free_dims(mesh, (m,), ts)
                 if mesh.size(f) == mesh.size(m)), None)


def _einsum_args(func, args):
    """(subscripts, operands) of ``torch.einsum(eq, *ops)`` or of
    ``torch.matmul(x, w)`` with a 2-dim ``w`` (as ``"..l,lm->..m"``), or
    None for anything else."""
    if func is torch.einsum:
        ops = list(args[1:])
        if len(ops) == 1 and isinstance(ops[0], (list, tuple)):
            ops = list(ops[0])
        eq = args[0].replace(" ", "") if isinstance(args[0], str) else ""
        if "->" not in eq or "." in eq:
            return None
        return eq, ops
    if func in _PRODUCTS and len(args) == 2 and args[1].ndim == 2 \
            and args[0].ndim >= 2:
        lead = "abcdefghijklmnopqrstuvwx"[:args[0].ndim - 1]
        return f"{lead}y,yz->{lead}z", list(args)
    return None


def _whole_over_free(eq, ops):
    """A product whose operands split different letters over one mesh dim
    (decode attention's scores: the queries' heads and the cache's
    sequence, both over "model", on gemma2-27b and recurrentgemma-9b
    long_500k), as GSPMD partitions it: the smaller operand's split
    moved to a free mesh dim of that size (a collective-permute, the
    reference's f32[1,1,1,2,128] a layer) and gathered there (an
    all-gather), so the larger keeps its split; where the free mesh
    dims together have more ranks than the conflicting one ("pod" x
    "data" on the 2x16x16 mesh), gathered by way of all of them
    (``_whole_by_free_dims``; ``_free_for``).  The operands as they are
    where there is no such conflict or no free mesh dim."""
    from torch.distributed.tensor import DTensor, Replicate
    if not ops or not all(isinstance(x, DTensor) for x in ops) \
            or factored_axes(ops[0].device_mesh):
        return ops
    subs = eq.split("->")[0].split(",")
    mesh = ops[0].device_mesh
    if len(subs) != len(ops):
        return ops
    for m in range(mesh.ndim):
        split = [i for i, x in enumerate(ops) if x.placements[m].is_shard()]
        if len({subs[i][ops[i].placements[m].dim] for i in split}) < 2:
            continue
        small = min(split, key=lambda i: ops[i].numel())
        x = ops[small]
        if sum(q.is_shard() for q in x.placements) != 1:
            return ops
        ops = list(ops)
        free = _free_for(mesh, (m,), ops)
        if free is None:
            return ops
        if len(free) > 1:
            ops[small] = _whole_by_free_dims(x, m, free)
            return ops
        f = free[0]
        moved = list(x.placements)
        moved[m], moved[f] = Replicate(), moved[m]
        ops[small] = _move_split(x, (m,), (f,), moved).redistribute(
            mesh, [Replicate()] * mesh.ndim)
        return ops
    return ops


def _whole_by_free_dims(x, m: int, free):
    """``x``, split along one dim over the mesh dim ``m`` alone, made whole
    by way of the free mesh dims ``free``, whose ranks are p > 1 times
    ``m``'s, as GSPMD does it (the reference's gemma2-27b and
    recurrentgemma-9b long_500k on the 2x16x16 mesh, each layer's
    queries: "pod" x "data", 32 ranks, against "model"'s 16 blocks):

      * the blocks regrouped over ``m`` onto its first 1/p ranks, rank t
        taking blocks p t .. p t + p - 1 (p collective-permutes, a rank
        that takes none sending to itself) and keeping the one of its
        index over the free dims' major ranks;
      * moved so that the rank at index i over ``free`` holds block i,
        whatever its index over ``m`` (one collective-permute: with the
        two before, the reference's three f32[1,1,1,2,128] a layer);
      * gathered over ``free`` at once by an all-reduce of the blocks
        padded with zeros, a rank past the last block adding zeros (its
        f32[1,1,16,2,128] all-reduce over the 32), not by an all-gather
        over one free dim of ``m``'s ranks (``_whole_over_free``'s way
        where the free dims have no more ranks than ``m``)."""
    from torch.distributed.tensor import Partial, Replicate
    mesh, d = x.device_mesh, x.placements[m].dim
    n = mesh.size(m)
    p = math.prod(mesh.size(f) for f in free) // n
    coord = list(mesh.get_coordinate())
    mi, fi = coord[m], _flat_coordinate(mesh, free, coord)

    def rank(at_m, at_free):
        c = list(coord)
        c[m] = at_m
        for f in reversed(free):
            c[f], at_free = at_free % mesh.size(f), at_free // mesh.size(f)
        return _flat_coordinate(mesh, range(mesh.ndim), c)

    def permute(block, to, frm):
        rows = block.movedim(d, 0).contiguous()
        send, recv = [0] * mesh.size(), [0] * mesh.size()
        send[to] = recv[frm] = rows.shape[0]
        rows = _funcol().wait_tensor(_funcol().all_to_all_single(
            rows, recv, send, _mesh_group(mesh)))
        return rows.movedim(0, d)

    block = x._local_tensor
    kept = block
    for j in range(p):
        got = permute(block, rank(mi // p if mi % p == j else mi, fi),
                      rank(p * mi + j if mi < n // p else mi, fi))
        if mi < n // p and j == fi // n:
            kept = got
    # the rank at (mi, fi) sends to index mi p + fi // n over the free
    # dims, fi % n over m; so the rank at (mi', fi') takes from
    # (fi' // p, (fi' % p) n + mi')
    moved = permute(kept, rank(fi % n, mi * p + fi // n),
                    rank(fi // p, (fi % p) * n + mi))
    size = block.shape[d]
    whole = torch.zeros(x.shape, dtype=block.dtype, device=block.device)
    if fi < n:
        whole.narrow(d, fi * size, size).copy_(moved)
    return _placed(whole, mesh, [Partial() if k in free else Replicate()
                                 for k in range(mesh.ndim)], x.shape) \
        .redistribute(mesh, [Replicate()] * mesh.ndim)


def product_as(like: torch.Tensor, func, *args) -> torch.Tensor:
    """``func(*args)``, a product (``torch.matmul`` or ``torch.einsum``)
    whose output, of ``like``'s shape, its users take laid out as
    ``like`` is: RG-LRU's gates ``xc @ w_a``, multiplied into ``xc``;
    decode attention's value product, whose heads the output projection
    takes split as the queries' were.  GSPMD gives a product's output
    the sharding its users want (its sharding propagation runs both
    ways); the walk meets the users only after the product, so the model
    names it here.  Under ``gspmd_partitioning``, where the product
    contracts a dim split over the mesh dim that splits ``like``'s dim
    of the output (``_wanted_split``), it is partitioned as GSPMD
    partitions it: where the operands and ``like`` are whole over
    another mesh dim of that size (the long-context decode's "data"),
    by ``_split_partial``; else its forward is ``func(*args)`` and its
    backward gathers the output's gradient (``_GatheredCotangent``).
    Anywhere else it is ``func(*args)``."""
    if _GSPMD.active and is_distributed(like) \
            and factored_axes(like.device_mesh):
        parsed = _einsum_args(func, args)
        if parsed is not None:
            planned = _gathered_contraction(*parsed, like)
            if planned is not None:
                ops, gathered = planned
                if gathered and torch.is_grad_enabled() \
                        and any(x.requires_grad for x in ops):
                    return _RegatheredEinsum.apply(parsed[0], gathered,
                                                   *ops)
                ops = [_whole_over(x, gathered[i]) if i in gathered else x
                       for i, x in enumerate(ops)]
                return func(*args[:len(args) - len(ops)], *ops)
    if _GSPMD.active and is_distributed(like):
        found = _wanted_split(like, func, args)
        if found is not None:
            eq, ops, m, letter = found
            f = _free_dim(like.device_mesh, m, ops + [like])
            if f is not None:
                out = _split_partial(eq, ops, m, letter, f)
                if out is not None:
                    return out
            elif torch.is_grad_enabled():
                prefix = args[:len(args) - len(ops)]
                return _GatheredCotangent.apply(
                    lambda *ts: func(*prefix, *ts), eq, m, *ops)
    return func(*args)


class _CarriedGrad(torch.autograd.Function):
    """``out`` as it is; in the backward, a zero gradient for each of the
    state ``carries`` a scan step leaves (``carried_grads``)."""

    @staticmethod
    def forward(ctx, out, *carries):
        ctx.save_for_backward(*carries)
        return out.view_as(out)

    @staticmethod
    def backward(ctx, g):
        return (g, *[torch.zeros_like(c) for c in ctx.saved_tensors])


def carried_grads(out, *carries):
    """``out`` — the output of the one scan step the dry run walks for all
    (``cost_analysis.count_as``) — whose backward also sends a gradient
    to the state the step leaves, as the step after it would: the
    reference's scan differentiates each step from the next one's
    state gradient (the mLSTM's chunk state, the sLSTM's cell state),
    the walk's last step has none.  ``out`` as it is outside the dry
    run's autograd."""
    if not (_GSPMD.active and torch.is_grad_enabled()
            and is_distributed(out)
            and any(c.requires_grad for c in carries)):
        return out
    return _CarriedGrad.apply(out, *carries)


def reduced_by_heads(func, *args, heads: int, whole: bool):
    """``func(*args)``, a product that contracts a dim split over a mesh
    axis (an xLSTM block's q, k, v and gates, from its inner dim split
    16 ways over "model"), its partial sums reduced as GSPMD reduces them
    for the users that take its last dim by ``heads`` heads: over the
    factor of the axis that splits the heads (the head view cuts it,
    ``split_factors``), the head then sliced, and over the other factor
    after — or, ``whole=False`` (the head dim split over that other
    factor too), over the whole axis at once, then sliced.  The
    reference's xlstm-125m decode: q and k f32[8,1,1536] all-reduced
    over the 4 of the first factor, then f32[8,1,384] over the other 4;
    v f32[8,1,1536] over all 16.  Where a mesh dim of the axis's size is
    free, by ``_reduced_on_free``.  On a mesh whose axis is not cut, the
    walk is asked to walk again on one cut so (``cost_analysis.cut``).
    ``func(*args)`` anywhere but the dry run."""
    if not (_GSPMD.active and any(is_distributed(a) for a in args)):
        return func(*args)
    from torch.distributed.tensor import DTensor, Replicate, Shard

    def product(*ops):
        _GSPMD.keep_partial = True
        try:
            return func(*ops)
        finally:
            _GSPMD.keep_partial = False
    parsed = _einsum_args(func, args)
    if parsed is not None and all(isinstance(a, DTensor) for a in args):
        eq, ops = parsed
        ins, o = eq.split("->")
        mesh = ops[0].device_mesh
        placements = _einsum_placements(ins.split(","), o, ops, mesh)
        axis = _partial_axis(mesh, placements) if placements else None
        if axis is not None and len(axis) > 1:
            split = axis[:1] if whole else axis
            if _free_for(mesh, axis, ops) is not None:
                return _reduced_on_free(func, args, placements, axis,
                                        split)

            def run(*ops):
                out = product(*ops)
                want = list(out.placements)
                for m in split:
                    want[m] = Replicate()
                out = out.redistribute(mesh, want)
                for m in split:
                    want[m] = Shard(out.ndim - 1)
                out = out.redistribute(mesh, want)
                return out.redistribute(mesh, [
                    Replicate() if q.is_partial() else q for q in want])
            if torch.is_grad_enabled() and any(a.requires_grad
                                               for a in args):
                return _GatheredCotangent.apply(run, eq, split, *args)
            return run(*args)
    out = product(*args)
    mesh = out.device_mesh
    ms = _partial_axis(mesh, out.placements)
    if ms is not None and len(ms) == 1:
        from repro_torch.launch import cost_analysis
        size = mesh.size(ms[0])
        if size % heads == 0 and size > heads:
            cost_analysis.cut((mesh.mesh_dim_names[ms[0]],
                               (heads, size // heads)))
    return reduced_product(torch.ops.aten.mm.default, out)


def _partial_axis(mesh, placements) -> Optional[Tuple[int, ...]]:
    """The mesh dims of the one mesh axis over which ``placements`` are
    partial (all of its dims, and no other), or None."""
    axes = [ms for ms in mesh_axes(mesh).values()
            if all(placements[m].is_partial() for m in ms)]
    partial = sum(q.is_partial() for q in placements)
    if len(axes) != 1 or partial != len(axes[0]):
        return None
    return axes[0]


def _reduced_on_free(func, args, placements, ms, split):
    """``reduced_by_heads`` where mesh dims are free to take the axis's
    split (``_free_for``: the long-context decode's "data", or "pod" x
    "data"), as GSPMD partitions it: each
    rank's product only for the block of the output it will hold (its
    weight's columns sliced: nothing moves), the block's partial sums
    all-reduced over the axis's mesh dims ``ms``, and the block moved to
    the rank that holds it (a collective-permute: the reference's
    f32[1,1,384] q and k, f32[1,1,96] v, f32[1,1,2] gates of
    xlstm-125m long_500k)."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    x, w = args
    mesh = x.device_mesh
    n = math.prod(mesh.size(m) for m in split)
    cols = w.shape[-1] // n
    block = func(x._local_tensor, at_use(w)._local_tensor.narrow(-1, 0, cols))
    shape = tuple(x.shape[:-1]) + (cols,)
    block = _placed(block, mesh, placements, shape).redistribute(mesh, [
        Replicate() if m in ms else q for m, q in enumerate(placements)])
    local = block._local_tensor.contiguous()
    splits = [local.shape[0]] + [0] * (mesh.size() - 1)
    moved = _funcol().wait_tensor(_funcol().all_to_all_single(
        local, splits, splits, _mesh_group(mesh)))
    want = [Shard(len(shape) - 1) if m in split else
            (Replicate() if m in ms else q)
            for m, q in enumerate(placements)]
    return _placed(moved, mesh, want, tuple(x.shape[:-1]) + (w.shape[-1],))


def _gathered_contraction(eq, ops, like):
    """``product_as``'s operands on a mesh with a factored axis where
    ``like`` splits an output letter over a mesh dim on which an operand
    splits a contracted letter and the others are whole (the sLSTM's
    recurrent product: the state's head dim split over the second
    factor of "model", the output's gate dim wanted there): as GSPMD
    partitions it, that operand gathered over the mesh dim (an
    all-gather: the reference's f32[8,1,192] a layer of xlstm-125m
    decode_32k) and the others sliced to the wanted letter (nothing
    moves), so the product runs on blocks with its output split as
    ``like``.  Returns the operands (the others sliced) and, by
    operand, the mesh dims to gather it over; None where no mesh dim
    is so."""
    from torch.distributed.tensor import DTensor, Shard
    ins, out = eq.split("->")
    subs = ins.split(",")
    if len(subs) != len(ops) or not all(isinstance(x, DTensor) for x in ops):
        return None
    ops, gathered, cut = list(ops), {}, set()
    wanted = {m: out[q.dim] for m, q in enumerate(like.placements)
              if type(q) is Shard}
    for m, letter in wanted.items():
        split = [i for i, (sub, x) in enumerate(zip(subs, ops))
                 if type(x.placements[m]) is Shard
                 and sub[x.placements[m].dim] not in out]
        if len(split) != 1 or any(
                not x.placements[m].is_replicate()
                for i, x in enumerate(ops) if i not in split) \
                or not any(letter in sub for i, sub in enumerate(subs)
                           if i not in split):
            continue
        i = split[0]
        x = ops[i]
        axis = next(d for d in mesh_axes(x.device_mesh).values() if m in d)
        free = _free_for(x.device_mesh, axis, ops + [like])
        if free is not None and x.shape[x.placements[m].dim] % math.prod(
                x.device_mesh.size(f) for f in free) == 0:
            ops[i] = _gathered_on_free(x, m, free)
        else:
            gathered.setdefault(i, []).append(m)
        cut.add(m)
    if not cut:
        return None
    # the whole operands cut to each letter ``like`` splits, over the mesh
    # dims just freed and those where another operand splits it (the
    # sLSTM's ``r`` to the state's head and the gates' block), keeping
    # their gradients so cut
    for m, letter in wanted.items():
        if m not in cut and not any(
                type(x.placements[m]) is Shard
                and sub[x.placements[m].dim] == letter
                for sub, x in zip(subs, ops)):
            continue
        for j, (sub, y) in enumerate(zip(subs, ops)):
            if letter in sub and y.placements[m].is_replicate():
                ops[j] = _SlicedKeepingGrad.apply(y, tuple(
                    Shard(sub.index(letter)) if k == m else q
                    for k, q in enumerate(y.placements)))
    return ops, {i: tuple(ms) for i, ms in gathered.items()}


class _RegatheredEinsum(torch.autograd.Function):
    """``torch.einsum(eq, *ops)`` with the operands ``gathered`` names
    (index -> mesh dims) gathered over those mesh dims for it, as the
    reference's partition differentiates such a product: each operand's
    gradient the product of the output's gradient and the others, a
    gathered operand's (its partial sums reduced where made) sliced
    back to its split; and the gathered operands gathered again for the
    others' gradients (XLA keeps the block: the reference's sLSTM
    backward all-gathers the f32[16,1,192] state once more each step of
    xlstm-125m train_4k)."""

    @staticmethod
    def forward(ctx, eq, gathered, *ops):
        ctx.eq, ctx.gathered = eq, gathered
        ctx.save_for_backward(*ops)
        return torch.einsum(eq, *[_whole_over(x, gathered[i])
                                  if i in gathered else x
                                  for i, x in enumerate(ops)])

    @staticmethod
    def backward(ctx, g):
        ops = ctx.saved_tensors
        ins, out = ctx.eq.split("->")
        subs = ins.split(",")
        whole = [_whole_over(x, ctx.gathered[i]) if i in ctx.gathered
                 else x for i, x in enumerate(ops)]
        grads = []
        for i, sub in enumerate(subs):
            if not ctx.needs_input_grad[2 + i]:
                grads.append(None)
                continue
            rest = [j for j in range(len(ops)) if j != i]
            eq = ",".join([out] + [subs[j] for j in rest]) + "->" + sub
            d = torch.einsum(eq, g, *[whole[j] for j in rest])
            if i in ctx.gathered:
                d = d.redistribute(d.device_mesh, ops[i].placements)
            grads.append(d)
        return (None, None, *grads)


class _SlicedKeepingGrad(torch.autograd.Function):
    """A DTensor sliced to ``placements`` (a replicated operand cut to the
    split its product wants: nothing moves) whose gradient keeps that
    split, as the reference's partition keeps the gradient of the
    sLSTM's recurrent weight ``r``, f32[1,192,192] a device, reduced
    over "data" alone (DTensor would gather it back whole)."""

    @staticmethod
    def forward(ctx, x, placements):
        return x.redistribute(x.device_mesh, list(placements))

    @staticmethod
    def backward(ctx, g):
        return g, None


def _gathered_on_free(x, m: int, free):
    """``x`` made whole over the mesh dim ``m`` that splits one of its dims
    by way of the free mesh dims ``free`` (``_free_for``: the
    long-context decode's "data", or "pod" x "data"), as GSPMD does it:
    each rank's block re-cut to ``free``'s blocks of that dim (a
    collective-permute of one: the reference's f32[1,1,12] sLSTM state
    of xlstm-125m long_500k, f32[1,1,6] on the 2x16x16 mesh), then
    gathered over ``free`` (an all-gather, its f32[1,1,192], over the 32
    at once on 2x16x16)."""
    from torch.distributed.tensor import Replicate, Shard
    mesh, d = x.device_mesh, x.placements[m].dim
    size = x.shape[d] // math.prod(mesh.size(f) for f in free)
    piece = x._local_tensor.narrow(d, 0, size).movedim(d, 0).contiguous()
    splits = [size] + [0] * (mesh.size() - 1)
    piece = _funcol().wait_tensor(_funcol().all_to_all_single(
        piece, splits, splits, _mesh_group(mesh))).movedim(0, d)
    placements = [Shard(d) if k in free else (Replicate() if k == m else q)
                  for k, q in enumerate(x.placements)]
    return _whole_over(_placed(piece, mesh, placements, tuple(x.shape)),
                       free)


def _wanted_split(like, func, args):
    """(subscripts, operands, m, letter) of ``product_as``'s product where
    it contracts a letter split over the mesh dim ``m`` (in each operand
    that has it) and ``like`` splits the output's ``letter`` over ``m``;
    None elsewhere (a plain operand, a factored mesh)."""
    from torch.distributed.tensor import DTensor, Shard
    parsed = _einsum_args(func, args)
    if parsed is None:
        return None
    eq, ops = parsed
    if not ops or not all(isinstance(x, DTensor) for x in ops) \
            or factored_axes(like.device_mesh):
        return None
    ins, out = eq.split("->")
    subs = ins.split(",")
    size = {c: n for sub, x in zip(subs, ops) for c, n in zip(sub, x.shape)}
    if len(subs) != len(ops) or tuple(size[c] for c in out) \
            != tuple(like.shape):
        return None
    for m, want in enumerate(like.placements):
        if type(want) is not Shard:
            continue
        contracted = {sub[x.placements[m].dim] for sub, x in zip(subs, ops)
                      if type(x.placements[m]) is Shard}
        if len(contracted) == 1 and not contracted & set(out) \
                and all(x.placements[m].is_replicate()
                        or sub[x.placements[m].dim] in contracted
                        for sub, x in zip(subs, ops)):
            return eq, ops, m, out[want.dim]
    return None


def _split_partial(eq, ops, m, letter, f):
    """``product_as``'s product as GSPMD partitions it where the output's
    wanted mesh dim ``m`` also splits the contracted dim and the mesh dim
    ``f`` of ``m``'s size is free: the output's ``letter`` split over
    ``f`` instead (a slice of the operands that have it: nothing moves),
    the product run on the blocks, its partial sums over ``m``
    all-reduced (a block's worth: the reference's f32[1,1,256] gates and
    f32[1,1,128,1,2] attention outputs), and the split moved from ``f``
    to ``m`` (a collective-permute).  None where ``f`` does not divide
    the letter."""
    from torch.distributed.tensor import Replicate, Shard
    ins, out = eq.split("->")
    subs = ins.split(",")
    mesh = ops[0].device_mesh
    size = {c: n for sub, x in zip(subs, ops) for c, n in zip(sub, x.shape)}
    if size[letter] % mesh.size(f):
        return None
    ops = [x.redistribute(mesh, [
        Shard(sub.index(letter)) if k == f else q
        for k, q in enumerate(x.placements)]) if letter in sub else x
        for sub, x in zip(subs, ops)]
    placements = _einsum_placements(subs, out, ops, mesh)
    if placements is None or not placements[m].is_partial():
        return None
    y = _BlockEinsum.apply(eq, placements, *ops)
    y = y.redistribute(mesh, [Replicate() if q.is_partial() else q
                              for q in y.placements])
    moved = list(y.placements)
    moved[m], moved[f] = moved[f], Replicate()
    return _move_split(y, (f,), (m,), moved)


class _GatheredCotangent(torch.autograd.Function):
    """``product_as``'s product where no mesh dim is free (the training
    step's batch takes "data"), and ``reduced_by_heads``'s: the forward
    is ``run`` (the product, its partial sums reduced), and the backward
    takes the output's gradient, split over the mesh dim(s) ``m`` as
    its users left it, whole over them for each operand's product on
    its own (an all-gather each, as GSPMD partitions each transposed
    product: the reference's two f32[16,4096,4096] all-gathers of each
    RG-LRU gate's gradient, and two f32[16,4096,1536] of each of
    xlstm-125m's q, k and v), so that neither product reduces an
    activation."""

    @staticmethod
    def forward(ctx, run, eq, m, *ops):
        ctx.eq, ctx.m = eq, m
        ctx.save_for_backward(*ops)
        return run(*ops)

    @staticmethod
    def backward(ctx, g):
        from torch.distributed.tensor import Replicate
        ops = ctx.saved_tensors
        ins, out = ctx.eq.split("->")
        subs = ins.split(",")
        over = (ctx.m,) if isinstance(ctx.m, int) else tuple(ctx.m)
        grads = []
        for i, sub in enumerate(subs):
            if not ctx.needs_input_grad[3 + i]:
                grads.append(None)
                continue
            whole = g.redistribute(g.device_mesh, [
                Replicate() if k in over else q
                for k, q in enumerate(g.placements)])
            rest = [j for j in range(len(ops)) if j != i]
            eq = ",".join([out] + [subs[j] for j in rest]) + "->" + sub
            grads.append(torch.einsum(eq, whole, *[ops[j] for j in rest]))
        return (None, None, None, *grads)


def _take_split(func, args) -> None:
    """An in-place op outside autograd (the optimizer's update) on a
    DTensor replicated over a mesh dim on which an operand of its shape
    is split, as XLA runs the reference's functional update: its result
    takes the operand's split (RG-LRU's ``b_a``, ``b_i`` and ``lam``,
    whose gradients the gates' split leaves split over "model", and
    their moments leave the step split, each a (256,) block where the
    parameter came in whole).  The DTensor is rebound to that block of
    itself (a slice: nothing moves) before the op runs on it; the dry
    run reads each leaf's argument block from before the step
    (``launch.dryrun.step_memory``)."""
    from torch.distributed.tensor import DTensor, Shard
    name = getattr(func, "__name__", "")
    if not name.endswith("_") or name.startswith("_") \
            or torch.is_grad_enabled() or not args \
            or not isinstance(args[0], DTensor):
        return
    x = args[0]
    want = list(x.placements)
    for o in args[1:]:
        if isinstance(o, DTensor) and o.shape == x.shape:
            for m, (qx, qo) in enumerate(zip(x.placements, o.placements)):
                if qx.is_replicate() and type(qo) is Shard:
                    want[m] = qo
    if want == list(x.placements):
        return
    moved = x.redistribute(x.device_mesh, want)     # a slice
    base = x._base
    if isinstance(base, DTensor) and tuple(base.shape[1:]) == x.shape:
        # a layer of a stacked leaf (an optimizer moment): the stack
        # takes the split, and the layer is its block of the stack's
        old = base._local_tensor
        at = (x._local_tensor.storage_offset() - old.storage_offset()) \
            // max(old.stride(0), 1)
        stack = base.redistribute(base.device_mesh, [
            Shard(w.dim + 1) if w != q else b
            for w, q, b in zip(want, x.placements, base.placements)])
        base._local_tensor, base._spec = stack._local_tensor, stack._spec
        x._local_tensor, x._spec = stack._local_tensor[at], moved._spec
        return
    x._local_tensor, x._spec = moved._local_tensor, moved._spec


class _Gspmd(threading.local):
    active = False
    keep_partial = False      # ``reduced_by_heads``: a product's sums kept
    table_lookup = False      # ``lookup_by_table``


@contextlib.contextmanager
def lookup_by_table():
    """Embedding lookups inside take the table to the tokens
    (``_table_for_lookup``), not the tokens to the table: the model's
    word that its residual is carried split over the vocab's axis (an
    xLSTM stack, ``models.ssm.carried``), the layout that route leaves
    the lookup in.  Nothing changes outside the dry run."""
    prev = _GSPMD.table_lookup
    _GSPMD.table_lookup = True
    try:
        yield
    finally:
        _GSPMD.table_lookup = prev


_GSPMD = _Gspmd()

# what an op reads from a placed weight's stored block: its metadata
_STORED_READS = (torch.Tensor.size, torch.Tensor.dim, torch.Tensor.numel,
                 torch.Tensor.stride, torch.Tensor.element_size,
                 torch.Tensor.is_floating_point, torch.Tensor.__len__)


_SPLIT_REDUCTIONS = {torch.softmax: "softmax", torch.Tensor.softmax: "softmax",
                     F.softmax: "softmax", torch.logsumexp: "logsumexp",
                     torch.Tensor.logsumexp: "logsumexp"}


def _split_reduction(func, args, kwargs):
    """A softmax or log-sum-exp over a dim a ``DTensor`` splits, as GSPMD
    partitions it: the split kept, its max and its sum all-reduced
    (DTensor's own strategies gather the dim).  None for any other op."""
    from torch.distributed.tensor import DTensor
    kind = _SPLIT_REDUCTIONS.get(func)
    x = args[0] if args else None
    dim = kwargs.get("dim", args[1] if len(args) > 1 else None)
    if kind is None or not isinstance(x, DTensor) \
            or not isinstance(dim, int) or kwargs.get("dtype") is not None \
            or not any(q.is_shard(dim % x.ndim) for q in x.placements):
        return None
    m = torch.amax(x, dim=dim, keepdim=True).detach()
    e = torch.exp(x - m)
    if kind == "softmax":
        return e / torch.sum(e, dim=dim, keepdim=True)
    lse = torch.log(torch.sum(e, dim=dim, keepdim=True)) + m
    return lse if kwargs.get("keepdim", False) else lse.squeeze(dim)


class _GspmdOps(TorchFunctionMode):
    """The ops of the dry run's step as GSPMD partitions them: each op
    run under autograd reads a placed weight as it uses it (``at_use``;
    a cast of it as the op that uses the cast does, ``_cast_at_use``),
    but for ``_STORED_READS`` (the optimizer's update, without autograd,
    reads the stored block), a product with a weight may contract over
    its split (``_contract_split``), a softmax or log-sum-exp keeps a
    split dim split (``_split_reduction``), a sort takes its operand
    whole (``_top_k_whole``) and a gather of one entry a row takes its
    gradient on the operand's blocks (``gathered_on_blocks``)."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        from torch.utils._pytree import tree_map
        kwargs = kwargs or {}
        if func is torch.Tensor.backward:
            # the engine run with this mode (popped while its own handler
            # runs) pushed again: the backward pass recomputes the
            # rematerialized blocks, whose weights it gathers too
            with _GspmdOps():
                return _run_backward(*args, **kwargs)
        _take_split(func, args)
        out = _split_reduction(func, args, kwargs)
        if out is None:
            out = _top_k_whole(func, args, kwargs)
        if out is None:
            out = _sorted_whole(func, args, kwargs)
        if out is None:
            out = gathered_on_blocks(func, args, kwargs)
        if out is not None:
            return out
        if torch.is_grad_enabled() and func not in _STORED_READS \
                and getattr(func, "__name__", "") not in ("__get__",
                                                          "__set__"):
            if _hoisting():
                if func in _CASTS and getattr(args[0], "fsdp_dims", ()):
                    return _cast_at_use(func, args, kwargs)
                out = _contract_split(func, args)
                if out is not None:
                    return out
            # an embedding lookup takes a token's row from the table's
            # block, moved to its use axis but not gathered: the
            # reference's partition gathers the tokens instead (its
            # s32[256,4096,1] all-gather of gemma2-2b train_4k)
            gather = func is not F.embedding
            args, kwargs = tree_map(lambda x: _read(x, gather),
                                    (args, kwargs))
        if func in _PRODUCTS and len(args) == 2:
            out = _input_whole_product(func, *args)
            if out is not None:
                return out
        if func is torch.einsum:
            args = _einsum_operands(args)
            parsed = _einsum_args(func, args)
            ops = _whole_over_free(*parsed) if parsed else None
            if parsed and ops is not parsed[1]:
                args = (parsed[0], *ops)
            out = _einsum_on_blocks(args)
            if out is not None:
                return out
        if func is F.embedding:
            if _GSPMD.table_lookup:
                args = (args[0], _table_for_lookup(args[0], args[1])) \
                    + tuple(args[2:])
            else:
                tokens = _tokens_for_lookup(args[0], args[1])
                if tokens is args[0]:
                    args = (tokens, _table_for_lookup(
                        tokens, args[1], single=False)) + tuple(args[2:])
                else:
                    args = (tokens,) + tuple(args[1:])
        return func(*args, **kwargs)


_CASTS = (torch.Tensor.to, torch.Tensor.float, torch.Tensor.bfloat16,
          torch.Tensor.half, torch.Tensor.double, torch.Tensor.type_as)
_PRODUCTS = (torch.matmul, torch.Tensor.matmul, torch.Tensor.__matmul__)


def _input_whole_product(func, x, w):
    """``x @ w`` where ``x`` splits the contracted dim over the mesh dims
    that split ``w``'s output dim (an xLSTM residual split over "model"
    into a projection whose columns "model" splits), as GSPMD
    partitions it: ``x`` gathered over them (the reference's
    f32[2,32768,768] all-gather before each of xlstm-125m prefill_32k's
    up projections), so that the product's output keeps the weight's
    split (``_RegatheredInput`` under autograd); DTensor would rather
    move the weight to its rows and all-reduce the product.  Where mesh
    dims are free to take the split (``_free_for``: the long-context
    decode's "data", or "pod" x "data" on the 2x16x16 mesh), the split
    moved there (a collective-permute), then either
    contracted there (its partial sums all-reduced: the reference's
    f32[1,1,192] of xlstm-125m long_500k's up projections, over the 32
    of "pod" x "data" on 2x16x16) or gathered there (the unembedding's
    f32[1,1,768]), whichever moves less.  None for any other product."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    if not (isinstance(x, DTensor) and isinstance(w, DTensor)) \
            or w.ndim != 2 or x.ndim < 2:
        return None
    k = x.ndim - 1
    over = [m for m, q in enumerate(x.placements) if q.is_shard(k)]
    if not over or not all(w.placements[m].is_shard(1)
                           and type(w.placements[m]) is type(x.placements[m])
                           for m in over):
        return None
    mesh = x.device_mesh
    free = _free_for(mesh, over, (x, w))
    if free is not None:
        moved = [x.placements[over[0]] if m in free else
                 (Replicate() if m in over else q)
                 for m, q in enumerate(x.placements)]
        x = _move_split(x, tuple(over), free, moved)
        # the product's block against the input gathered, a row each
        if w._local_tensor.shape[-1] < x.shape[-1]:
            return func(x, w.redistribute(mesh, [
                Shard(0) if m in free else q
                for m, q in enumerate(w.placements)]))
        over = list(free)
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return _RegatheredInput.apply(x, w, tuple(over))
    return func(_whole_over(x, over), w)


def _whole_over(x, over):
    """``x`` gathered over the mesh dims ``over`` (an all-gather; a dim
    that several mesh axes' dims of them split evenly, and no other,
    over those at once, as XLA gathers a dim split over "pod" x "data";
    any other split by DTensor, a factored axis's merged by
    ``cost_analysis.factor_batch``)."""
    from torch.distributed.tensor import Replicate
    mesh, placements = x.device_mesh, list(x.placements)
    axis = {m: a for a, ms in mesh_axes(mesh).items() for m in ms}
    for d in range(x.ndim):
        dims = [m for m in over if placements[m].is_shard(d)]
        if len({axis[m] for m in dims}) > 1 \
                and dims == [m for m, q in enumerate(placements)
                             if q.is_shard(d)] \
                and x.shape[d] % math.prod(mesh.size(m) for m in dims) == 0:
            block = _all_gather(x._local_tensor, d, _dims_group(mesh, dims))
            for m in dims:
                placements[m] = Replicate()
            x = _placed(block, mesh, placements, x.shape)
    return x.redistribute(mesh, [
        Replicate() if m in over else q for m, q in enumerate(placements)])


class _RegatheredInput(torch.autograd.Function):
    """``_input_whole_product``'s product under autograd, as the
    reference's partition differentiates it: forward, ``x`` gathered
    over ``over`` and the product run on the blocks; backward, ``x``'s
    gradient the product of the output's gradient and the weight, its
    partial sums all-reduced and sliced to ``x``'s split, and the
    weight's gradient from ``x`` gathered again (XLA keeps the block,
    not the gathered activation: the reference's backward all-gathers
    f32[16,4096,768] once more before each such weight gradient of
    xlstm-125m train_4k)."""

    @staticmethod
    def forward(ctx, x, w, over):
        ctx.save_for_backward(x, w)
        ctx.over = over
        return torch.matmul(_whole_over(x, over), w)

    @staticmethod
    def backward(ctx, g):
        from torch.distributed.tensor import Replicate
        x, w = ctx.saved_tensors
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = torch.matmul(g, w.t())
            if any(q.is_partial() for q in dx.placements):
                dx = dx.redistribute(dx.device_mesh, [
                    Replicate() if q.is_partial() else q
                    for q in dx.placements])
            dx = dx.redistribute(dx.device_mesh, x.placements)
        if ctx.needs_input_grad[1]:
            whole = _whole_over(x, ctx.over)
            dw = torch.matmul(whole.reshape(-1, whole.shape[-1]).t(),
                              g.reshape(-1, g.shape[-1]))
        return dx, dw, None


def _free_for(mesh, dims, ts) -> Optional[Tuple[int, ...]]:
    """The mesh dims outside ``dims`` on which every DTensor of ``ts`` is
    replicated, to take a split over ``dims`` (the long-context decode's,
    which its batch of one leaves free): all of them where there are
    several and their ranks are p > 1 times ``dims``' ("pod" x "data", 32
    ranks, against "model"'s 16 on the 2x16x16 mesh), else one of
    ``dims``' size ("data" on the 16x16 mesh), else None."""
    size = math.prod(mesh.size(m) for m in dims)
    free = _free_dims(mesh, dims, ts)
    ranks = math.prod(mesh.size(f) for f in free)
    if len(free) > 1 and ranks > size and ranks % size == 0:
        return free
    return next(((f,) for f in free if mesh.size(f) == size), None)


def _hoisting() -> bool:
    """Whether a scan step whose weight reads are loop-invariant (the
    MoE's chunks) runs (``cost_analysis.count_as(..., hoist=True)``)."""
    from repro_torch.launch import cost_analysis
    return cost_analysis.hoisting()


def _hoisted():
    """The context a weight's read runs in: in such a scan step, counted
    once for the loop (``cost_analysis.loop_invariant``)."""
    from repro_torch.launch import cost_analysis
    return cost_analysis.loop_invariant() if _hoisting() \
        else contextlib.nullcontext()


def _cast_at_use(func, args, kwargs):
    """A cast of a placed weight in such a scan step: the cast of its
    stored block (no collective), which the op that uses it reads as the
    cast of the weight read at that use (``_read``: the weight gathered,
    then cast, as ``at_use`` reads it) — where a product contracts over
    the weight's split instead (``_contract_split``), it is not
    gathered."""
    out = func(*args, **kwargs)
    if out is args[0]:
        out = out.view_as(out)
    out._read_at_use = (args[0], func, args[1:], kwargs)
    return out


def _read(x, gather: bool = True):
    """``x`` as an op reads it: a placed weight by ``at_use``, a cast of
    one (``_cast_at_use``) the cast of that read, once."""
    pending = getattr(x, "_read_at_use", None)
    if pending is None:
        if not getattr(x, "fsdp_dims", ()):
            return x
        with _hoisted():
            return at_use(x, gather)
    if getattr(x, "_read", None) is None:
        w, func, args, kwargs = pending
        with _hoisted():
            x._read = func(at_use(w, gather), *args, **kwargs)
    return x._read


def _contract_split(func, args):
    """A product ``x @ w`` of an activation and a cast placed weight whose
    one FSDP dim is the contracted one (the router's ``(d, E)``), where
    the product's block is smaller than the weight gathered: as GSPMD
    partitions it, the weight's split moved to its use axis (a
    collective-permute, ``_use_axes``) but not gathered, the product
    contracted over the split and its partial sums all-reduced
    (``_ContractSplit``; the reference's router logits, all-reduced
    over "model" each chunk).  Where the mesh dims free of both
    outrank the use axis (``_free_for``: "pod" x "model", 32 ranks,
    where a chunk's rows leave "pod" free on the 2x16x16 mesh), the
    split goes to all of them in parts and the product contracts there
    (the reference's f32[224,256] collective-permute of the router a
    layer and its f32[1,4096,256] logits all-reduced over the 32, each
    chunk, of deepseek-v3-671b train_4k).  Only in a scan step whose
    weight reads are loop-invariant (the MoE's chunks); None
    elsewhere."""
    from torch.distributed.tensor import DTensor
    if func not in _PRODUCTS or len(args) != 2:
        return None
    x, w = args
    pending = getattr(w, "_read_at_use", None)
    if pending is None or not isinstance(x, DTensor) \
            or getattr(w, "_read", None) is not None:
        return None
    p = pending[0]
    axes = _use_axes(p, p.fsdp_dims) if p.fsdp_dims == (0,) else None
    if axes is None or p.ndim != 2 or x.shape[-1] != p.shape[0] \
            or any(x.placements[m].is_shard(x.ndim - 1)
                   or not x.placements[m].is_replicate() for m in axes[1]):
        return None
    block = x._local_tensor.numel() // x.shape[-1] * p.shape[1]
    gathered = p.numel() // math.prod(
        p.device_mesh.size(m) for m, q in enumerate(p.placements)
        if q.is_shard(1))
    if block >= gathered:
        return None
    use = _free_for(x.device_mesh, axes[0], (x, p)) or axes[1]
    with _hoisted():
        moved = pending[1](at_use(p, gather=False, use=use), *pending[2],
                           **pending[3])
    return _ContractSplit.apply(x, moved, use, pending, axes)


class _ContractSplit(torch.autograd.Function):
    """``x @ w`` with ``w``'s first dim split over the mesh dims ``use``
    (on which ``x`` is whole): ``x``'s last dim sliced to the blocks
    (nothing moves), the blocks' product, partial over ``use``,
    all-reduced.  The backward: ``x``'s gradient by the weight gathered
    (``pending``: the weight and its cast; a loop-invariant read), and
    ``w``'s from the blocks, partial over the mesh dims that split the
    rows.  Where ``use`` is a group of mesh dims beyond the weight's use
    axis (``axes``: the stored dims and the use axis, ``_use_axes``),
    the weight is gathered over the group at once, and its gradient
    comes from the blocks over the use axis alone, reduced over the
    rows' dims and moved back to the stored dims there (the reference's
    f32[7168,256] all-gather over "pod" x "model" a layer, and each
    chunk's f32[256,448] all-reduce over "data" and collective-permute,
    of deepseek-v3-671b train_4k on the 2x16x16 mesh)."""

    @staticmethod
    def forward(ctx, x, w, use, pending, axes):
        from torch.distributed.tensor import Partial, Replicate, Shard
        mesh = x.device_mesh
        cut = [Shard(x.ndim - 1) if m in use else q
               for m, q in enumerate(x.placements)]
        xs = x.redistribute(mesh, cut)
        y = torch.matmul(xs._local_tensor, w._local_tensor)
        y = _placed(y, mesh, [Partial() if m in use else q
                              for m, q in enumerate(x.placements)],
                    tuple(x.shape[:-1]) + (w.shape[-1],))
        ctx.group = tuple(use) != tuple(axes[1])
        ctx.save_for_backward(x if ctx.group else xs, w)
        ctx.pending, ctx.use, ctx.axes = pending, use, axes
        return y.redistribute(mesh, [Replicate() if m in use else q
                                     for m, q in enumerate(x.placements)])

    @staticmethod
    def backward(ctx, g):
        from torch.distributed.tensor import Partial, Replicate, Shard
        xs, w = ctx.saved_tensors
        p, func, args, kwargs = ctx.pending
        mesh = xs.device_mesh
        from repro_torch.launch import cost_analysis
        with torch.no_grad(), cost_analysis.loop_invariant():
            whole = func(at_use(p, use=ctx.use if ctx.group else None),
                         *args, **kwargs)
        dx = torch.matmul(g, whole.t())
        stored, model = ctx.axes
        if ctx.group:
            xs = xs.redistribute(mesh, [Shard(xs.ndim - 1) if m in model
                                        else q for m, q in
                                        enumerate(xs.placements)])
        rows = g.redistribute(mesh, [Replicate() if m in ctx.use else q
                                     for m, q in enumerate(xs.placements)])
        a = xs._local_tensor.reshape(-1, xs._local_tensor.shape[-1])
        b = rows._local_tensor.reshape(-1, rows._local_tensor.shape[-1])
        dw = torch.matmul(a.t(), b)
        split = {m for m, q in enumerate(xs.placements)
                 if q.is_shard() and q.dim != xs.ndim - 1}
        if not ctx.group:
            dw = _placed(dw, mesh, [Partial() if m in split else q
                                    for m, q in enumerate(w.placements)],
                         tuple(w.shape))
            return dx, dw, None, None, None
        dw = _placed(dw, mesh, [Partial() if m in split else
                                Shard(0) if m in model else Replicate()
                                for m in range(mesh.ndim)], tuple(w.shape))
        dw = dw.redistribute(mesh, [Replicate() if q.is_partial() else q
                                    for q in dw.placements])
        return dx, _move_split(dw, model, stored, list(p.placements)), \
            None, None, None


def _einsum_placements(subs, out, ops, mesh):
    """The placements of ``torch.einsum`` of ``ops`` (subscripts
    ``subs``, output ``out``) run on their blocks, as GSPMD partitions a
    product: over each mesh dim at most one letter is split, in every
    operand that has it; the output is split there if it keeps the
    letter, else partial.  None where the operands disagree."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    placements = []
    for m in range(mesh.ndim):
        letters = set()
        for sub, x in zip(subs, ops):
            q = x.placements[m]
            if type(q) is Shard:
                letters.add(sub[q.dim])
            elif not q.is_replicate():
                return None
        if not letters:
            placements.append(Replicate())
            continue
        if len(letters) > 1:
            return None
        c = letters.pop()
        if any(c in sub and not x.placements[m].is_shard(sub.index(c))
               for sub, x in zip(subs, ops)):
            return None
        placements.append(Shard(out.index(c)) if c in out else Partial())
    return placements


def laid_out_as(t: torch.Tensor, eq: str, *ops) -> torch.Tensor:
    """``t`` (a plain tensor of ``torch.einsum(eq, *ops)``'s shape: a
    scan's zero state) laid out as that product of the DTensors ``ops``
    would leave its output on their blocks (``_einsum_placements``, a
    partial sum as its reduction leaves it): a slice of ``t`` made
    whole on their mesh, nothing moved.  ``t`` as it is where an
    operand is plain or they disagree."""
    from torch.distributed.tensor import DTensor, Replicate
    if not ops or not all(isinstance(x, DTensor) for x in ops):
        return t
    ins, out = eq.split("->")
    mesh = ops[0].device_mesh
    placements = _einsum_placements(ins.split(","), out, ops, mesh)
    if placements is None:
        return t
    return replicated_on(t, mesh).redistribute(mesh, [
        Replicate() if q.is_partial() else q for q in placements])


class _BlockEinsum(torch.autograd.Function):
    """``torch.einsum`` of DTensors run on their blocks, the result placed
    by ``_einsum_placements``; its backward, each operand's gradient, is
    the einsum of the output's gradient and the other operands (run the
    same way)."""

    @staticmethod
    def forward(ctx, eq, placements, *ops):
        from torch.distributed.tensor import DTensor
        ins, out = eq.split("->")
        subs = ins.split(",")
        ctx.eq, ctx.subs, ctx.out = eq, subs, out
        ctx.save_for_backward(*ops)
        size = {c: n for sub, x in zip(subs, ops)
                for c, n in zip(sub, x.shape)}
        shape = torch.Size(size[c] for c in out)
        block = torch.einsum(eq, *[x._local_tensor for x in ops])
        return _placed(block, ops[0].device_mesh, placements, shape)

    @staticmethod
    def backward(ctx, grad):
        ops = ctx.saved_tensors
        grads = []
        for i, sub in enumerate(ctx.subs):
            if not ctx.needs_input_grad[2 + i]:
                grads.append(None)
                continue
            rest = [j for j in range(len(ops)) if j != i]
            eq = ",".join([ctx.out] + [ctx.subs[j] for j in rest]) \
                + "->" + sub
            grads.append(torch.einsum(eq, grad, *[ops[j] for j in rest]))
        return (None, None, *grads)


def _einsum_on_blocks(args):
    """``torch.einsum`` of DTensors whose operands agree, run on their
    blocks (``_BlockEinsum``), on every mesh: DTensor's own einsum
    flattens the batch dims into one (attention's batch over "data" and
    heads over "model"), which torch 2.11 refuses (``_unsafe_view``:
    "Attempted to flatten multiple dimensions") and torch 2.13 splits
    strided.  Only a batched product (a letter in every operand and the
    output: attention's scores and values, MLA's absorbed products);
    a product of a 2-dim weight keeps DTensor's ``mm``, whose gradient
    ``weight_grad_slab`` cuts.  None for any other einsum, and where
    each operand's letters do not all appear in the output or another
    operand (its backward would broadcast)."""
    from torch.distributed.tensor import DTensor
    parsed = _einsum_args(torch.einsum, args)
    if parsed is None:
        return None
    eq, ops = parsed
    if not ops or not all(isinstance(x, DTensor) for x in ops):
        return None
    ins, out = eq.split("->")
    subs = ins.split(",")
    if len(subs) != len(ops) or any(
            c not in out + "".join(t for j, t in enumerate(subs) if j != i)
            for i, sub in enumerate(subs) for c in sub) \
            or not any(all(c in sub for sub in subs) for c in out):
        return None              # a weight's product: DTensor's mm path
    placements = _einsum_placements(subs, out, ops, ops[0].device_mesh)
    if placements is None:
        return None
    y = _BlockEinsum.apply(eq, placements, *ops)
    # its partial sums reduced where made, as GSPMD reduces them (and
    # ``reduced_product`` DTensor's ``bmm``'s)
    if any(q.is_partial() for q in placements):
        from torch.distributed.tensor import Replicate
        y = y.redistribute(y.device_mesh, [
            Replicate() if q.is_partial() else q for q in placements])
    return y


def _table_for_lookup(tokens, table, single: bool = True):
    """The table of an embedding lookup whose vocab one mesh axis splits
    and whose rows the tokens' axis splits, as the reference's partition
    of xlstm-125m train_4k reads it: the two splits swapped (one
    collective-permute of the block, its f32[3144,48]), the vocab then
    gathered over the tokens' axis (an all-gather, f32[50304,48]), so
    that each rank looks its tokens up in its columns and the lookup
    leaves the embedding dim split as the vocab was.  Where the tokens
    split over several axes, the rows' among them (the batch over "pod"
    x "data" on the 2x16x16 mesh, where the reference's gemma2-2b and
    xlstm-125m train_4k read their tables so: f32[16000,144] and
    f32[3144,48] permuted, f32[256000,144] and f32[50304,48] gathered),
    the gradient's partial sums over them all reduced at once (its
    all-reduce over the 32), then sliced (``_ReducedAtOnce``).
    ``single=False``: only so, not where the tokens split over one axis
    (a lookup outside ``lookup_by_table``, whose tokens go to the table
    there: ``_tokens_for_lookup``).  The table as it is for any other
    lookup."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    if not (_GSPMD.active and isinstance(tokens, DTensor)
            and isinstance(table, DTensor)) or table.ndim != 2:
        return table
    axes = list(mesh_axes(table.device_mesh).values())
    vocab = [ms for ms in axes if all(table.placements[m].is_shard(0)
                                      for m in ms)]
    rows = [ms for ms in axes if all(table.placements[m].is_shard(1)
                                     for m in ms)]
    split = [ms for ms in axes if all(type(tokens.placements[m]) is Shard
                                      for m in ms)]
    among = len(rows) == 1 and len(split) > 1 and rows[0] in split
    if len(vocab) != 1 or not (among or single and rows == split
                               and len(split) == 1):
        return table
    a, b = rows[0], vocab[0]
    mesh = table.device_mesh
    if math.prod(mesh.size(m) for m in a) \
            != math.prod(mesh.size(m) for m in b):
        return table
    swapped = list(table.placements)
    for m in a:
        swapped[m] = Shard(0)
    for m in b:
        swapped[m] = Shard(1)
    table = _move_split(table, a, b, swapped)
    whole = [Replicate() if m in a else q for m, q in enumerate(swapped)]
    if among:
        return _ReducedAtOnce.apply(table, whole)
    return table.redistribute(mesh, whole)


class _ReducedAtOnce(torch.autograd.Function):
    """``x`` redistributed to ``placements``; its gradient's partial sums
    all-reduced over every mesh dim at once, then laid out as ``x``
    (DTensor's own backward would reduce-scatter over the dims ``x``
    splits and all-reduce over the rest)."""

    @staticmethod
    def forward(ctx, x, placements):
        ctx.placements = list(x.placements)
        return x.redistribute(x.device_mesh, placements)

    @staticmethod
    def backward(ctx, g):
        from torch.distributed.tensor import Replicate
        mesh = g.device_mesh
        g = g.redistribute(mesh, [Replicate() if q.is_partial() else q
                                  for q in g.placements])
        return g.redistribute(mesh, ctx.placements), None


def _tokens_for_lookup(tokens, table):
    """The token ids of an embedding lookup whose table splits its vocab
    over one mesh axis and its rows over the axis that splits the
    tokens, so that every rank needs every token: their split moved to
    the vocab's axis (one collective-permute) and gathered there, as the
    reference's partition gathers them (gemma2-27b train_4k:
    s32[16,4096,1] permuted, then all-gathered to s32[256,4096,1] over
    "model")."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    if not (_GSPMD.active and isinstance(tokens, DTensor)
            and isinstance(table, DTensor)):
        return tokens
    axes = list(mesh_axes(table.device_mesh).values())
    vocab = [ms for ms in axes if all(table.placements[m].is_shard(0)
                                      for m in ms)]
    split = [ms for ms in axes if all(type(tokens.placements[m]) is Shard
                                      for m in ms)]
    if len(vocab) != 1 or len(split) != 1 or vocab == split:
        return tokens
    a, b = split[0], vocab[0]
    mesh = tokens.device_mesh
    if len({tokens.placements[m].dim for m in a}) != 1 \
            or not all(tokens.placements[m].is_replicate() for m in b) \
            or not all(table.placements[m].is_shard() for m in a) \
            or math.prod(mesh.size(m) for m in a) \
            != math.prod(mesh.size(m) for m in b):
        return tokens
    moved = list(tokens.placements)
    for m in a:
        moved[m] = Replicate()
    for m in b:
        moved[m] = tokens.placements[a[0]]
    return _move_split(tokens, a, b, moved).redistribute(
        mesh, [Replicate()] * mesh.ndim)


def _einsum_operands(args):
    """``torch.einsum``'s arguments with each operand that is replicated
    over a mesh dim on which another operand splits a letter they share
    split there too — a slice, which moves nothing — as GSPMD partitions
    a product: granite's (B,T,8,D) keys, replicated over "model", cut
    over its first factor to the KV head of the rank's queries.  Only on
    a mesh with a factored axis (``launch.mesh.factor_axis``), where
    DTensor's product strategies gather the split operand instead."""
    from torch.distributed.tensor import DTensor, Shard
    eq, ops = args[0], list(args[1:])
    nested = len(ops) == 1 and isinstance(ops[0], (list, tuple))
    if nested:
        ops = list(ops[0])
    xs = [x for x in ops if isinstance(x, DTensor)]
    if not isinstance(eq, str) or "->" not in eq or "." in eq or not xs \
            or not factored_axes(xs[0].device_mesh):
        return args
    subs = eq.replace(" ", "").split("->")[0].split(",")
    if len(subs) != len(ops):
        return args
    letter = {}                     # mesh dim -> the letter split over it
    for sub, x in zip(subs, ops):
        if isinstance(x, DTensor):
            for m, q in enumerate(x.placements):
                if type(q) is Shard:
                    letter.setdefault(m, sub[q.dim])
    for i, (sub, x) in enumerate(zip(subs, ops)):
        if not isinstance(x, DTensor):
            continue
        want = list(x.placements)
        for m, c in letter.items():
            if c in sub and want[m].is_replicate() and not any(
                    q.is_shard(sub.index(c)) for q in want):
                want[m] = Shard(sub.index(c))
        if want != list(x.placements):
            ops[i] = x.redistribute(x.device_mesh, want)
    return (eq, ops) if nested else (eq, *ops)


def _run_backward(loss, gradient=None, retain_graph=None,
                  create_graph=False, inputs=None):
    """``loss.backward(...)`` by the autograd engine itself (its Python
    entry points hand the call to the active torch-function mode)."""
    from torch.autograd.variable import Variable
    Variable._execution_engine.run_backward(
        (loss,), (torch.ones_like(loss) if gradient is None else gradient,),
        bool(retain_graph or create_graph), create_graph,
        tuple(inputs or ()), allow_unreachable=True, accumulate_grad=True)


def _shard_dim_alltoall(x, gather_dim: int, shard_dim: int, mesh,
                        mesh_dim: int):
    """DTensor's move of a split from one dim to another over one mesh
    axis, as the all-to-all GSPMD emits: DTensor itself falls back to an
    all-gather on a CPU mesh (gloo has no all-to-all), which the dry
    run's world is; its ``meta`` blocks run the op's shape function."""
    return torch.ops._dtensor.shard_dim_alltoall(
        x, gather_dim, shard_dim, mesh.get_group(mesh_dim).group_name)


@contextlib.contextmanager
def gspmd_partitioning():
    """The dry run's step partitioned as the reference's partitioner
    (GSPMD) partitions it, while active:

      * a placed weight's FSDP dims are gathered where an op uses it
        (``_GspmdOps``, ``_Gather``), a weight gradient's product is cut
        into slabs along the weight's FSDP dim (``weight_grad_slab``), a
        product's partial sums are reduced where it makes them
        (``reduced_product``), a softmax or log-sum-exp keeps a split
        dim split (``_split_reduction``), a split moved from one dim
        to another is one all-to-all (``_shard_dim_alltoall``), the
        token ids of a vocab-split lookup are permuted to the vocab's
        axis and gathered there (``_tokens_for_lookup``), and an op
        DTensor has no strategy for is partitioned where it can be
        (``gspmd_fallback``);
      * a batched einsum whose operands agree runs on the blocks, its
        partial sums reduced where made (``_einsum_on_blocks``); a
        constant pad and the MoE's dispatch scatter are partitioned by
        the port's own rules before DTensor's, which differ between
        torch versions (``OWN_RULES``); a split of a split dim keeps
        each part split, its blocks fetched by collective-permutes
        (``split_kept``; its gradient ``cat_kept``,
        ``slice_backward_kept``); a product whose input splits the
        contracted dim as the weight splits its output gathers the
        input (``_input_whole_product``); an xLSTM stack's embedding
        takes the table to the tokens (``lookup_by_table``);
      * on a mesh with an axis cut into factors (``split_factors``; an
        xLSTM block's q, k, v and gates ask for the heads' cut:
        ``reduced_by_heads``): views move the splits between dims as
        GSPMD keeps them (``split_view``), a batched einsum slices its
        replicated operands (``_einsum_operands``), a product laid out
        as a split ``like`` gathers the operand that splits the
        contracted dim (``product_as``), an elementwise op whose
        operands agree runs on the blocks (``local_pointwise``), and a
        strided split is priced as the plain one;
      * DTensor's sharding propagation splits an op's work only as its
        operands are split.  Of the strategies DTensor weighs for an op,
        those are dropped (where any other is left) that shard or make
        partial the output over a mesh axis on which every input is
        replicated — DTensor counts slicing a replicated input as free,
        and would split a computation (attention over "model" when the
        heads cannot shard) that GSPMD runs whole on every device — or
        that turn an input partial over a mesh axis into a shard over it
        — a reduce-scatter that splits the consumer's work, where GSPMD
        all-reduces the partial sum (a gradient) to the sharding of its
        primal."""
    from torch.distributed.tensor import _sharding_prop as sp
    select = sp._select_min_cost_strategy

    def gspmd(o, ins) -> bool:
        wants = o.input_specs or ()
        for m in range(ins[0].mesh.ndim):
            if all(a.placements[m].is_replicate() for a in ins) \
                    and not all(s is None or s.placements[m].is_replicate()
                                for s in _specs(o.output_specs)):
                return False
            for a, want in zip(ins, wants):
                if a.placements[m].is_partial() \
                        and want.placements[m].is_shard():
                    return False
        return True

    def gspmd_pick(strategy, op_schema=None):
        ins = op_schema.args_spec if op_schema is not None else ()
        if ins and len(strategy.strategies) > 1:
            keep = [o for o in strategy.strategies if gspmd(o, ins)]
            if keep and len(keep) < len(strategy.strategies):
                strategy = copy.copy(strategy)
                strategy.strategies = keep
        return select(strategy, op_schema)

    from torch.distributed.tensor import _collective_utils as cu
    from torch.distributed.tensor._ops import utils as ou
    cost = cu.redistribute_cost
    costs: dict = {}

    def gspmd_cost(current, target):
        # a strided split (DTensor's own view rule gives one where a
        # flattened dim's minor part is split) is priced as the plain
        # split: DTensor's exact planner for it searches every placement
        # state of the mesh, seconds a price on a 3-dim mesh, and sizes
        # each state's blocks by chunking an index of the whole dim
        # (most of recurrentgemma-9b x train_4k's walk, its attention's
        # (256, 65536, 256) heads x sequence), for each strategy it
        # weighs; and each price is kept (the layers of a model ask the
        # same ones)
        key = (current, target)
        if key not in costs:
            costs[key] = cost(_unstrided(current), _unstrided(target))
        return costs[key]

    if _GSPMD.active:
        yield                    # nested: the outer one holds the rule
        return
    # DTensor caches each op's decision: none made outside may serve
    # inside, nor the other way (hold a loop of walks in one context to
    # share the decisions between them)
    from torch.distributed.tensor import placement_types as pt
    from torch.distributed.tensor.debug import _clear_sharding_prop_cache
    alltoall = pt.shard_dim_alltoall
    _clear_sharding_prop_cache()
    sp._select_min_cost_strategy = gspmd_pick
    pt.shard_dim_alltoall = _shard_dim_alltoall
    cu.redistribute_cost = ou.redistribute_cost = gspmd_cost
    mask_buffer = getattr(pt, "MaskBuffer", None)
    materialize = getattr(mask_buffer, "materialize_mask", None)
    if materialize is not None:
        mask_buffer.materialize_mask = _materialize_meta_mask(materialize)
    _GSPMD.active = True
    try:
        with _GspmdOps():
            yield
    finally:
        _GSPMD.active = False
        sp._select_min_cost_strategy = select
        pt.shard_dim_alltoall = alltoall
        cu.redistribute_cost = ou.redistribute_cost = cost
        if materialize is not None:
            mask_buffer.materialize_mask = materialize
        _clear_sharding_prop_cache()


def _materialize_meta_mask(materialize):
    """DTensor's masked embedding lookup over a vocab split over two mesh
    dims (a factored axis) materializes one mask per dim into a shared
    buffer, comparing each with the first (``torch.equal``, which has
    no ``meta`` kernel): on ``meta`` masks, only their shapes exist, and
    the first is kept."""
    def run(self, mask):
        if self.refcount and mask.is_meta:
            self.refcount += 1
            return None
        return materialize(self, mask)
    return run


def _unstrided(spec):
    """``spec`` with each strided split as the plain split of its dim."""
    from torch.distributed.tensor import Shard
    from torch.distributed.tensor._dtensor_spec import DTensorSpec
    from torch.distributed.tensor.placement_types import _StridedShard
    if not any(isinstance(q, _StridedShard) for q in spec.placements):
        return spec
    return DTensorSpec(spec.mesh, tuple(
        Shard(q.dim) if isinstance(q, _StridedShard) else q
        for q in spec.placements), tensor_meta=spec.tensor_meta)


def _specs(specs):
    return specs if isinstance(specs, (tuple, list)) else (specs,)


def place_meta(tree, spec_tree, mesh, rules, context: str = ""):
    """Every leaf of ``tree`` as a ``DTensor`` on ``mesh`` of a ``meta``
    block (``NamedSharding.dtensor``), split by the matching ``Spec`` of
    ``spec_tree`` (``models.params``) under ``rules``: the dry run's
    arguments.  ``tree`` is a nested dict of tensors, a stacked subtree
    a list of its layers (a cache), or a ``ParamTree``, whose
    parameters are replaced in place by ``DTensor`` parameters; a leaf
    that keeps the stacking dim (an optimizer slot) is split by the
    stacked spec."""
    from torch import nn
    from repro_torch.models import params as P

    def leaf(t, s):
        ns = NamedSharding(mesh, resolve_spec(tuple(s.shape), s.axes, mesh,
                                              rules, context))
        block = torch.empty(ns.local_shape(s.shape), dtype=t.dtype,
                            device="meta")
        return ns.dtensor(block, s.shape)

    def walk(t, s):
        if P.is_spec(s):
            return leaf(t, s)
        if P.is_stacked(s) and isinstance(t, (list, nn.ModuleList)):
            _, layer = P.unstack(s)
            return type(t)([walk(ti, layer) for ti in t])
        if isinstance(t, P.ParamTree):
            for name, sub in s.items():
                if P.is_spec(sub):
                    old = t._parameters[name]
                    p = nn.Parameter(leaf(old, sub),
                                     requires_grad=old.requires_grad)
                    p.fsdp_dims = fsdp_dims(sub.axes, p.placements)
                    t._parameters[name] = p
                else:
                    walk(t[name], sub)
            return t
        return {k: walk(t[k], s[k]) for k in t}
    return walk(tree, spec_tree)


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
