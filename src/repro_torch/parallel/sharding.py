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
    return x


def set_slot(buf: torch.Tensor, dim: int, index: int,
             value: torch.Tensor) -> None:
    """``buf``'s entry ``index`` along ``dim`` (size 1 there) set to
    ``value`` in place: a decode step's write into its cache.  A
    ``DTensor`` split along ``dim`` is written by the rank whose block
    holds the entry, into that block, as the reference's partitioned
    dynamic-update-slice does; the other ranks move nothing."""
    if not is_distributed(buf) or not any(
            p.is_shard(dim) for p in buf.placements):
        buf.narrow(dim, index, 1).copy_(value)
        return
    from torch.distributed.tensor import DTensor, Replicate
    mesh, block = buf.device_mesh, buf.to_local()
    coord, at = mesh.get_coordinate(), 0
    for m, p in enumerate(buf.placements):
        if p.is_shard(dim):
            at = at * mesh.size(m) + coord[m]
    start = at * block.shape[dim]
    if not start <= index < start + block.shape[dim]:
        return
    if not isinstance(value, DTensor):
        value = DTensor.from_local(value, mesh, [Replicate()] * mesh.ndim,
                                   run_check=False)
    want = [Replicate() if p.is_shard(dim) else p for p in buf.placements]
    block.narrow(dim, index - start, 1).copy_(
        value.redistribute(mesh, want).to_local())


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
    dim, or a factored axis's) to the mesh dims ``b`` of the same size —
    the rank at index i over ``a`` and j over ``b`` takes the block of
    the rank at j over ``a`` and i over ``b`` — as ``placements``: one
    collective-permute, issued as the all-to-all that sends the whole
    block to one rank (``launch.cost_analysis`` counts it as a
    collective-permute)."""
    from torch.distributed import _functional_collectives as funcol
    from torch.distributed.tensor import DTensor
    mesh = x.device_mesh
    coord = list(mesh.get_coordinate())
    i, j = _flat_coordinate(mesh, a, coord), _flat_coordinate(mesh, b, coord)
    for dims, v in ((a, j), (b, i)):
        for m in reversed(dims):
            coord[m], v = v % mesh.size(m), v // mesh.size(m)
    flat = _flat_coordinate(mesh, range(mesh.ndim), coord)
    block = x.to_local().contiguous()
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
    slabs (``weight_grad_slab``).  Backward, as that HLO reduces the
    gradient: its partial sums all-reduced (XLA's CPU pipeline forms no
    reduce-scatter), moved back to the stored axis or sliced to it."""

    @staticmethod
    def forward(ctx, p, dims, gather: bool):
        from torch.distributed.tensor import Replicate
        mesh, stored = p.device_mesh, list(p.placements)
        ctx.stored, ctx.shape, ctx.use = stored, tuple(p.shape), None
        axes = _use_axes(p, dims)
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
        return p.redistribute(mesh, [
            Replicate() if q.is_shard() and q.dim in dims else q
            for q in p.placements])

    @staticmethod
    def backward(ctx, g):
        from torch.distributed.tensor import Replicate
        mesh = g.device_mesh
        g = g.redistribute(mesh, [Replicate() if q.is_partial() else q
                                  for q in g.placements])
        if ctx.use is not None and list(g.placements) == ctx.moved:
            g = _move_split(g, ctx.use, ctx.axis, ctx.stored)
        return g.redistribute(mesh, ctx.stored), None, None


def at_use(x, gather: bool = True):
    """``x`` as an op uses it: a placed weight (``place_meta``) with its
    FSDP dims gathered (or, ``gather=False``, only moved to its use
    axis), anything else as it is.  ``gspmd_partitioning`` reads every
    weight so; a caller that takes a weight's block itself
    (``DTensor.to_local``) calls it first."""
    dims = getattr(x, "fsdp_dims", ())
    if not dims or not (gather or _use_axes(x, dims)):
        return x
    return _Gather.apply(x, dims, gather)


def reduced_product(func, out):
    """A product's (``mm``, ``bmm``) partial sums all-reduced where it
    makes them, under ``gspmd_partitioning``: GSPMD reduces a partial sum
    before another op consumes it, where DTensor would carry it on
    through linear ops (a norm's backward) and reduce it at each later
    consumer."""
    from torch.distributed.tensor import DTensor, Replicate
    if not _GSPMD.active or func.__name__.split(".")[0] not in ("mm", "bmm") \
            or not isinstance(out, DTensor) \
            or not any(q.is_partial() for q in out.placements):
        return out
    return out.redistribute(out.device_mesh, [
        Replicate() if q.is_partial() else q for q in out.placements])


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


def gspmd_fallback(func, args):
    """An op DTensor has no sharding strategy for, partitioned as GSPMD
    partitions it, where it can be: an elementwise op
    (``log_sigmoid_backward``) on the blocks of its input's placements,
    every operand of its shape redistributed there; an op that moves
    data along dims no mesh dim splits (``roll``, ``flip``: torch 2.11
    has no strategy for them) on each block, its placements kept.
    None for any other op (it runs replicated)."""
    from torch.distributed.tensor import DTensor
    name = func.__name__
    x = args[0] if args else None
    if not _GSPMD.active or not isinstance(x, DTensor) \
            or any(q.is_partial() for q in x.placements):
        return None
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


# the elementwise ops without a DTensor strategy: name -> the argument
# whose placements the others take; the ops that move data along given
# dims: name -> the argument that names them
_ELEMENTWISE = {"log_sigmoid_backward.default": 1}
_ALONG_DIMS = {"roll.default": 2, "flip.default": 1}


class _Gspmd(threading.local):
    active = False


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
    run under autograd reads a placed weight as it uses it (``at_use``),
    but for ``_STORED_READS`` (the optimizer's update, without autograd,
    reads the stored block), and a softmax or log-sum-exp keeps a split
    dim split (``_split_reduction``)."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        from torch.utils._pytree import tree_map
        kwargs = kwargs or {}
        if func is torch.Tensor.backward:
            # the engine run with this mode (popped while its own handler
            # runs) pushed again: the backward pass recomputes the
            # rematerialized blocks, whose weights it gathers too
            with _GspmdOps():
                return _run_backward(*args, **kwargs)
        out = _split_reduction(func, args, kwargs)
        if out is not None:
            return out
        if torch.is_grad_enabled() and func not in _STORED_READS \
                and getattr(func, "__name__", "") not in ("__get__",
                                                          "__set__"):
            # an embedding lookup takes a token's row from the table's
            # block, moved to its use axis but not gathered: the
            # reference's partition gathers the tokens instead (its
            # s32[256,4096,1] all-gather of gemma2-2b train_4k)
            use = (lambda x: at_use(x, gather=False)) \
                if func is F.embedding else at_use
            args, kwargs = tree_map(use, (args, kwargs))
        if func is torch.einsum:
            args = _einsum_operands(args)
            out = _einsum_on_blocks(args)
            if out is not None:
                return out
        if func is F.embedding:
            args = (_tokens_for_lookup(args[0], args[1]),) + tuple(args[1:])
        return func(*args, **kwargs)


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
    """``torch.einsum`` of DTensors on a mesh with a factored axis, run on
    their blocks (``_BlockEinsum``): DTensor's own einsum flattens dims
    split over different mesh dims into one, which torch 2.11 refuses
    and torch 2.13 splits strided.  Only a batched product (a letter in
    every operand and the output: attention's scores and values), whose
    operands are activations; a weight's product keeps DTensor's ``mm``,
    whose gradient ``weight_grad_slab`` cuts.  None for any other
    einsum, and where each operand's letters do not all appear in the
    output or another operand (its backward would broadcast)."""
    from torch.distributed.tensor import DTensor
    eq, ops = args[0], list(args[1:])
    if len(ops) == 1 and isinstance(ops[0], (list, tuple)):
        ops = list(ops[0])
    if not isinstance(eq, str) or "->" not in eq or "." in eq or not ops \
            or not all(isinstance(x, DTensor) for x in ops) \
            or not factored_axes(ops[0].device_mesh):
        return None
    eq = eq.replace(" ", "")
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
    return _BlockEinsum.apply(eq, placements, *ops)


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
      * on a mesh with an axis cut into factors (``split_factors``):
        views move the splits between dims as GSPMD keeps them
        (``split_view``), a batched einsum slices its replicated
        operands and runs on the blocks (``_einsum_operands``,
        ``_einsum_on_blocks``), an elementwise op whose operands agree
        runs on the blocks (``local_pointwise``), and a strided split
        is priced as the plain one;
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
        # on a mesh with a factored axis, a strided split (DTensor's own
        # view rule gives one where a flattened dim's minor part is
        # split) is priced as the plain split: DTensor's exact planner
        # for it searches every placement state of the mesh, seconds a
        # price on a 3-dim mesh, for each strategy it weighs; and each
        # price is kept (the layers of a model ask the same ones)
        if not factored_axes(current.mesh):
            return cost(current, target)
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
