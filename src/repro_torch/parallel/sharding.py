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


def _move_split(x, a: int, b: int, placements):
    """``x``'s split moved from mesh axis ``a`` to mesh axis ``b`` of the
    same size — the rank at (.., i, .., j, ..) takes the block of the rank
    at (.., j, .., i, ..) — as ``placements``: one collective-permute,
    issued as the all-to-all that sends the whole block to one rank
    (``launch.cost_analysis`` counts it as a collective-permute)."""
    from torch.distributed import _functional_collectives as funcol
    from torch.distributed.tensor import DTensor
    mesh = x.device_mesh
    coord = list(mesh.get_coordinate())
    coord[a], coord[b] = coord[b], coord[a]
    flat = 0
    for m, c in enumerate(coord):
        flat = flat * mesh.size(m) + c
    block = x.to_local().contiguous()
    splits = [0] * mesh.size()
    splits[flat] = block.shape[0]
    moved = funcol.all_to_all_single(block, splits, splits, _mesh_group(mesh))
    return DTensor.from_local(moved, mesh, placements, run_check=False,
                              shape=x.shape, stride=x.stride())


def _use_axes(p, dims) -> Optional[Tuple[int, int]]:
    """The mesh axes (stored, use) between which a weight's FSDP split
    moves for its use: where its one FSDP dim is split over one axis and
    the weight is replicated over another of that size.  None: it stays
    where it is stored."""
    mesh, stored = p.device_mesh, list(p.placements)
    axes = [m for m, q in enumerate(stored) if q.is_shard() and q.dim in dims]
    if len(dims) != 1 or len(axes) != 1:
        return None
    b = next((m for m, q in enumerate(stored) if q.is_replicate()
              and mesh.size(m) == mesh.size(axes[0])), None)
    return None if b is None else (axes[0], b)


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
            moved[a], moved[b] = stored[b], stored[a]
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
        n = mesh.size(fn.use)
        if out_shape[cut] % n:
            return None
        placements = []
        for m in range(mesh.ndim):
            if m in partial:
                placements.append(Partial())
            elif m == fn.use and a.placements[m].is_replicate() \
                    and b.placements[m].is_replicate():
                placements.append(Shard(cut))
            elif kind == "BmmBackward0" and a.placements[m].is_shard(0) \
                    and b.placements[m].is_shard(0) and cut != 0:
                placements.append(Shard(0))
            else:
                return None
        la, lb = a.to_local(), b.to_local()
        k = mesh.get_coordinate()[fn.use]
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
        return func(*args, **kwargs)


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
        dim split (``_split_reduction``), and a split moved from one dim
        to another is one all-to-all (``_shard_dim_alltoall``);
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
    _GSPMD.active = True
    try:
        with _GspmdOps():
            yield
    finally:
        _GSPMD.active = False
        sp._select_min_cost_strategy = select
        pt.shard_dim_alltoall = alltoall
        _clear_sharding_prop_cache()


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
