"""Step cost counter for the dry run — the port's counterpart of the
reference's ``repro.launch.hlo_analysis``.

The reference parses the compiled, post-SPMD HLO text of a step.  The
port compiles no HLO and has no SPMD partitioner: its step is eager
PyTorch.  So ``count_step`` walks one step on ``meta`` tensors (shapes,
no storage, no arithmetic) under a ``TorchDispatchMode`` that sees every
aten op the step runs, forward and backward, and counts:

  * flops — dot ops by ``torch.utils.flop_counter``'s formulas (2*M*N*K,
    the reference's ``_dot_flops``), one FLOP per output element for the
    counterparts of the reference's ``ELEMENTWISE`` set, and one per
    operand element for reductions;
  * bytes — operand + result bytes of every op that moves data.  Eager
    runs no fusion, so this is an upper bound on the reference's
    post-fusion bytes;
  * collectives — the ones the port itself calls (``_c10d_functional``
    ops: the shard_map MoE's all-to-alls, all-reduce and all-gathers),
    by kind and group size, priced by the reference's ring model.

The step is the whole program, not one device's partition: the dry run
labels its per-device numbers as an even split.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Sequence

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

DTYPE_BYTES = {
    "pred": 1, "s4": 1, "u4": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2,
    "s32": 4, "u32": 4, "s64": 8, "u64": 8, "f8e4m3fn": 1, "f8e5m2": 1,
    "bf16": 2, "f16": 2, "f32": 4, "f64": 8, "c64": 8, "c128": 16,
    "token": 0, "opaque": 0,
}

# the aten counterparts of the reference's ELEMENTWISE HLO opcodes (and
# the activations XLA would lower to them): one FLOP an output element
ELEMENTWISE = {
    "add", "sub", "rsub", "mul", "div", "maximum", "minimum", "abs", "neg",
    "exp", "log", "log1p", "tanh", "rsqrt", "sqrt", "pow", "sigmoid",
    "sign", "floor", "ceil", "cos", "sin", "where", "eq", "ne", "lt", "le",
    "gt", "ge", "logical_and", "logical_or", "logical_xor", "logical_not",
    "bitwise_and", "bitwise_or", "bitwise_xor", "bitwise_not", "clamp",
    "clamp_min", "clamp_max", "_to_copy", "silu", "gelu", "log_sigmoid_forward",
    "reciprocal", "square", "erf", "round", "remainder", "fmod",
    "silu_backward", "gelu_backward", "sigmoid_backward", "tanh_backward",
    "threshold_backward", "log_sigmoid_backward", "lerp", "addcmul",
    "addcdiv",
}
REDUCTIONS = {"sum", "mean", "amax", "amin", "max", "min", "logsumexp",
              "prod", "argmax", "argmin", "var", "std", "norm",
              "linalg_vector_norm", "_log_softmax", "_softmax", "cumsum",
              "_log_softmax_backward_data", "_softmax_backward_data"}
# ops that move no data: views, metadata, allocation
NO_TRAFFIC = {
    "view", "_unsafe_view", "reshape", "expand", "permute", "transpose",
    "t", "slice", "select", "unsqueeze", "squeeze", "detach", "alias",
    "as_strided", "empty", "empty_like", "empty_strided", "new_empty",
    "split", "split_with_sizes", "unbind", "chunk", "narrow", "movedim",
    "unflatten", "flatten", "lift_fresh", "_reshape_alias", "view_as",
    "diagonal", "expand_as", "set_", "resize_", "zeros_like_", "wait_tensor",
}
COLLECTIVES = {"all_reduce": "all-reduce",
               "all_gather_into_tensor": "all-gather",
               "reduce_scatter_tensor": "reduce-scatter",
               "all_to_all_single": "all-to-all"}


@dataclasses.dataclass
class Cost:
    flops: float = 0.0
    bytes: float = 0.0
    coll_bytes: Dict[str, float] = dataclasses.field(default_factory=dict)
    coll_traffic: float = 0.0      # ring-model per-device traffic

    def add(self, other: "Cost", mult: float = 1.0):
        self.flops += other.flops * mult
        self.bytes += other.bytes * mult
        self.coll_traffic += other.coll_traffic * mult
        for k, v in other.coll_bytes.items():
            self.coll_bytes[k] = self.coll_bytes.get(k, 0.0) + v * mult


def _collective_traffic(kind: str, result_bytes: float, g: int) -> float:
    """Per-device ring-model traffic for one collective."""
    if g <= 1:
        return 0.0
    if kind == "all-reduce":
        return 2.0 * result_bytes * (g - 1) / g
    if kind == "all-gather":
        return result_bytes * (g - 1) / g
    if kind == "reduce-scatter":
        return result_bytes * (g - 1)
    if kind == "all-to-all":
        return result_bytes * (g - 1) / g
    if kind == "collective-permute":
        return result_bytes
    return result_bytes


def _tensors(tree) -> List[torch.Tensor]:
    out = []
    for x in (tree if isinstance(tree, (list, tuple)) else (tree,)):
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, (list, tuple)):
            out.extend(_tensors(x))
    return out


def _nbytes(ts: Sequence[torch.Tensor]) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def _group_size(args) -> int:
    import torch.distributed.distributed_c10d as c10d
    name = next(a for a in args if isinstance(a, str)
                and a not in ("sum", "avg", "max", "min"))
    return c10d._resolve_process_group(name).size()


class CostMode(TorchDispatchMode):
    """Counts every aten op run under it into ``self.cost``, each weighted
    by ``self.weight`` (``count_as`` raises it for one step of a scan
    that stands for many)."""

    def __init__(self):
        super().__init__()
        self.cost = Cost()
        self.weight = 1.0
        self.stack: List[float] = []

    def __enter__(self):
        _MODES.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        _MODES.remove(self)
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        packet = func.overloadpacket
        name = packet.__name__.rstrip("_")
        c, w = self.cost, self.weight
        ins, outs = _tensors(list(args) + list(kwargs.values())), _tensors(out)
        if packet in flop_registry:
            c.flops += w * flop_registry[packet](*args, **kwargs, out_val=out)
        elif name in ELEMENTWISE:
            c.flops += w * sum(t.numel() for t in outs)
        elif name in REDUCTIONS and ins:
            c.flops += w * ins[0].numel()
        if func.namespace == "_c10d_functional" and name in COLLECTIVES:
            kind = COLLECTIVES[name]
            g = _group_size(args)
            rb = _nbytes(outs)
            key = f"{kind}(g={g})"
            c.coll_bytes[key] = c.coll_bytes.get(key, 0.0) + w * rb
            c.coll_traffic += w * _collective_traffic(kind, rb, g)
        if name not in NO_TRAFFIC:
            c.bytes += w * (_nbytes(ins) + _nbytes(outs))
        return out


_MODES: List[CostMode] = []


def _push_weight(n: float) -> None:
    for m in _MODES:
        m.stack.append(m.weight)
        m.weight *= n


def _pop_weight() -> None:
    for m in _MODES:
        m.weight = m.stack.pop()


def count_as(n: int, fn: Callable, inputs: Sequence[torch.Tensor]):
    """Run ``fn()`` — one step of a scan whose ``n`` steps are alike — and
    count it, forward and backward, as ``n`` steps, as the reference's
    HLO analysis multiplies a while body by its trip count.  Its
    backward: the autograd nodes ``fn`` created (those between its
    outputs and ``inputs``) run under the same weight."""
    _push_weight(n)
    try:
        out = fn()
    finally:
        _pop_weight()
    if not _MODES or not torch.is_grad_enabled():
        return out
    stop = {t.grad_fn for t in inputs if t.grad_fn is not None}
    seen, todo = set(), [t.grad_fn for t in _tensors(out)]
    while todo:
        node = todo.pop()
        if node is None or node in seen or node in stop \
                or type(node).__name__ == "AccumulateGrad":
            continue
        seen.add(node)
        todo.extend(f for f, _ in node.next_functions)
    for node in seen:
        node.register_prehook(lambda *_: _push_weight(n))
        node.register_hook(lambda *_: _pop_weight())
    return out


def count_step(fn: Callable) -> Cost:
    """The cost of ``fn()`` (a step on ``meta`` tensors)."""
    with CostMode() as mode:
        fn()
    return mode.cost
