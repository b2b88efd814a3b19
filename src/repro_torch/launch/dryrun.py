"""Multi-pod dry run of the port — the reference's
``repro.launch.dryrun``, same command line:

  python -m repro_torch.launch.dryrun --arch gemma2-2b --shape train_4k
  python -m repro_torch.launch.dryrun --arch deepseek-v3-671b \\
      --shape decode_32k --multi-pod
  python -m repro_torch.launch.dryrun --all --json dryrun.json

Each (arch x shape x mesh) cell resolves every parameter, optimizer-state
(train), cache (serve) and input leaf on the production mesh
(``make_production_mesh``: the 16x16 or 2x16x16 mesh over a one-process
``fake`` world of 512 ranks), places each as a ``DTensor`` of ``meta``
blocks by its spec, and walks one rank's share of the step: DTensor's
sharding propagation partitions each op, held to GSPMD's choices
(``sharding.gspmd_partitioning``), and
``repro_torch.launch.cost_analysis`` counts what the rank runs — the
reference reads one SPMD partition's HLO.  It runs on the CPU and
allocates no tensor of the full-size configs.  Per cell, per device:

  * ``memory.argument_bytes`` — exact: the local shard bytes of every
    argument leaf the step reads (plus the 4-byte step or index scalar
    where it is used), the reference's
    ``memory_analysis().argument_size_in_bytes`` (XLA drops a parameter
    the step never reads); split by tree in
    ``memory.argument_bytes_by_tree``; ``memory.output_bytes``, the
    local bytes of every output leaf as the walk leaves it, with XLA's
    output tuple; ``memory.alias_bytes``, those of the read donated
    leaves (parameters and optimizer state for train, the cache for
    prefill and decode) an output of the same block shape takes;
    ``memory.temp_bytes``, XLA's ``temp_size_in_bytes`` by eager
    PyTorch's buffer assignment: the most bytes held at once by the
    blocks the walk's ops return that are neither argument leaves nor
    part of the outputs (``cost_analysis.Blocks``: a block lives from
    the op that made it until its storage dies; a scan step that
    stands for ``n`` holds what the loop would).  It counts no
    allocator rounding, no cuBLAS workspace and no kernel's internal
    scratch, and it counts the port's dtypes where the reference's CPU
    compile runs dots and their activations in f32 (XLA's float
    normalization); XLA also schedules and rematerializes on its own
    terms.  The walk keeps the most bytes live at once, arguments
    included, as ``Cost.peak_bytes``: what ``max_memory_allocated``
    reads for the same step on one device (on a one-device mesh the
    walk runs the plain step, as the Trainer runs it there);
  * ``sharding_fallbacks`` — the reference's text, from the same rules;
  * ``flops_per_device``, ``dot_flops_per_device``, ``bytes_per_device``
    (eager, unfused: an upper bound on the reference's fused bytes),
    ``coll_traffic_per_device`` (the ring model), ``coll_breakdown``
    (the 12 largest, bytes by kind and group) and ``coll_elements`` (the
    elements each moves, whatever its dtype); ``replicated_ops``, the
    ops DTensor could not shard as placed, run on gathered inputs; with
    ``cost_analysis.BY_SOURCE`` set, ``coll_by_source`` (each kind's
    elements and the dot FLOPs by the code that issued them);
  * ``terms`` — roofline seconds from the H100 data-sheet constants of
    ``launch.mesh``: compute, memory and collective (traffic over one
    NVLink bandwidth, the reference's one-bandwidth model), and the
    ``bottleneck`` among the three.

A cell that raises reports ``FAIL`` with its error.  ``--smoke`` runs
the reduced configs at the same shapes.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.experimental import implicit_replication
from torch.overrides import TorchFunctionMode

from repro_torch.common.config import (LM_SHAPES, SHAPES_BY_NAME, ModelConfig,
                                       ShapeConfig, TrainConfig)
from repro_torch.configs import ALL_ARCHS, get_config, get_smoke_config
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import cost_analysis
from repro_torch.launch.cost_analysis import count_step
from repro_torch.models import params as P
from repro_torch.models.model import (ENC_LEN_FOR_DECODE, Model, cache_spec,
                                     input_specs, param_spec)
from repro_torch.optim.optimizers import make_optimizer
from repro_torch.parallel import sharding as sh
from repro_torch.train.step import (make_decode_step, make_prefill_step,
                                    make_train_step)

def _rules_of(shape: ShapeConfig):
    return sh.make_rules("train" if shape.kind == "train" else "serve",
                         long_context=(shape.name == "long_500k"))


def _enc_len(cfg: ModelConfig, shape: ShapeConfig) -> int:
    if cfg.is_encdec and shape.is_decode:
        return ENC_LEN_FOR_DECODE
    return shape.seq_len if cfg.is_encdec else 0


def resolve_cell(cfg: ModelConfig, shape: ShapeConfig, mesh
                 ) -> List[Tuple[str, str, Tuple[int, ...], torch.dtype,
                                 sh.PartitionSpec]]:
    """``(tree, leaf path, global shape, dtype, spec)`` of every argument
    leaf of the cell's step on ``mesh``, resolved in the reference's
    order (its trees in the order it shards them, each tree's leaves in
    pytree order): the parameters, the inputs, then the optimizer state
    (train) or the cache (serve)."""
    rules, ctx = _rules_of(shape), f"{cfg.name}/{shape.name}"
    pspec = param_spec(cfg)
    ispecs, iaxes = input_specs(cfg, shape)
    if shape.kind == "train":
        last = ("opt_state", make_optimizer(cfg.optimizer).state_spec(pspec),
                "float32")
    else:
        last = ("cache", cache_spec(cfg, shape.global_batch, shape.seq_len,
                                    _enc_len(cfg, shape)), cfg.compute_dtype)
    out = []
    for tree, spec_tree, dtype in (("params", pspec, cfg.param_dtype),
                                   ("inputs", None, None), last):
        if tree == "inputs":
            leaves = [(k, tuple(ispecs[k].shape), iaxes[k], ispecs[k].dtype)
                      for k in sorted(ispecs)]
        else:
            leaves = [(k, s.shape, s.axes, P.torch_dtype(s.dtype or dtype))
                      for k, s in P.tree_items(spec_tree)]
        for path, shp, axes, dt in leaves:
            out.append((tree, path, shp, dt,
                        sh.resolve_spec(shp, axes, mesh, rules, ctx)))
    return out


def argument_bytes(cfg: ModelConfig, shape: ShapeConfig, mesh
                   ) -> Dict[str, int]:
    """One device's bytes of every argument leaf of the cell's step, by
    tree (each leaf's local shard), plus the 4-byte step (train) or
    index (decode) scalar: what the step is given, read or not (the
    walk counts what it reads: ``walk_cell``)."""
    by_tree: Dict[str, int] = {}
    for tree, path, shp, dt, spec in resolve_cell(cfg, shape, mesh):
        by_tree[tree] = by_tree.get(tree, 0) + sh.NamedSharding(
            mesh, spec).local_bytes(shp, dt)
    if shape.kind == "train":
        by_tree["step_scalar"] = 4
    elif shape.is_decode:
        by_tree["index_scalar"] = 4
    return by_tree


def _split_override(cfg: ModelConfig, opt_override):
    """The reference's ``opt_override``: ``tc_``-prefixed keys are
    TrainConfig fields, the rest ModelConfig fields."""
    tc_kw = {}
    if opt_override:
        tc_kw = {k[3:]: v for k, v in opt_override.items()
                 if k.startswith("tc_")}
        rest = {k: v for k, v in opt_override.items()
                if not k.startswith("tc_")}
        if rest:
            cfg = cfg.replace(**rest)
    return cfg, tc_kw


def _leaves(tree) -> List[torch.Tensor]:
    """The tensors of a nested dict / list / tuple (a ``ParamTree``: its
    parameters), in order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, P.ParamTree):
        return list(tree.parameters())
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _leaves(v)]
    return []


def _local(t: torch.Tensor) -> torch.Tensor:
    return t.to_local() if isinstance(t, DTensor) else t


def _nbytes(t: torch.Tensor) -> int:
    """One device's bytes of ``t`` (a DTensor's block, a plain tensor
    whole)."""
    t = _local(t)
    return t.numel() * t.element_size()


_TUPLE_ENTRY = 8       # bytes of XLA's output tuple for each leaf


class _MadeFrom(TorchFunctionMode):
    """The tensors the step makes from its scalar argument (the train
    step's step, the decode step's position): ``torch.full``'s fill or
    ``torch.as_tensor``'s data that is the scalar's very object (the
    walk passes one above CPython's small-int cache, so no literal of
    the model's is it), each watched by the walk's ``CostMode`` and read
    as this mode (``self in cost.read``), not held."""

    def __init__(self, scalar: int):
        super().__init__()
        self.scalar = scalar

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func in (torch.full, torch.as_tensor) and any(
                a is self.scalar for a in (*args, *kwargs.values())):
            cost_analysis.watch([out], self)
        return out


def walk_cell(cfg: ModelConfig, shape: ShapeConfig, mesh,
              opt_override: Optional[Dict[str, Any]] = None):
    """Place the parameters, the optimizer state (train), the inputs and
    the cache (serve) as DTensors of ``meta`` blocks by their specs, and
    walk the step once under the mesh's rules, as one rank's share.
    Tensors the step makes itself (positions, masks, zeros) are plain
    and join the DTensors as replicated (``implicit_replication``).  On
    a mesh of one device the rank holds every tensor whole: the step is
    walked on plain ``meta`` tensors, as the Trainer runs it there.

    The memory is XLA's for the reference's jitted step
    (``step_memory``): XLA drops a parameter the step never reads (a
    cache that prefill overwrites whole, the encoder's weights in a
    decode step, a scalar the step never uses — the step or position
    scalar counts if the walk reads a tensor the step makes from it).
    Returns (argument bytes by tree, the step's Cost, output, alias and
    temp bytes); ``Cost.peak_bytes`` is the most bytes the walk held at
    once, arguments included.

    Where a view unflattens a dim split over a mesh axis into dims the
    axis cannot split whole (``sharding.split_factors``), the step is
    walked again on the mesh with that axis cut into the factors the
    shapes give (``launch.mesh.factor_axis``), as GSPMD cuts it."""
    cfg, tc_kw = _split_override(cfg, opt_override)
    resolve_cell(cfg, shape, mesh)  # the fallback log in the reference's order
    by_tree, cost, memory = _walk(cfg, shape, mesh, tc_kw)
    if cost.axis_cut is None:
        return by_tree, cost, memory
    return _walk(cfg, shape, mesh_lib.factor_axis(mesh, *cost.axis_cut),
                 tc_kw)


def _walk(cfg: ModelConfig, shape: ShapeConfig, mesh, tc_kw):
    rules, ctx = _rules_of(shape), f"{cfg.name}/{shape.name}"
    model = Model(cfg, device="meta")
    ispecs, iaxes = input_specs(cfg, shape)
    # the scalar, an int object of its own (see _MadeFrom)
    scalar = int(str(1 << 20 if shape.kind == "train"
                     else shape.seq_len - 1))
    made = _MadeFrom(scalar)
    # on one device a rank holds every tensor whole: the plain step, as
    # the Trainer runs it on such a mesh
    one = mesh_lib.n_chips(mesh) == 1

    def place(tree, spec):
        return tree if one else sh.place_meta(tree, spec, mesh, rules, ctx)

    with sh.activate(mesh, rules, ctx), \
            contextlib.nullcontext() if one else implicit_replication(), \
            contextlib.nullcontext() if one else sh.gspmd_partitioning():
        place(model, model.param_spec())
        inputs = place(ispecs, {k: P.Spec(tuple(v.shape), iaxes[k])
                                for k, v in ispecs.items()})
        params = list(model.parameters())
        out: List[Any] = []         # the state the step returns
        rest: List[Any] = []        # its other outputs
        if shape.kind == "train":
            step_fn, opt = make_train_step(model, TrainConfig(**tc_kw))
            ospec = opt.state_spec(model.param_spec())
            state = place(P.shapes(ospec, "float32"), ospec)
            trees = {"params": params, "inputs": inputs, "opt_state": state}
            donated = _buffers(model) + _buffers(state)
            state_specs = [model.param_spec(), ospec]

            def step():
                new_state, metrics = step_fn(state, inputs, scalar)
                out.extend([new_state, model])
                rest.append(metrics)
        else:
            enc = _enc_len(cfg, shape)
            cache = place(
                model.init_cache(shape.global_batch, shape.seq_len, enc),
                model.cache_spec(shape.global_batch, shape.seq_len, enc))
            trees = {"params": params, "inputs": inputs, "cache": cache}
            donated = _buffers(cache)
            state_specs = [model.cache_spec(shape.global_batch,
                                            shape.seq_len, enc)]
            if shape.kind == "prefill":
                step_fn = make_prefill_step(model)

                def step():
                    logits, new_cache = step_fn(inputs, cache)
                    out.append(new_cache)
                    rest.append(logits)
            else:
                step_fn = make_decode_step(model)

                def step():
                    tokens, new_cache = step_fn(cache, inputs["tokens"],
                                                scalar)
                    out.append(new_cache)
                    rest.append(tokens)
        leaves = {k: _leaves(v) for k, v in trees.items()}
        # each leaf's block as it came in (an in-place update may rebind
        # a DTensor to a block of another split: sharding._take_split)
        blocks = {id(t): _local(t) for v in leaves.values() for t in v}
        with made:
            cost = count_step(step, watch=[t for v in leaves.values()
                                           for t in v])
    by_tree, memory = step_memory(leaves, donated, out + rest,
                                  cost.read_of, blocks)
    cost.held(_leaves(out + rest))
    memory["temp_bytes"] = cost.temp_bytes
    # XLA's output is a tuple of the reference's leaves (a stacked
    # subtree's leaf one array) with a pointer a leaf
    n_out = sum(len(list(P.tree_items(s))) for s in state_specs) \
        + len(_leaves(rest))
    memory["output_bytes"] += _TUPLE_ENTRY * n_out
    if made in cost.read:
        by_tree["step_scalar" if shape.kind == "train"
                else "index_scalar"] = 4
    return by_tree, cost, memory


def _buffers(tree) -> List[List[torch.Tensor]]:
    """The reference's buffers of a tree of the step's tensors: a leaf
    each, but the layers of a stacked subtree — a ``ParamTree``'s
    ``ModuleList`` (``models.params.leaf_groups``), a cache's list of
    layers — one buffer a leaf path, its layers' tensors together (the
    reference's ``(layers, ...)`` leaf)."""
    if isinstance(tree, P.ParamTree):
        return [v if isinstance(v, list) else [v]
                for v in P.leaf_groups(tree).values()]
    if isinstance(tree, torch.Tensor):
        return [[tree]]
    if isinstance(tree, dict):
        return [b for v in tree.values() for b in _buffers(v)]
    if isinstance(tree, (list, tuple)):
        if tree and all(isinstance(x, dict) for x in tree):
            layers = [_buffers(x) for x in tree]
            if all(len(x) == len(layers[0]) for x in layers):
                return [[t for x in layers for t in x[i]]
                        for i in range(len(layers[0]))]
        return [b for v in tree for b in _buffers(v)]
    return []


def step_memory(arguments: Dict[str, List[torch.Tensor]],
                donated, outputs, read_of,
                blocks: Optional[Dict[int, torch.Tensor]] = None
                ) -> Tuple[Dict[str, int], Dict[str, int]]:
    """XLA's memory of a step from its walk: the bytes of the argument
    leaves it reads (``read_of``), by tree; the output bytes, of the
    blocks the walk left on each output; the alias bytes, of each read
    donated buffer (a tensor, or a stacked leaf's layers: ``_buffers``)
    that an output buffer of its bytes and dtype can take, each output
    once — XLA aliases a donated buffer to an output of its size
    whatever its shape (xlstm-125m train_4k: the f32[6,8] ``b_if`` and
    its moments, which leave split, to f32[48] outputs).  ``blocks``:
    each argument leaf's block from before the step, by ``id``
    (default: its block now)."""
    blocks = blocks or {}

    def came_in(t):
        return blocks.get(id(t), _local(t))

    def size(ts):
        return sum(_nbytes(t) for t in ts)

    by_tree = {k: sum(_nbytes(came_in(t)) for t in v if read_of(came_in(t)))
               for k, v in arguments.items()}
    free: Dict[Tuple, int] = {}
    for b in _buffers(outputs):
        key = (size(b), b[0].dtype)
        free[key] = free.get(key, 0) + 1
    alias = 0
    for b in donated:
        b = b if isinstance(b, list) else [b]
        ins = [came_in(t) for t in b]
        key = (size(ins), b[0].dtype)
        if any(read_of(t) for t in ins) and free.get(key):
            free[key] -= 1
            alias += size(ins)
    return by_tree, {"output_bytes": sum(map(_nbytes, _leaves(outputs))),
                     "alias_bytes": alias}


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             opt_override: Optional[Dict[str, Any]] = None,
             verbose: bool = True, smoke: bool = False,
             peak_blocks: int = 0) -> Dict[str, Any]:
    """One cell's walk and its readings (module docstring);
    ``peak_blocks``: also the largest blocks live at the temp peak, that
    many, as ``memory.temp_peak_blocks`` ([bytes, op, local shape,
    dtype] each)."""
    cfg = get_smoke_config(arch) if smoke else get_config(arch)
    shape = SHAPES_BY_NAME[shape_name]
    result: Dict[str, Any] = {
        "arch": arch, "shape": shape_name,
        "mesh": "2x16x16" if multi_pod else "16x16",
    }
    if smoke:
        result["config"] = "smoke"
    if shape_name in cfg.skip_shapes:
        result["status"] = "skip"
        result["reason"] = "see DESIGN.md §Arch-applicability"
        return result

    mesh = mesh_lib.make_production_mesh(multi_pod=multi_pod)
    chips = mesh_lib.n_chips(mesh)
    sh.clear_fallback_log()
    t0 = time.time()
    try:
        by_tree, cost, memory = walk_cell(cfg, shape, mesh, opt_override)
    except Exception as e:  # a failing cell is a bug in the system
        result["status"] = "FAIL"
        result["error"] = f"{type(e).__name__}: {e}"[:500]
        if verbose:
            print(f"[dryrun] {arch} x {shape_name} ({result['mesh']}): "
                  f"FAILED — {result['error']}", flush=True)
        return result
    t_step = time.time() - t0

    arg_bytes = sum(by_tree.values())
    result.update({
        "status": "ok",
        "step_s": round(t_step, 1),
        "chips": chips,
        "flops_per_device": cost.flops,
        "dot_flops_per_device": cost.dot_flops,
        "bytes_per_device": cost.bytes,
        "coll_traffic_per_device": cost.coll_traffic,
        "coll_breakdown": {k: v for k, v in sorted(
            cost.coll_bytes.items(), key=lambda kv: -kv[1])[:12]},
        "coll_elements": dict(sorted(cost.coll_elements.items(),
                                     key=lambda kv: -kv[1])),
        "replicated_ops": dict(sorted(cost.replicated_ops.items())),
        **({"coll_by_source": dict(sorted(cost.by_source.items()))}
           if cost.by_source else {}),
        "memory": {"argument_bytes": arg_bytes,
                   "argument_bytes_by_tree": by_tree, **memory},
        "sharding_fallbacks": sh.fallback_summary(),
    })
    if peak_blocks:
        result["memory"]["temp_peak_blocks"] = [
            [n, op, list(shape), dtype]
            for n, op, shape, dtype in cost.temp_blocks()[:peak_blocks]]
    # roofline terms (seconds) per device, the reference's one-bandwidth
    # model with the H100's data-sheet constants
    result["terms"] = {
        "compute_s": cost.flops / mesh_lib.PEAK_FLOPS_BF16,
        "memory_s": cost.bytes / mesh_lib.HBM_BW,
        "collective_s": cost.coll_traffic / mesh_lib.NVLINK_BW,
    }
    result["bottleneck"] = max(result["terms"], key=result["terms"].get)
    if verbose:
        t = result["terms"]
        print(f"[dryrun] {arch} x {shape_name} ({result['mesh']}): OK "
              f"step walk={t_step:.1f}s "
              f"compute={t['compute_s'] * 1e3:.2f}ms "
              f"memory={t['memory_s'] * 1e3:.2f}ms "
              f"coll={t['collective_s'] * 1e3:.2f}ms (one device, H100 "
              f"data sheet) -> {result['bottleneck']}", flush=True)
        print(f"  argument bytes per device: {arg_bytes:,} "
              f"({arg_bytes / 2**30:.2f} GiB; "
              + ", ".join(f"{k} {v:,}" for k, v in by_tree.items())
              + f"); output {memory['output_bytes']:,}, alias "
              f"{memory['alias_bytes']:,}, temp {memory['temp_bytes']:,}",
              flush=True)
        print(f"  memory: args={arg_bytes / 2**30:.2f}GiB "
              f"temp={memory['temp_bytes'] / 2**30:.2f}GiB "
              f"out={memory['output_bytes'] / 2**30:.2f}GiB (per device)",
              flush=True)
        for n, op, shape, dtype in result["memory"].get(
                "temp_peak_blocks", ()):
            print(f"  at the temp peak: {n:,} B {op} {tuple(shape)} "
                  f"{dtype}", flush=True)
        if cost.replicated_ops:
            print(f"  ops with no DTensor strategy, run replicated: "
                  f"{result['replicated_ops']}", flush=True)
    return result


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default=None, choices=ALL_ARCHS)
    ap.add_argument("--shape", default=None,
                    choices=[s.name for s in LM_SHAPES])
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true",
                    help="every (arch x shape) on both meshes")
    ap.add_argument("--smoke", action="store_true",
                    help="the reduced configs, at the same shapes")
    ap.add_argument("--json", default=None, help="write results to file")
    ap.add_argument("--peak-blocks", type=int, default=0, metavar="N",
                    help="list the N largest blocks at each temp peak")
    args = ap.parse_args(argv)

    if args.all:
        cells = [(arch, shape.name, mp) for arch in ALL_ARCHS
                 for shape in LM_SHAPES for mp in (False, True)]
    else:
        if not args.arch or not args.shape:
            ap.error("--arch and --shape required (or --all)")
        meshes = (False, True) if args.both_meshes else (args.multi_pod,)
        cells = [(args.arch, args.shape, mp) for mp in meshes]
    with sh.gspmd_partitioning():      # the cells share DTensor's decisions
        results = [run_cell(arch, shape, mp, smoke=args.smoke,
                            peak_blocks=args.peak_blocks)
                   for arch, shape, mp in cells]

    n_fail = sum(1 for r in results if r.get("status") == "FAIL")
    if args.json:
        with open(args.json, "w") as f:
            json.dump(results, f, indent=1)
        print(f"[dryrun] wrote {len(results)} cells -> {args.json}")
    print(f"[dryrun] done: {len(results)} cells, {n_fail} failures")
    return 1 if n_fail else 0


if __name__ == "__main__":
    sys.exit(main())
