"""Multi-pod dry run of the port — the reference's
``repro.launch.dryrun``, same command line:

  python -m repro_torch.launch.dryrun --arch gemma2-2b --shape train_4k
  python -m repro_torch.launch.dryrun --arch deepseek-v3-671b \\
      --shape decode_32k --multi-pod
  python -m repro_torch.launch.dryrun --all --json dryrun.json

Each (arch x shape x mesh) cell resolves every parameter, optimizer-state
(train), cache (serve) and input leaf on the production mesh
(``make_production_mesh``: the 16x16 or 2x16x16 mesh over a one-process
``fake`` world of 512 ranks), and walks the step once on ``meta``
tensors under that mesh's rules.  It runs on the CPU and allocates no
tensor of the full-size configs.  Per cell it reports:

  * ``memory.argument_bytes`` — exact: the sum of every argument leaf's
    local shard bytes on one device (plus the 4-byte step or index
    scalar of the train and decode steps), which is what the
    reference's ``memory_analysis().argument_size_in_bytes`` counts;
    split by tree in ``memory.argument_bytes_by_tree``;
  * ``sharding_fallbacks`` — the reference's text, from the same rules;
  * ``flops_global`` / ``bytes_global`` — the whole step's, counted by
    ``repro_torch.launch.cost_analysis`` (eager, unfused: the bytes are
    an upper bound), and ``*_per_device_even_split``, those divided by
    the mesh's size.  They are not XLA's per-partition counts;
  * ``terms`` — roofline seconds from the even split and the H100
    data-sheet constants of ``launch.mesh``; ``collective_s`` is null:
    the collectives GSPMD would insert are not counted (see
    ``collective_s_reason``).

A cell that raises reports ``FAIL`` with its error.  ``--smoke`` runs
the reduced configs at the same shapes.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.common.config import (LM_SHAPES, SHAPES_BY_NAME, ModelConfig,
                                       ShapeConfig, TrainConfig)
from repro_torch.configs import ALL_ARCHS, get_config, get_smoke_config
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch.cost_analysis import count_step
from repro_torch.models import params as P
from repro_torch.models.model import (ENC_LEN_FOR_DECODE, Model, cache_spec,
                                     input_specs, param_spec)
from repro_torch.optim.optimizers import make_optimizer
from repro_torch.parallel import sharding as sh
from repro_torch.train.step import (make_decode_step, make_prefill_step,
                                    make_train_step)

COLLECTIVE_S_REASON = (
    "not counted: the port has no SPMD partitioner to insert the "
    "collectives the rules imply, and DTensor propagation fails on the "
    "model; only collectives the port calls itself are counted "
    "(port_collectives)")


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
    """One device's bytes of the step's arguments, by tree: every leaf's
    local shard, plus the 4-byte step (train) or index (decode) scalar.
    The decode step takes only the tokens of its inputs."""
    by_tree: Dict[str, int] = {}
    for tree, path, shp, dt, spec in resolve_cell(cfg, shape, mesh):
        if tree == "inputs" and shape.is_decode and path != "tokens":
            continue
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


def walk_cell(cfg: ModelConfig, shape: ShapeConfig, mesh,
              opt_override: Optional[Dict[str, Any]] = None):
    """Resolve every argument leaf of the cell's step on ``mesh``, then
    walk the step once on ``meta`` tensors under the mesh's rules.
    Returns (argument bytes by tree, the step's Cost)."""
    cfg, tc_kw = _split_override(cfg, opt_override)
    by_tree = argument_bytes(cfg, shape, mesh)
    model = Model(cfg, device="meta")
    ispecs, _ = input_specs(cfg, shape)
    with sh.activate(mesh, _rules_of(shape), f"{cfg.name}/{shape.name}"):
        if shape.kind == "train":
            step_fn, opt = make_train_step(model, TrainConfig(**tc_kw))
            ostate = P.shapes(opt.state_spec(model.param_spec()), "float32")
            cost = count_step(lambda: step_fn(ostate, ispecs, 0))
        else:
            cache = model.init_cache(shape.global_batch, shape.seq_len,
                                     _enc_len(cfg, shape))
            if shape.kind == "prefill":
                step_fn = make_prefill_step(model)
                cost = count_step(lambda: step_fn(ispecs, cache))
            else:
                step_fn = make_decode_step(model)
                cost = count_step(lambda: step_fn(
                    cache, ispecs["tokens"], shape.seq_len - 1))
    return by_tree, cost


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             opt_override: Optional[Dict[str, Any]] = None,
             verbose: bool = True, smoke: bool = False) -> Dict[str, Any]:
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
        by_tree, cost = walk_cell(cfg, shape, mesh, opt_override)
    except Exception as e:  # a failing cell is a bug in the system
        result["status"] = "FAIL"
        result["error"] = f"{type(e).__name__}: {e}"[:500]
        if verbose:
            print(f"[dryrun] {arch} x {shape_name} ({result['mesh']}): "
                  f"FAILED — {result['error']}", flush=True)
        return result
    t_step = time.time() - t0

    arg_bytes = sum(by_tree.values())
    flops_dev, bytes_dev = cost.flops / chips, cost.bytes / chips
    result.update({
        "status": "ok",
        "step_s": round(t_step, 1),
        "chips": chips,
        "flops_global": cost.flops,
        "bytes_global": cost.bytes,
        "flops_per_device_even_split": flops_dev,
        "bytes_per_device_even_split": bytes_dev,
        "port_collectives": {"coll_breakdown": dict(cost.coll_bytes),
                             "coll_traffic": cost.coll_traffic},
        "memory": {"argument_bytes": arg_bytes,
                   "argument_bytes_by_tree": by_tree},
        "sharding_fallbacks": sh.fallback_summary(),
    })
    result["terms"] = {
        "compute_s": flops_dev / mesh_lib.PEAK_FLOPS_BF16,
        "memory_s": bytes_dev / mesh_lib.HBM_BW,
        "collective_s": None,
    }
    result["collective_s_reason"] = COLLECTIVE_S_REASON
    terms = {k: v for k, v in result["terms"].items() if v is not None}
    result["bottleneck"] = max(terms, key=terms.get)
    if verbose:
        t = result["terms"]
        print(f"[dryrun] {arch} x {shape_name} ({result['mesh']}): OK "
              f"step walk={t_step:.1f}s "
              f"compute={t['compute_s'] * 1e3:.2f}ms "
              f"memory={t['memory_s'] * 1e3:.2f}ms (even split, H100 "
              f"data sheet) coll=not counted -> {result['bottleneck']}",
              flush=True)
        print(f"  argument bytes per device: {arg_bytes:,} "
              f"({arg_bytes / 2**30:.2f} GiB; "
              + ", ".join(f"{k} {v:,}" for k, v in by_tree.items()) + ")",
              flush=True)
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
    args = ap.parse_args(argv)

    results = []
    if args.all:
        for arch in ALL_ARCHS:
            for shape in LM_SHAPES:
                for mp in (False, True):
                    results.append(run_cell(arch, shape.name, mp,
                                            smoke=args.smoke))
    else:
        if not args.arch or not args.shape:
            ap.error("--arch and --shape required (or --all)")
        meshes = (False, True) if args.both_meshes else (args.multi_pod,)
        for mp in meshes:
            results.append(run_cell(args.arch, args.shape, mp,
                                    smoke=args.smoke))

    n_fail = sum(1 for r in results if r.get("status") == "FAIL")
    if args.json:
        with open(args.json, "w") as f:
            json.dump(results, f, indent=1)
        print(f"[dryrun] wrote {len(results)} cells -> {args.json}")
    print(f"[dryrun] done: {len(results)} cells, {n_fail} failures")
    return 1 if n_fail else 0


if __name__ == "__main__":
    sys.exit(main())
