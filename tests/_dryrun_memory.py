"""The memory a step holds, walked and run, for
``tests/test_torch_mesh_dryrun_memory.py``: ``walked`` walks a smoke
arch's train or decode step on a mesh of one device
(``repro_torch.launch.dryrun.walk_cell``; its ``Cost.peak_bytes``) and
``run_for_real`` runs the same step on the CPU on plain tensors and
reads its peak from the allocator's own record (``torch.profiler``'s
memory events).  JAX-free; run as a script it prints one ``RESULT`` line
of JSON for the ``arch:kind`` cases it is given:

  PYTHONPATH=src python tests/_dryrun_memory.py gemma2-2b:train xlstm-125m:decode
"""
from __future__ import annotations

import json
import sys
from typing import Callable, Dict, List

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile, record_function
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.common.config import ShapeConfig, TrainConfig
from repro_torch.configs import get_smoke_config
from repro_torch.models import moe
from repro_torch.models import params as P
from repro_torch.models.model import ENC_LEN_FOR_DECODE, Model, input_specs
from repro_torch.train.step import make_decode_step, make_train_step

BATCH, SEQ = 2, 64          # a train step's tokens; a decode step's cache
# the MoE's dispatch rows and chunks set down for the train step, so
# that its chunk loop runs (4 chunks of 2 rows of 16 tokens): the loop
# the walk counts as one chunk standing for 4 (``cost_analysis.count_as``)
MOE_CHUNKED = {"FLAT_PATH_MAX_TOKENS": 64, "ROW_LEN": 16,
               "ROWS_PER_CHUNK": 2}
_DEFAULTS = {k: getattr(moe, k) for k in MOE_CHUNKED}


def shape_of(kind: str) -> ShapeConfig:
    return ShapeConfig(f"memory_{kind}", seq_len=SEQ, global_batch=BATCH,
                       kind=kind)


def inputs_of(cfg, shape: ShapeConfig, seed: int = 0
              ) -> Dict[str, torch.Tensor]:
    """The step's inputs, drawn with numpy from ``seed``, shaped as the
    dry run's input specs."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, spec in input_specs(cfg, shape)[0].items():
        shp = tuple(spec.shape)
        if k in ("tokens", "targets"):
            a = rng.integers(0, cfg.vocab, shp)
        elif k == "vision_mask":
            a = rng.random(shp) > 0.5
        elif k == "mrope_pos":
            t = np.arange(shp[-1])
            a = np.broadcast_to(np.stack([t, t // 2, t % 5])[:, None], shp)
        else:
            a = rng.standard_normal(shp)
        out[k] = torch.from_numpy(np.ascontiguousarray(a)).to(spec.dtype)
    return out


def _leaves(tree) -> List[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _leaves(v)]
    return []


class _Returned(TorchDispatchMode):
    """Marks in the profiler's trace, after each op, the storages the op
    returned: the blocks the dry run's walk counts.  Eager PyTorch under
    any dispatch mode (the walk's too) adds gradients out of place; this
    mode puts the real run on the same footing."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        ptrs = {t.untyped_storage().data_ptr() for t in _leaves(out)
                if t.untyped_storage().nbytes()}
        if ptrs:
            with record_function("returned " + " ".join(map(str, ptrs))):
                pass
        return out


def returned_peak(run: Callable[[], object]) -> int:
    """The most bytes held at once by the blocks ``run()``'s ops return,
    from the CPU allocator's events: each from its allocation until its
    free.  What an op allocates and frees inside itself (a kernel's
    scratch) and what is allocated outside any op (a scalar argument, the
    RNG state a rematerialized block keeps) are no op's result."""
    with profile(activities=[ProfilerActivity.CPU], profile_memory=True) \
            as prof:
        with _Returned():
            run()
    events = []

    def visit(node):
        fields = node.extra_fields
        if type(fields).__name__ == "_ExtraFields_Allocation":
            events.append((node.start_time_ns, 0, fields.ptr,
                           fields.alloc_size))
        elif node.name.startswith("returned "):
            events.append((node.start_time_ns, 1,
                           [int(p) for p in node.name.split()[1:]], 0))
        for child in node.children:
            visit(child)

    for node in prof.profiler.kineto_results.experimental_event_tree():
        visit(node)
    events.sort(key=lambda e: (e[0], e[1]))
    at: Dict[int, list] = {}          # ptr -> [bytes, returned]
    live = peak = 0
    for _, kind, ptr, size in events:
        if kind == 1:
            for p in ptr:
                block = at.get(p)
                if block is not None and not block[1]:
                    block[1] = True
                    live += block[0]
                    peak = max(peak, live)
        elif size > 0:
            at[ptr] = [size, False]
        else:
            block = at.pop(ptr, None)
            if block is not None and block[1]:
                live -= block[0]
    return peak


def _chunked(arch: str, kind: str):
    """The MoE's chunk loop on for a deepseek train step (``MOE_CHUNKED``)."""
    if arch.startswith("deepseek") and kind == "train":
        for k, v in MOE_CHUNKED.items():
            setattr(moe, k, v)


def run_for_real(arch: str, kind: str) -> int:
    """The step's peak on the CPU on plain tensors: the blocks its ops
    return (``returned_peak``) on top of its arguments (parameters,
    inputs, optimizer state or cache), already live."""
    cfg = get_smoke_config(arch)
    shape = shape_of(kind)
    model = Model(cfg, device="cpu").init_params(seed=0)
    batch = inputs_of(cfg, shape)
    if kind == "train":
        step, opt = make_train_step(model, TrainConfig())
        state = P.init(opt.state_spec(model.param_spec()),
                       torch.Generator().manual_seed(0), "float32", "cpu")
        args = list(model.parameters()) + _leaves(state) + _leaves(batch)

        def run():
            return step(state, batch, 1 << 20)
    else:
        # an encoder-decoder's cache holds the encoder's keys and values
        cache = model.init_cache(BATCH, SEQ, ENC_LEN_FOR_DECODE
                                 if cfg.is_encdec else 0)
        args = list(model.parameters()) + _leaves(cache) + _leaves(batch)
        step = make_decode_step(model)

        def run():
            return step(cache, batch["tokens"], SEQ - 1)
    live = {t.untyped_storage()._cdata: t.untyped_storage().nbytes()
            for t in args}
    return sum(live.values()) + returned_peak(run)


def walked(arch: str, kind: str):
    """The walk's ``peak_bytes`` and ``temp_bytes`` of the step on a mesh
    of one device (a ``fake`` world of one)."""
    from torch.distributed.device_mesh import DeviceMesh
    from repro_torch.launch.dryrun import walk_cell
    from repro_torch.launch.mesh import init_dry_run_world
    init_dry_run_world(1)
    mesh = DeviceMesh("cpu", torch.arange(1).reshape(1, 1),
                      mesh_dim_names=("data", "model"))
    _, cost, memory = walk_cell(get_smoke_config(arch), shape_of(kind), mesh)
    return cost.peak_bytes, memory["temp_bytes"]


def main(cases: List[str]) -> None:
    out = {}
    for case in cases:
        arch, kind = case.split(":")
        _chunked(arch, kind)
        peak, temp = walked(arch, kind)
        out[case] = {"walked": peak, "temp": temp,
                     "real": run_for_real(arch, kind)}
        for k, v in _DEFAULTS.items():
            setattr(moe, k, v)
    print("RESULT " + json.dumps(out))


if __name__ == "__main__":
    main(sys.argv[1:])
