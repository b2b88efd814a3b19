"""The reference's dry run of one arch's cells on its 16x16 production
mesh (``--multi-pod``: its 2x16x16 one), rebuilt with Auto axes (JAX 0.9 makes Explicit axes, where its own
``tests/test_dryrun.py`` fails; nothing in ``src/repro`` changes for
that): ``run_cell``'s report, plus the partition's dot FLOPs and the
elements each kind of collective moves, read from the compiled HLO with
the reference's own ``parse_module``, ``_dot_flops`` and ``_trip_count``.
Prints ``RESULT`` and the reports as JSON, a cell a key::

    PYTHONPATH=src python tests/_dryrun_ref.py gemma2-2b train_4k long_500k
    PYTHONPATH=src python tests/_dryrun_ref.py --multi-pod gemma2-2b train_4k

With ``DRYRUN_BY_SOURCE=1`` in the environment each report also has
``coll_by_source``: each kind's elements and the dot FLOPs by the code
that issued them (``"kind | source"``; the innermost frame of the
reference's model, train or optim code, from the instruction's
``metadata`` and the module's stack-frame table; ``bwd`` where its
``op_name`` is a transpose).

``tests/test_torch_mesh_dryrun.py`` holds the port's dry run to it.
"""
import collections
import json
import os
import re
import sys

import repro.launch.dryrun as d        # sets the 512-device flag first
import jax
from repro.launch import hlo_analysis as h


BY_SOURCE = os.environ.get("DRYRUN_BY_SOURCE") == "1"


def _frames(text):
    """stack_frame_id -> ``"models/moe.py:_moe_flat"``: the innermost frame
    of the reference's model, train or optim code (its parallel and
    launch layers apart) in the module's stack-frame tables."""
    tables = {k: {} for k in ("FileNames", "FunctionNames",
                              "FileLocations", "StackFrames")}
    table = None
    for line in text.splitlines():
        s = line.strip()
        if s in tables:
            table = tables[s]
            continue
        m = re.match(r"(\d+) (.*)$", s) if table is not None else None
        if m is None:
            table = None
            continue
        key, rest = int(m.group(1)), m.group(2)
        fields = {k: int(v) for k, v in re.findall(r"(\w+)=(\d+)", rest)}
        table[key] = fields or rest.strip('"')
    files, funcs = tables["FileNames"], tables["FunctionNames"]
    locs, stack = tables["FileLocations"], tables["StackFrames"]

    def source(frame):
        seen = set()
        while frame in stack and frame not in seen:
            seen.add(frame)
            loc = locs[stack[frame]["file_location_id"]]
            path = files[loc["file_name_id"]]
            if "/repro/" in path and "/parallel/" not in path \
                    and "/launch/" not in path:
                return (path.split("/repro/")[-1] + ":"
                        + funcs[loc["function_name_id"]])
            frame = stack[frame]["parent_frame_id"]
        return "?"
    return source


def _where(ins, source):
    frame = re.search(r"stack_frame_id=(\d+)", ins.attrs)
    op = re.search(r'op_name="([^"]*)"', ins.attrs)
    return ("bwd " if op and "transpose(" in op.group(1) else "") \
        + (source(int(frame.group(1))) if frame else "?")


def partition(text, devices):
    # the partition's dot FLOPs and the elements each kind of collective
    # moves: every instruction of the module, a while body's times its
    # trip count, a fusion's or call's counted where it is called (the
    # call graph hlo_analysis.ModuleCost walks); with BY_SOURCE, both
    # split by source.  A collective without replica groups spans the
    # mesh's ``devices`` (the reference's own ``coll_breakdown`` labels
    # it so)
    comps = h.parse_module(text)
    elements = collections.Counter()
    by_source = collections.Counter()
    source = _frames(text) if BY_SOURCE else None

    def walk(name, trips):
        total, comp = 0.0, comps.get(name)
        for ins in comp.instrs if comp else ():
            called = h._CALLED.findall(ins.attrs)
            if ins.opcode == "while":
                cond = h._COND.search(ins.attrs)
                total += walk(called[0],
                              trips * h._trip_count(comps[cond.group(1)]))
            elif ins.opcode in ("fusion", "call", "async-start",
                                "custom-call", "conditional"):
                total += sum(walk(c, trips) for c in called)
            elif ins.opcode == "dot":
                f = trips * h._dot_flops(ins, comp)
                total += f
                if source:
                    by_source[f"dot | {_where(ins, source)}"] += f
            for kind in h.COLLECTIVES:
                if ins.opcode in (kind, kind + "-start"):
                    g = h._group_size(ins.attrs, devices)
                    n = trips * h._shape_bytes_elems(ins.type_str)[1]
                    elements[f"{kind}(g={g})"] += n
                    if source:
                        by_source[f"{kind}(g={g}) | "
                                  f"{_where(ins, source)}"] += n
        return total
    return walk(h.ModuleCost(text).entry, 1), dict(elements), \
        dict(sorted(by_source.items()))


def auto_mesh(*, multi_pod=False):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return jax.make_mesh(shape, axes,
                         axis_types=(jax.sharding.AxisType.Auto,) * len(axes))


d.mesh_lib.make_production_mesh = auto_mesh
texts = []
analyze = d.analyze
d.analyze = lambda text, n: (texts.append((text, n)), analyze(text, n))[1]
args = sys.argv[1:]
multi_pod = "--multi-pod" in args
if multi_pod:
    args.remove("--multi-pod")
out = {}
for s in args[1:]:
    out[s] = d.run_cell(args[0], s, multi_pod, verbose=False)
    if out[s]["status"] == "ok":     # a skipped or failed cell has no HLO
        out[s]["dot_flops"], out[s]["coll_elements"], by_source = \
            partition(*texts.pop())
        if BY_SOURCE:
            out[s]["coll_by_source"] = by_source
print("RESULT " + json.dumps(out))
