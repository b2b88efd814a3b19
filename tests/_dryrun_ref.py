"""The reference's dry run of one arch's cells on its 16x16 production
mesh, rebuilt with Auto axes (JAX 0.9 makes Explicit axes, where its own
``tests/test_dryrun.py`` fails; nothing in ``src/repro`` changes for
that): ``run_cell``'s report, plus the partition's dot FLOPs and the
elements each kind of collective moves, read from the compiled HLO with
the reference's own ``parse_module``, ``_dot_flops`` and ``_trip_count``.
Prints ``RESULT`` and the reports as JSON, a cell a key::

    PYTHONPATH=src python tests/_dryrun_ref.py gemma2-2b train_4k long_500k

``tests/test_torch_mesh_dryrun.py`` holds the port's dry run to it.
"""
import collections
import json
import sys

import repro.launch.dryrun as d        # sets the 512-device flag first
import jax
from repro.launch import hlo_analysis as h


def partition(text):
    # the partition's dot FLOPs and the elements each kind of collective
    # moves: every instruction of the module, a while body's times its
    # trip count, a fusion's or call's counted where it is called (the
    # call graph hlo_analysis.ModuleCost walks)
    comps = h.parse_module(text)
    elements = collections.Counter()

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
                total += trips * h._dot_flops(ins, comp)
            for kind in h.COLLECTIVES:
                if ins.opcode in (kind, kind + "-start"):
                    g = h._group_size(ins.attrs, 256)
                    elements[f"{kind}(g={g})"] += \
                        trips * h._shape_bytes_elems(ins.type_str)[1]
        return total
    return walk(h.ModuleCost(text).entry, 1), dict(elements)


def auto_mesh(*, multi_pod=False):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return jax.make_mesh(shape, axes,
                         axis_types=(jax.sharding.AxisType.Auto,) * len(axes))


d.mesh_lib.make_production_mesh = auto_mesh
texts = []
analyze = d.analyze
d.analyze = lambda text, n: (texts.append(text), analyze(text, n))[1]
out = {}
for s in sys.argv[2:]:
    out[s] = d.run_cell(sys.argv[1], s, False, verbose=False)
    if out[s]["status"] == "ok":     # a skipped or failed cell has no HLO
        out[s]["dot_flops"], out[s]["coll_elements"] = partition(texts.pop())
print("RESULT " + json.dumps(out))
