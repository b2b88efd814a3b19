"""The port's dry run against the reference's partition, cell by cell, on
the 16x16 production mesh (``--multi-pod``: the 2x16x16 one; CPU).  For each ``arch shape`` cell it runs
the reference (``tests/_dryrun_ref.py``: ``run_cell`` plus one SPMD
partition's dot FLOPs and the elements each kind of collective moves)
and the port (``repro_torch.launch.dryrun.run_cell``) in a subprocess
each, and prints one row a cell: dot FLOPs port / reference, each
kind's elements port / reference (``0 of N``: a kind the port never
issues; ``port only``: one the reference never issues), argument,
alias and output bytes (``=`` where equal), whether the fallback text
is equal, ``replicated_ops`` and the port's walk seconds::

    PYTHONPATH=src python tests/_dryrun_survey.py                # all cells
    PYTHONPATH=src python tests/_dryrun_survey.py granite-3-2b:train_4k \\
        xlstm-125m:decode_32k --jobs 2 --timeout 600 --json out.json
    PYTHONPATH=src python tests/_dryrun_survey.py --multi-pod --json pod.json
    python tests/_dryrun_survey.py --compare before.json after.json

A skipped cell reads ``skip``; a cell whose run outlasts ``--timeout``
seconds reads ``timeout`` (its subprocess is killed).  ``--jobs`` cells
run at once (each holds a reference compile of up to a few GB).

``--sources`` (off by default: it slows the port's walk) splits each
kind's elements, and the dot FLOPs, by the code that issued them, on
both sides, and prints a line for each source under the cell's row:
``kind | file:function`` (``bwd`` before the function in the backward
pass), the port's and the reference's amounts and their ratio.  The
reference's source is the innermost frame of its model, train or optim
code in the instruction's ``metadata`` (``tests/_dryrun_ref.py``), the
port's that of the op that issued it (``cost_analysis.BY_SOURCE``)::

    PYTHONPATH=src python tests/_dryrun_survey.py --sources \
        deepseek-v2-236b:decode_32k --json out.json"""
import argparse
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

_PORT = r"""
import json, os, sys
from repro_torch.launch import cost_analysis
from repro_torch.launch.dryrun import run_cell
cost_analysis.BY_SOURCE = os.environ.get("DRYRUN_BY_SOURCE") == "1"
multi_pod = sys.argv[1] == "--multi-pod"
arch, shapes = sys.argv[1 + multi_pod], sys.argv[2 + multi_pod:]
out = {s: run_cell(arch, s, multi_pod, verbose=False) for s in shapes}
print("RESULT " + json.dumps(out))
"""


SOURCES = False       # --sources
MULTI_POD = False     # --multi-pod


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    env.setdefault("JAX_PLATFORMS", "cpu")
    if SOURCES:
        env["DRYRUN_BY_SOURCE"] = "1"
    return env


def _run(cmd, timeout):
    """The ``RESULT`` of ``cmd``, or ``{"status": "timeout"}`` / ``{"status":
    "FAIL", "error": ...}``, and its seconds."""
    t0 = time.time()
    try:
        p = subprocess.run(cmd, capture_output=True, text=True, env=_env(),
                           cwd=ROOT, timeout=timeout)
    except subprocess.TimeoutExpired:
        return {"status": "timeout"}, time.time() - t0
    for line in p.stdout.splitlines():
        if line.startswith("RESULT "):
            return json.loads(line[len("RESULT "):]), time.time() - t0
    return {"status": "FAIL", "error": p.stderr[-1500:]}, time.time() - t0


def survey_cell(arch, shape, timeout):
    """The reference's and the port's reports of one cell."""
    flag = ["--multi-pod"] if MULTI_POD else []
    with ThreadPoolExecutor(2) as ex:
        ref = ex.submit(_run, [sys.executable, str(ROOT / "tests" /
                                                   "_dryrun_ref.py"),
                               *flag, arch, shape], timeout)
        port = ex.submit(_run, [sys.executable, "-c", _PORT, *flag, arch,
                                shape], timeout)
        (w, tw), (g, tg) = ref.result(), port.result()
    w = w.get(shape, w)
    g = g.get(shape, g)
    return {"arch": arch, "shape": shape, "ref": w, "port": g,
            "ref_s": round(tw, 1), "port_s": round(tg, 1)}


def _ratio(a, b):
    return f"{a / b:.4f}" if b else ("=" if a == b else f"{a:.4g} vs 0")


def row(cell):
    """One line of the table for a ``survey_cell`` result."""
    w, g = cell["ref"], cell["port"]
    head = f"{cell['arch']} {cell['shape']}"
    if w.get("status") != "ok" or g.get("status") != "ok":
        why = [f"ref {w.get('status')}", f"port {g.get('status')}"]
        for who, r in (("ref", w), ("port", g)):
            if r.get("status") == "FAIL":
                why.append(f"{who}: {r.get('error', '')[-300:]!r}")
        return f"{head} | " + "; ".join(why)
    dot = _ratio(g["dot_flops_per_device"], w["dot_flops"])
    ge, we = g["coll_elements"], w["coll_elements"]
    kinds = []
    for k in sorted(set(ge) | set(we)):
        if k not in we:
            kinds.append(f"{k} port only {ge[k]:,.0f}")
        elif k not in ge:
            kinds.append(f"{k} 0 of {we[k]:,.0f}")
        else:
            kinds.append(f"{k} {ge[k] / we[k]:.4f}")
    gm, wm = g["memory"], w["memory"]
    mem = []
    for key in ("argument_bytes", "alias_bytes", "output_bytes"):
        a, b = gm[key], wm[key]
        mem.append(f"{key.split('_')[0]} " + ("=" if a == b else
                                              f"{a:,} vs {b:,}"))
    fb = "fallbacks =" if g["sharding_fallbacks"] == \
        w["sharding_fallbacks"] else "fallbacks DIFFER"
    return (f"{head} | dot {dot} | " + ", ".join(kinds) + " | "
            + "; ".join(mem) + f" | {fb} | replicated "
            f"{g['replicated_ops']} | walk {g['step_s']} s"
            + "".join(f"\n    {line}" for line in source_lines(cell)))


def source_lines(cell):
    """With ``--sources``: a line for each ``kind | source`` of either
    side, its port and reference amounts and their ratio."""
    gs = cell["port"].get("coll_by_source", {})
    ws = cell["ref"].get("coll_by_source", {})
    for k in sorted(set(gs) | set(ws)):
        a, b = gs.get(k, 0), ws.get(k, 0)
        yield f"{k}: port {a:,.0f} ref {b:,.0f} ({_ratio(a, b)})"


def _verdict(cell):
    """A cell in a few words: its dot FLOPs ratio, the kinds of
    collective off by more than 1 % (or missing, or the port's alone
    above 0.1 % of its elements), the memory columns that differ, the
    temp bytes port / reference, the ops run replicated, the walk s."""
    w, g = cell["ref"], cell["port"]
    if w.get("status") != "ok" or g.get("status") != "ok":
        return g.get("status", "?"), "", "", "", "", ""
    ge, we = g["coll_elements"], w["coll_elements"]
    off = [f"{k.split('(')[0].replace('collective-', 'c')}"
           f"{k[k.index('('):]} " + (f"{ge[k] / we[k]:.3g}" if k in ge
                                     else "0")
           for k in sorted(we) if abs(ge.get(k, 0) / we[k] - 1) > 0.01]
    extra = sum(v for k, v in ge.items() if k not in we)
    if extra > 1e-3 * sum(ge.values()):
        off.append(f"port-only {extra:.3g}")
    mem = [k.split("_")[0] for k in ("argument_bytes", "alias_bytes")
           if g["memory"][k] != w["memory"][k]]
    if not 0 <= w["memory"]["output_bytes"] \
            - g["memory"]["output_bytes"] <= 1024:
        mem.append("output")
    dot = g["dot_flops_per_device"] / w["dot_flops"]
    temp = g["memory"]["temp_bytes"] / max(w["memory"]["temp_bytes"], 1)
    return (f"{dot:.4f}", "; ".join(off) or "all 1 %",
            ", ".join(mem) or "=", f"{temp:.4f}",
            ", ".join(f"{k} {v}" for k, v in g["replicated_ops"].items())
            or "none", f"{g['step_s']}")


def compare(before, after):
    """A markdown row a cell: dot FLOPs, kinds, memory, temp bytes and
    replicated ops before → after (two ``--json`` files of this script;
    one file twice: its own table), walk seconds."""
    old = {(c["arch"], c["shape"]): c for c in before}
    print("| cell | dot | kinds off | memory off | temp | replicated "
          "| walk s |")
    print("|---|---|---|---|---|---|---|")
    for c in after:
        b = old.get((c["arch"], c["shape"]))
        v1, v2 = _verdict(b) if b else ("",) * 6, _verdict(c)
        if v2[0] == "skip":
            continue
        cols = [f"{x} → {y}" if x != y else y for x, y in zip(v1, v2)]
        print(f"| {c['arch']} {c['shape']} | " + " | ".join(cols) + " |")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("cells", nargs="*", help="arch:shape (default: all)")
    ap.add_argument("--jobs", type=int, default=2)
    ap.add_argument("--timeout", type=float, default=900)
    ap.add_argument("--json", default=None)
    ap.add_argument("--compare", nargs=2, metavar=("BEFORE", "AFTER"),
                    help="two --json files: print the table, run nothing")
    ap.add_argument("--sources", action="store_true",
                    help="split each kind and the dot FLOPs by source")
    ap.add_argument("--multi-pod", action="store_true",
                    help="the 2x16x16 mesh, on both sides")
    args = ap.parse_args(argv)
    global SOURCES, MULTI_POD
    SOURCES, MULTI_POD = args.sources, args.multi_pod
    if args.compare:
        before, after = (json.load(open(f)) for f in args.compare)
        return compare(before, after)
    if args.cells:
        cells = [tuple(c.split(":")) for c in args.cells]
    else:
        sys.path.insert(0, str(ROOT / "src"))
        from repro_torch.common.config import LM_SHAPES
        from repro_torch.configs import ALL_ARCHS
        cells = [(a, s.name) for a in ALL_ARCHS for s in LM_SHAPES]
    out = []
    with ThreadPoolExecutor(args.jobs) as ex:
        for cell in ex.map(lambda c: survey_cell(*c, args.timeout), cells):
            print(row(cell), flush=True)
            out.append(cell)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)


if __name__ == "__main__":
    main()
