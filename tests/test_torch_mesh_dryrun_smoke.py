"""Every (arch x shape) cell of the port's dry run at smoke size, on both
production meshes (16x16 and 2x16x16), on the CPU: ``run_cell(...,
smoke=True)`` walks one rank's share of each cell's step (train, prefill
or decode) as DTensors of ``meta`` blocks at the cell's full shape with
the reduced config.  On each mesh 35 cells must report ``ok`` and the
other 5 ``skip``, exactly where each config's ``skip_shapes`` says; none
may ``FAIL``.  Every ``ok`` cell splits something over the mesh, so its
``collective_s`` is positive; the ops DTensor could not shard as placed
are named in ``replicated_ops`` (their gathers counted) and printed;
the MoE archs' cells on the 16x16 mesh run none.
The dry run makes a process group (the ``fake`` backend), so the cells
run in subprocesses, all at once: the 16x16 mesh's in one, the 2x16x16
mesh's (whose walks take 2-4x longer: DTensor weighs strategies over
three mesh axes) in four groups of archs, each subprocess walking its
cells in one ``gspmd_partitioning`` (as the CLI's ``--all``) so that
they share DTensor's sharding decisions.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from repro_torch.common.config import LM_SHAPES
from repro_torch.configs import ALL_ARCHS, get_smoke_config

ROOT = Path(__file__).resolve().parents[1]
MESHES = {"16x16": False, "2x16x16": True}

_SNIPPET = r"""
import json, sys
from repro_torch.common.config import LM_SHAPES
from repro_torch.configs import ALL_ARCHS
from repro_torch.launch.dryrun import run_cell
from repro_torch.parallel.sharding import gspmd_partitioning
multi_pod, archs = sys.argv[1] == "1", sys.argv[2:]
with gspmd_partitioning():      # the cells share DTensor's decisions
    out = {f"{a}/{s.name}": run_cell(a, s.name, multi_pod, verbose=False,
                                     smoke=True)
           for a in archs for s in LM_SHAPES}
print("RESULT " + json.dumps(out))
"""

# the archs each subprocess walks on each mesh, of about equal walks
GROUPS = {"16x16": (ALL_ARCHS,),
          "2x16x16": (("gemma3-4b", "gemma2-27b", "gemma2-2b",
                       "granite-3-2b"),
                      ("deepseek-v3-671b", "deepseek-v2-236b",
                       "whisper-base"),
                      ("recurrentgemma-9b", "qwen2-vl-72b"),
                      # its train cell walks again on "model" cut 2 x 8
                      ("xlstm-125m",))}


@pytest.fixture(scope="module")
def walks():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    for groups in GROUPS.values():
        assert sorted(sum(groups, ())) == sorted(ALL_ARCHS)
    procs = {(name, group): subprocess.Popen(
        [sys.executable, "-c", _SNIPPET, "1" if mp else "0", *group],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
        cwd=ROOT) for name, mp in MESHES.items() for group in GROUPS[name]}
    out = {name: {} for name in MESHES}
    try:
        for (name, _), proc in procs.items():
            stdout, stderr = proc.communicate(timeout=900)
            line = [ln for ln in stdout.splitlines()
                    if ln.startswith("RESULT ")]
            if not line:
                out[name] = stderr[-2000:]
            elif isinstance(out[name], dict):
                out[name].update(json.loads(line[0][len("RESULT "):]))
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    return out


def test_every_smoke_cell_walks_on_the_16x16_mesh(walks):
    _check_walks(walks, "16x16")


def test_every_smoke_cell_walks_on_the_2x16x16_mesh(walks):
    _check_walks(walks, "2x16x16")


def test_moe_smoke_cells_run_nothing_replicated_on_the_16x16_mesh(walks):
    """The deepseek smoke cells' MoE layers take the reference's branches
    on the DTensor token stream (flat for decode, chunked for prefill and
    train) with 8 experts, which "data" cannot split: every op of their
    walks on the 16x16 mesh is partitioned, none run replicated."""
    got = walks["16x16"]
    assert isinstance(got, dict), got
    for arch in ("deepseek-v2-236b", "deepseek-v3-671b"):
        for shape in LM_SHAPES:
            r = got[f"{arch}/{shape.name}"]
            if r["status"] == "ok":
                assert r["replicated_ops"] == {}, (arch, shape.name, r)


def _check_walks(walks, mesh):
    got = walks[mesh]
    assert isinstance(got, dict), got
    status, replicated = {}, {}
    for arch in ALL_ARCHS:
        skips = get_smoke_config(arch).skip_shapes
        for shape in LM_SHAPES:
            r = got[f"{arch}/{shape.name}"]
            want = "skip" if shape.name in skips else "ok"
            assert r["status"] == want, (arch, shape.name, r)
            status[want] = status.get(want, 0) + 1
            if want == "ok":
                assert r["mesh"] == mesh
                assert r["chips"] == (512 if MESHES[mesh] else 256)
                assert r["dot_flops_per_device"] > 0
                assert r["flops_per_device"] >= r["dot_flops_per_device"]
                assert r["memory"]["argument_bytes"] > 0
                if shape.kind == "prefill":
                    # a donated cache leaf is aliased only if read: one
                    # the prefill overwrites whole is neither
                    assert 0 <= r["memory"]["alias_bytes"] <= \
                        r["memory"]["argument_bytes_by_tree"]["cache"]
                else:
                    assert r["memory"]["alias_bytes"] > 0
                assert r["terms"]["collective_s"] > 0, (arch, shape.name)
                assert r["bottleneck"] == max(r["terms"],
                                              key=r["terms"].get)
                if r["replicated_ops"]:
                    replicated[f"{arch}/{shape.name}"] = r["replicated_ops"]
    assert status == {"ok": 35, "skip": 5}, status
    walk = {k: r["step_s"] for k, r in got.items() if r["status"] == "ok"}
    slow = max(walk, key=walk.get)
    print(f"{mesh}: 35 smoke cells ok, 5 skipped; slowest walk {slow} "
          f"{walk[slow]} s, all {sum(walk.values()):.1f} s; run "
          f"replicated or gathered before a view: {replicated}")
