"""Every (arch x shape) cell of the port's dry run at smoke size, on the
16x16 production mesh, on the CPU: ``run_cell(..., smoke=True)`` walks
each cell's step (train, prefill or decode) on ``meta`` tensors at the
cell's full shape with the reduced config.  35 cells must report
``ok`` and the other 5 ``skip``, exactly where each config's
``skip_shapes`` says; none may ``FAIL``.  The dry run makes a process
group (the ``fake`` backend), so it runs in a subprocess of its own.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

from repro_torch.common.config import LM_SHAPES
from repro_torch.configs import ALL_ARCHS, get_smoke_config

ROOT = Path(__file__).resolve().parents[1]

_SNIPPET = r"""
import json
from repro_torch.common.config import LM_SHAPES
from repro_torch.configs import ALL_ARCHS
from repro_torch.launch.dryrun import run_cell
out = {f"{a}/{s.name}": run_cell(a, s.name, False, verbose=False, smoke=True)
       for a in ALL_ARCHS for s in LM_SHAPES}
print("RESULT " + json.dumps(out))
"""


def test_every_smoke_cell_walks_on_the_16x16_mesh():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    proc = subprocess.run([sys.executable, "-c", _SNIPPET],
                          capture_output=True, text=True, timeout=400,
                          env=env, cwd=ROOT)
    line = [ln for ln in proc.stdout.splitlines() if ln.startswith("RESULT ")]
    assert line, proc.stderr[-2000:]
    got = json.loads(line[0][len("RESULT "):])
    status = {}
    for arch in ALL_ARCHS:
        skips = get_smoke_config(arch).skip_shapes
        for shape in LM_SHAPES:
            r = got[f"{arch}/{shape.name}"]
            want = "skip" if shape.name in skips else "ok"
            assert r["status"] == want, (arch, shape.name, r)
            status[want] = status.get(want, 0) + 1
            if want == "ok":
                assert r["chips"] == 256 and r["flops_global"] > 0
                assert r["memory"]["argument_bytes"] > 0
                assert r["terms"]["collective_s"] is None
    assert status == {"ok": 35, "skip": 5}, status
    walk = {k: r["step_s"] for k, r in got.items() if r["status"] == "ok"}
    slow = max(walk, key=walk.get)
    print(f"35 smoke cells ok, 5 skipped; slowest walk {slow} "
          f"{walk[slow]} s, all {sum(walk.values()):.1f} s")
