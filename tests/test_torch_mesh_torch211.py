"""The dry run on torch 2.11 (the H100 machine's) reads what it reads on
torch 2.13: where DTensor 2.11 lacks a sharding strategy, or
refuses an op 2.13 runs, the port partitions the op itself under
``sharding.gspmd_partitioning``, on every torch, so that no walk leans
on the rule the versions differ in.  Two of 2.11's faults, stood in on
this torch (a file of its own so that ``--dist loadfile`` gives its
walks a worker):

  * its ``constant_pad_nd`` (the causal conv's pad of recurrentgemma-9b,
    MLA's cache pad): deleted from this torch's strategies, the walks of
    recurrentgemma-9b x train_4k and deepseek-v2-236b x prefill_32k read
    the numbers they read with it (committed) and run no op replicated
    (``sharding.OWN_RULES``: the port's pad rule runs first);
  * its refusal to flatten a dim split over "data" with one split over
    "model" (``_unsafe_view``, "Attempted to flatten multiple
    dimensions"), which DTensor's einsum does for attention's batched
    products and MLA's: no batched einsum of gemma2-27b and
    deepseek-v2-236b x train_4k (two layers, their full widths: the
    merge shows at any depth) reaches DTensor's einsum; each runs on
    its blocks (``sharding._einsum_on_blocks``).

2.11's redistribution planner, which fails where this torch's does not,
cannot be stood in here: the card runs these cells in ``chip_smoke.py``
14a."""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]

_NO_PAD = r"""
import json, sys
import torch
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.debug import _clear_sharding_prop_cache
prop = DTensor._op_dispatcher.sharding_propagator
del prop.op_single_dim_strategy_funcs[torch.ops.aten.constant_pad_nd.default]
_clear_sharding_prop_cache()
from repro_torch.launch.dryrun import run_cell
r = run_cell(sys.argv[1], sys.argv[2], False, verbose=False)
print("RESULT " + json.dumps(r))
"""

_EINSUMS = r"""
import json, sys
import torch
from torch.distributed.tensor import DTensor
from repro_torch.parallel import sharding as sh
from repro_torch.launch.dryrun import run_cell
run = sh._einsum_on_blocks
seen = {"blocks": 0, "dtensor": []}


def watched(args):
    out = run(args)
    parsed = sh._einsum_args(torch.einsum, args)
    if parsed is not None and all(isinstance(x, DTensor) for x in parsed[1]):
        ins, o = parsed[0].split("->")
        if any(all(c in sub for sub in ins.split(",")) for c in o):
            if out is None:
                seen["dtensor"].append(parsed[0])
            else:
                seen["blocks"] += 1
    return out


sh._einsum_on_blocks = watched
r = run_cell(sys.argv[1], "train_4k", False, opt_override={"n_layers": 2},
             verbose=False)
print("RESULT " + json.dumps({"status": r["status"], **seen}))
"""

# the walks of these cells on torch 2.13 with its pad strategy in place,
# which the walk reads on every torch (recurrentgemma-9b's all-reduce
# elements less its norms' gradients, reduced once in the backward
# rather than at each read in the optimizer)
WALKED = {
    ("recurrentgemma-9b", "train_4k"): {
        "dot_flops_per_device": 312948497055744.0,
        "coll_elements": {"all-reduce(g=16)": 102459154463.0,
                          "all-gather(g=16)": 28940173312.0,
                          "all-to-all(g=16)": 536870912.0,
                          "collective-permute(g=256)": 4784128.0,
                          "all-reduce(g=256)": 31.0},
        "output_bytes": 1075939056, "alias_bytes": 1075697668,
        "argument_bytes": 1080055816},
    ("deepseek-v2-236b", "prefill_32k"): {
        "dot_flops_per_device": 928990819778560.0,
        "coll_elements": {"all-to-all(g=16)": 296956723200.0,
                          "all-reduce(g=16)": 189079526400.0,
                          "all-gather(g=16)": 9898557440.0},
        "output_bytes": 4529873960, "alias_bytes": 0,
        "argument_bytes": 4611221504},
}


def _start(snippet, *args):
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    return subprocess.Popen([sys.executable, "-c", snippet, *args],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, env=env, cwd=ROOT)


@pytest.fixture(scope="module")
def walks():
    procs = {("pad",) + cell: _start(_NO_PAD, *cell) for cell in WALKED}
    procs.update({("einsum", arch): _start(_EINSUMS, arch)
                  for arch in ("gemma2-27b", "deepseek-v2-236b")})
    out = {}
    try:
        for key, proc in procs.items():
            stdout, stderr = proc.communicate(timeout=600)
            line = [ln for ln in stdout.splitlines()
                    if ln.startswith("RESULT ")]
            assert line, stderr[-3000:]
            out[key] = json.loads(line[0][len("RESULT "):])
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
    return out


@pytest.mark.parametrize("cell", sorted(WALKED))
def test_a_torch_without_the_pad_strategy_walks_alike(walks, cell):
    got, want = walks[("pad",) + cell], WALKED[cell]
    assert got["status"] == "ok", got
    assert got["replicated_ops"] == {}, got["replicated_ops"]
    assert got["dot_flops_per_device"] == want["dot_flops_per_device"]
    assert got["coll_elements"] == want["coll_elements"]
    mem = got["memory"]
    assert {k: mem[k] for k in ("output_bytes", "alias_bytes",
                                "argument_bytes")} \
        == {k: want[k] for k in ("output_bytes", "alias_bytes",
                                 "argument_bytes")}


@pytest.mark.parametrize("arch", ["gemma2-27b", "deepseek-v2-236b"])
def test_no_batched_einsum_reaches_dtensors_einsum(walks, arch):
    got = walks[("einsum", arch)]
    assert got["status"] == "ok", got
    assert got["dtensor"] == [], got["dtensor"]
    assert got["blocks"] > 0
