"""The rules by which ``sharding.gspmd_partitioning`` partitions the
long-context decode's attention and RG-LRU gates and the training
step's gate backward and update as the reference's partitioner does,
each on a toy op on the 16x16 production mesh (one rank's share,
``launch.cost_analysis.count_step`` over DTensors of ``meta`` blocks):

  * ``_whole_over_free``: a product whose operands split different
    letters over "model" (the queries' heads, the cache's sequence)
    makes the smaller whole by way of the free "data";
  * ``product_as`` where "data" is free (``_split_partial``): the
    output's wanted letter split over "data", a block's partial sums
    all-reduced over "model", the split moved back to "model";
  * ``product_as`` where no axis is free (``_GatheredCotangent``): the
    forward as it was, the backward gathering the output's gradient
    for each transposed product;
  * ``_take_split``: an in-place update outside autograd takes its
    operand's split, a stacked leaf's layer with its stack;
  * ``set_slot``: the new entry gathered whole on every rank, whichever
    rank writes it.

The production mesh lives on a dry-run world (the ``fake`` backend), so
every case runs in one subprocess (its results checked here)."""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]

_CASES = r"""
import json
import torch
from torch.distributed.tensor import DTensor, Replicate, Shard
from repro_torch.launch import cost_analysis as ca
from repro_torch.launch import mesh as m
from repro_torch.parallel import sharding as sh

mesh = m.make_production_mesh()
R, S = Replicate(), Shard


def dt(shape, placements, grad=False):
    local = list(shape)
    for i, p in enumerate(placements):
        if p.is_shard():
            local[p.dim] //= mesh.size(i)
    stride = torch.empty(shape, device="meta").stride()
    t = DTensor.from_local(torch.empty(local, device="meta"), mesh,
                           placements, run_check=False,
                           shape=torch.Size(shape), stride=stride)
    return t.detach().requires_grad_(grad)


def cost(fn):
    c = ca.count_step(fn)
    return {"dot_flops": c.dot_flops, "elements": c.coll_elements}


def where(t):
    return {"placements": [str(p) for p in t.placements],
            "local": list(t.to_local().shape)}


out = {}
with sh.gspmd_partitioning():
    # decode attention over a sequence-split cache: q's 16 KV heads over
    # "model", the cache's 4096 positions over "model", "data" free
    q = dt((1, 1, 16, 2, 128), [R, S(2)])
    k = dt((1, 4096, 16, 128), [R, S(1)])
    res = {}
    out["scores"] = cost(lambda: res.setdefault("y", torch.einsum(
        "bsngd,btnd->bnsgt", q, k)))
    out["scores"].update(where(res["y"]))
    probs = dt((1, 16, 1, 2, 4096), [R, S(4)])
    v = dt((1, 4096, 16, 128), [R, S(1)])
    res = {}
    out["values"] = cost(lambda: res.setdefault("y", sh.product_as(
        q, torch.einsum, "bnsgt,btnd->bsngd", probs, v)))
    out["values"].update(where(res["y"]))
    whole = dt((1, 1, 16, 2, 128), [R, R])
    out["values whole"] = cost(lambda: sh.product_as(
        whole, torch.einsum, "bnsgt,btnd->bsngd", probs, v))
    # a training step's gate: tokens over "data", lru over "model"
    x = dt((256, 64, 512), [S(0), S(2)], grad=True)
    w = dt((512, 512), [R, S(0)], grad=True)
    dy = dt((256, 64, 512), [S(0), S(2)])
    out["gate"] = cost(lambda: sh.product_as(x, torch.matmul, x, w
                                             ).backward(dy))
    out["gate"]["grads"] = [where(x.grad), where(w.grad)]
    # the update of a whole parameter by a split gradient, in place
    p, g = dt((4096,), [R, R]), dt((4096,), [R, S(0)])
    stack = dt((3, 4096), [R, R])
    with torch.no_grad():
        layer = stack[1]
        out["update"] = cost(lambda: (p.add_(g), layer.mul_(0.9).add_(g)))
    out["update"].update({"param": where(p), "stack": where(stack),
                          "layer": where(layer)})
    # a decode step's write into a cache split along its sequence
    buf = dt((1, 4096, 16, 128), [R, S(1)])
    new = dt((1, 1, 16, 128), [R, S(2)])
    out["slot"] = cost(lambda: sh.set_slot(buf, 1, 4095, new))
    out["slot"]["coordinate"] = mesh.get_coordinate()
print("RESULT " + json.dumps(out))
"""


@pytest.fixture(scope="module")
def cases():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    proc = subprocess.run([sys.executable, "-c", _CASES], capture_output=True,
                          text=True, timeout=300, env=env, cwd=ROOT)
    line = [ln for ln in proc.stdout.splitlines() if ln.startswith("RESULT ")]
    assert line, proc.stderr[-3000:]
    return json.loads(line[0][len("RESULT "):])


def test_conflicting_splits_make_the_smaller_whole_by_the_free_axis(cases):
    """q's (1, 1, 1, 2, 128) block moves to "data" (one collective-permute)
    and is gathered there (16 x 256 elements); the keys keep their
    sequence split, so the scores are this rank's 256 positions of all
    16 x 2 heads."""
    c = cases["scores"]
    assert c["elements"] == {"collective-permute(g=256)": 256,
                             "all-gather(g=16)": 16 * 2 * 128}
    assert c["dot_flops"] == 2 * 16 * 2 * 128 * 256
    assert c["placements"] == ["R", "S(4)"]


def test_a_product_over_a_split_takes_the_free_axis_for_its_output(cases):
    """The value product contracts the split sequence; its output is
    wanted with q's heads over "model": this rank's head over "data"
    times its 256 positions, the (1, 1, 1, 2, 128) partial sum
    all-reduced over "model" and moved to "model"; with no split
    wanted, the whole head set is reduced."""
    c = cases["values"]
    assert c["dot_flops"] == 2 * 2 * 256 * 128
    assert c["elements"] == {"all-reduce(g=16)": 256,
                             "collective-permute(g=256)": 256}
    assert c["placements"] == ["R", "S(2)"] and c["local"] == [1, 1, 1, 2, 128]
    assert cases["values whole"]["elements"] == {
        "all-reduce(g=16)": 16 * 2 * 128}


def test_a_gate_backward_gathers_the_gradient_for_each_product(cases):
    """(256, 64, 512) tokens over "data" with their 512 over "model",
    times a (512, 512) gate split by rows over "model": forward, the
    product's partial sums all-reduced (the rank's 16 x 64 x 512);
    backward, the output's gradient gathered whole over "model" once
    for each operand's product (two all-gathers), the tokens' gradient
    split as they are with nothing reduced, the gate's summed over the
    rank's tokens and all-reduced over "data" (its 32 x 512 rows)."""
    c = cases["gate"]
    act = 16 * 64 * 512
    assert c["elements"] == {"all-reduce(g=16)": act + 32 * 512,
                             "all-gather(g=16)": 2 * act}
    assert c["dot_flops"] == 3 * 2 * 16 * 64 * 512 * 32
    assert c["grads"][0]["placements"] == ["S(0)", "S(2)"]
    assert c["grads"][1]["placements"] == ["R", "S(0)"]


def test_an_update_in_place_takes_its_operands_split(cases):
    """A whole (4096,) parameter plus a gradient split over "model"
    leaves the update split (this rank's 256), nothing moved; a layer
    of a stacked (3, 4096) moment takes the split with its stack."""
    c = cases["update"]
    assert c["elements"] == {}
    assert c["param"] == {"placements": ["R", "S(0)"], "local": [256]}
    assert c["stack"] == {"placements": ["R", "S(1)"], "local": [3, 256]}
    assert c["layer"] == {"placements": ["R", "S(0)"], "local": [256]}


def test_a_cache_write_gathers_the_entry_on_every_rank(cases):
    """Rank (0, 0) does not hold position 4095 of a cache split over
    "model" along its sequence, yet takes part in gathering the new
    (1, 1, 16, 128) entry split by its heads (the reference's SPMD
    all-gather before its dynamic-update-slice)."""
    c = cases["slot"]
    assert c["coordinate"] == [0, 0]
    assert c["elements"] == {"all-gather(g=16)": 16 * 128}
