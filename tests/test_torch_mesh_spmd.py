"""One rank's share of an op on the production mesh, as the dry run
counts it (``launch.cost_analysis.count_step`` over DTensors of ``meta``
blocks) and places it (``parallel.sharding``): local FLOPs only, each
collective DTensor issues counted by kind and group, a reduction over
several mesh axes as one collective over their product, an op DTensor
has no strategy for run replicated with its gathers counted, and under
``gspmd_partitioning`` a weight gathered at use with its gradient cut
into slabs along its FSDP dim.

The production mesh lives on a dry-run world (the ``fake`` backend), so
every case runs in one subprocess (its results checked here, case by
case): a process group made in the pytest worker would leak into the
next test file on that worker.
"""
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
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from repro_torch.launch import cost_analysis as ca
from repro_torch.launch import mesh as m
from repro_torch.parallel import sharding as sh

single = m.make_production_mesh()
multi = m.make_production_mesh(multi_pod=True)
R, P, S = Replicate(), Partial(), Shard


def dt(shape, placements, mesh=single):
    local = list(shape)
    for i, p in enumerate(placements):
        if p.is_shard():
            local[p.dim] //= mesh.size(i)
    stride = torch.empty(shape, device="meta").stride()
    return DTensor.from_local(torch.empty(local, device="meta"), mesh,
                              placements, run_check=False,
                              shape=torch.Size(shape), stride=stride)


def cost(fn):
    c = ca.count_step(fn)
    return {"flops": c.flops, "dot_flops": c.dot_flops, "bytes": c.bytes,
            "coll": c.coll_bytes, "elements": c.coll_elements,
            "traffic": c.coll_traffic, "replicated": c.replicated_ops}


out = {}
x, w = dt((4096, 1024), [S(0), R]), dt((1024, 2048), [R, S(1)])
out["matmul"] = cost(lambda: x @ w)
a, b = dt((2048, 512), [S(0), R]), dt((512, 256), [R, S(1)])
out["first"] = cost(lambda: a @ b)
out["again"] = cost(lambda: a @ b)
for name, pl, mesh in (("P,R", [P, R], single), ("R,P", [R, P], single),
                       ("P,P", [P, P], single),
                       ("P,P,P", [P, P, P], multi)):
    t = dt((64, 32), pl, mesh)
    out["reduce " + name] = cost(
        lambda: t.redistribute(mesh, [R] * mesh.ndim))
v = dt((4096,), [S(0), R])
q = dt((100,), [R, R])
out["searchsorted"] = cost(lambda: torch.searchsorted(v, q))
u = dt((8, 64), [R, S(1)])
out["view"] = cost(lambda: u.view(8, 4, 16))
# a product whose operands are replicated over "model": DTensor alone
# slices it there for free; held whole under gspmd_partitioning
f = dt((1024, 2048), [S(0), R])
out["mm free"] = cost(lambda: x @ f)
with sh.gspmd_partitioning():
    out["mm held"] = cost(lambda: x @ f)
out["mm after"] = cost(lambda: x @ f)
# weights placed with their FSDP dim split over "data" (as place_meta
# marks them), used under gspmd_partitioning: gathered at use, their
# gradients cut into slabs along that dim.  Square, so that only the
# FSDP dim, not a size, tells the slab's dim
def weight(shape, placements, dims):
    p = torch.nn.Parameter(dt(shape, placements))
    p.fsdp_dims = dims
    return p


with sh.gspmd_partitioning():
    xs, dy = dt((4096, 512), [S(0), R]), dt((4096, 512), [S(0), R])
    w_in = weight((512, 512), [S(0), R], (0,))      # (embed, heads x dim)
    w_out = weight((512, 512), [S(1), R], (1,))     # (heads x dim, embed)
    out["fsdp"] = cost(lambda: ((xs @ w_in) @ w_out).backward(dy))
    m = weight((512, 2048), [S(0), S(1)], (0,))     # (embed, d_ff)
    dm = dt((4096, 2048), [S(0), S(1)])
    out["fsdp no free axis"] = cost(lambda: (xs @ m).backward(dm))
    out["fsdp grads"] = [[str(p) for p in w.grad.placements]
                         for w in (w_in, w_out, m)]
    s2 = dt((256, 4096, 512), [S(2), R])
    out["shard to shard"] = cost(lambda: s2.redistribute(single, [S(0), R]))
out["shard to shard outside"] = cost(
    lambda: s2.redistribute(single, [S(0), R]))
# constrain: a DTensor is redistributed to its spec, a plain tensor kept
with sh.activate(single, sh.make_rules("train"), "spmd"):
    r = dt((256, 4096, 64), [R, R])
    plain = torch.empty((256, 4096, 64), device="meta")
    c = sh.constrain(r, "batch", "seq", "d_model")
    out["constrain"] = {"placements": [str(p) for p in c.placements],
                        "local": list(c.to_local().shape),
                        "plain_same": sh.constrain(
                            plain, "batch", "seq", "d_model") is plain}
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


def test_sharded_matmul_counts_its_local_flops_and_no_collective(cases):
    """[Shard(0), R] @ [R, Shard(1)]: this rank's (256, 1024) x
    (1024, 128) block product, nothing moved."""
    c = cases["matmul"]
    assert c["flops"] == c["dot_flops"] == 2 * 256 * 1024 * 128
    assert c["coll"] == {} and c["traffic"] == 0
    assert c["bytes"] == (256 * 1024 + 1024 * 128 + 256 * 128) * 4


def test_a_second_identical_op_counts_what_the_first_did(cases):
    """DTensor runs a new op once at the global shape to learn its
    output's shape; that run is not counted, so a warm cache changes
    nothing."""
    assert cases["first"] == cases["again"]
    assert cases["first"]["flops"] == 2 * 128 * 512 * 16


@pytest.mark.parametrize("placements, group", [
    ("P,R", 16), ("R,P", 16), ("P,P", 256), ("P,P,P", 512)])
def test_partial_to_replicate_is_one_all_reduce(cases, placements, group):
    """A (64, 32) float32 tensor partial over one mesh axis, or over all
    of them (reduced by DTensor one axis at a time): one all-reduce of
    the local bytes over the product group, priced by the ring model."""
    c = cases["reduce " + placements]
    nbytes = 64 * 32 * 4
    assert c["coll"] == {f"all-reduce(g={group})": nbytes}
    assert c["traffic"] == 2 * nbytes * (group - 1) / group


def test_an_op_without_a_strategy_runs_replicated_its_gather_counted(cases):
    """``searchsorted`` has no DTensor strategy: its sharded input is
    gathered over "data" (the whole 4096 float32 values) and the op is
    named in ``replicated_ops``."""
    c = cases["searchsorted"]
    assert c["replicated"] == {"searchsorted": 1}
    assert c["coll"] == {"all-gather(g=16)": 4096 * 4}


def test_a_view_that_cannot_split_its_dimension_is_gathered(cases):
    """64 columns over "model" cannot unflatten into (4, 16): the view
    runs on the tensor gathered from that dimension on."""
    c = cases["view"]
    assert c["replicated"] == {"view": 1}
    assert c["coll"] == {"all-gather(g=16)": 8 * 64 * 4}


def test_gspmd_partitioning_keeps_replicated_work_whole(cases):
    """(4096, 1024) tokens over "data" times a (1024, 2048) weight split
    over "data": both are replicated over "model", and the split
    contraction needs a collective over "data" whatever the strategy
    (held: the tokens' split moved to the contracted dim, one all-to-all
    of this rank's block, and the partial product all-reduced where it
    is made).  DTensor alone then slices the product over "model" as well (free to
    it); under ``gspmd_partitioning`` it runs whole on every rank of
    "model" — this rank's 1/16 of 2 x 4096 x 1024 x 2048 — as the
    reference's partitioner runs it.  Outside, DTensor's own choice
    stands again (its cached decisions are dropped on the way in and
    out)."""
    held, free = cases["mm held"], cases["mm free"]
    assert held["dot_flops"] == 2 * 4096 * 1024 * 2048 / 16
    assert free["dot_flops"] < held["dot_flops"]
    assert held["coll"] == {"all-to-all(g=16)": 256 * 1024 * 4,
                            "all-reduce(g=16)": 4096 * 2048 * 4}
    assert cases["mm after"] == free
    print(f"held: {held['coll']}; DTensor alone: {free['dot_flops']:.4e} "
          f"FLOPs, {free['coll']}")


def test_a_weight_is_gathered_at_use_and_its_gradient_cut_in_slabs(cases):
    """Two square (512, 512) float32 weights split over "data" along
    their FSDP dim (dim 0 of the one, dim 1 of the other) and replicated
    over "model", times (4096, 512) tokens over "data", forward and
    backward.  Each is moved to "model" (a collective-permute of its
    (32, 512) block) and gathered there (an all-gather of 1 MiB); its
    gradient is cut over "model" along its FSDP dim — the one slab
    sizes alone cannot tell — into this rank's (32, 512) or (512, 32)
    slab of the 256-token sum, all-reduced over "data" and moved back.
    Dots: the two products and the input gradient of the second at
    2 x 256 x 512 x 512 each, the two slabs at 2 x 32 x 256 x 512."""
    c = cases["fsdp"]
    assert c["dot_flops"] == 3 * 2 * 256 * 512 * 512 + 2 * 2 * 32 * 256 * 512
    block = 32 * 512 * 4
    assert c["coll"] == {"collective-permute(g=256)": 4 * block,
                         "all-gather(g=16)": 2 * 512 * 512 * 4,
                         "all-reduce(g=16)": 2 * block}
    assert c["elements"] == {k: v / 4 for k, v in c["coll"].items()}
    assert cases["fsdp grads"][:2] == [["S(0)", "R"], ["S(1)", "R"]]


def test_a_weight_split_on_every_axis_is_gathered_where_it_is_split(cases):
    """A (512, 2048) weight over ("data", "model"): no axis is free, so
    its FSDP dim is gathered over "data" (this rank's (512, 128)), its
    gradient is the plain (512, 128) product over the rank's tokens,
    all-reduced over "data" and sliced back to the stored block."""
    c = cases["fsdp no free axis"]
    assert c["dot_flops"] == 2 * 2 * 256 * 512 * 128
    assert c["coll"] == {"all-gather(g=16)": 512 * 128 * 4,
                         "all-reduce(g=16)": 512 * 128 * 4}
    assert cases["fsdp grads"][2] == ["S(0)", "S(1)"]


def test_a_split_moved_between_dims_is_one_all_to_all(cases):
    """(256, 4096, 512) float32 split over "data" on dim 2, moved to dim
    0: under ``gspmd_partitioning`` one all-to-all of this rank's
    (16, 4096, 512) block, as GSPMD emits; DTensor alone, on the dry
    run's CPU mesh, gathers the whole tensor (gloo has no all-to-all)."""
    assert cases["shard to shard"]["coll"] == {
        "all-to-all(g=16)": 16 * 4096 * 512 * 4}
    assert cases["shard to shard outside"]["coll"] == {
        "all-gather(g=16)": 256 * 4096 * 512 * 4}


def test_constrain_redistributes_a_dtensor_and_keeps_a_plain_tensor(cases):
    c = cases["constrain"]
    assert c["placements"] == ["S(0)", "R"]
    assert c["local"] == [16, 4096, 64]
    assert c["plain_same"] is True
