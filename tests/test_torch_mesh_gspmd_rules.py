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
    rank writes it;
  * ``split_kept`` and ``cat_kept``: a chunk of a dim split over
    "model" keeps each part split, its blocks fetched by
    collective-permutes as XLA groups them, the parts' gradients joined
    by all-to-alls;
  * ``gspmd_fallback``'s pad: along dims no mesh dim splits on the
    blocks, along a split dim gathered first;
  * on "model" cut 4 x 4 (``launch.mesh.factor_axis``):
    ``reduced_by_heads`` reduces a product's partial sums over the
    heads' factor, slices the head, then over the other factor (or over
    both at once, then slices), and asks an uncut mesh for the cut;
    ``_take_split`` leaves an update split over both factors.

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
    # an xLSTM block's up projection, split 16 ways over "model", cut
    # into its halves (the mLSTM) and its four gates (the sLSTM)
    up = dt((128, 1, 3072), [S(0), S(2)], grad=True)
    res = {}
    out["halves"] = cost(lambda: res.setdefault("y", torch.chunk(up, 2, -1)))
    out["halves"].update(where(res["y"][1]))
    out["quarters"] = cost(lambda: torch.chunk(up, 4, -1))
    # ... and the halves' gradients joined again
    g = dt((128, 1, 1536), [S(0), S(2)])
    out["joined"] = cost(lambda: (res["y"][0] * res["y"][1]).backward(g))
    out["joined"].update(where(up.grad))
    # a causal conv's pad along the unsplit sequence, and a pad along the
    # split dim
    x = dt((16, 4096, 64), [S(0), S(2)])
    res = {}
    out["pad seq"] = cost(lambda: res.setdefault("y", torch.nn.functional.pad(
        x, (0, 0, 3, 0))))
    out["pad seq"].update(where(res["y"]))
    res = {}
    out["pad split"] = cost(lambda: res.setdefault(
        "y", torch.nn.functional.pad(x, (1, 1))))
    out["pad split"].update(where(res["y"]))
    # q's partial sums on "model" uncut: the walk asks for the heads' cut
    xc = dt((128, 1, 1536), [S(0), S(2)])
    wq = dt((1536, 1536), [R, S(0)])
    c = ca.count_step(lambda: sh.reduced_by_heads(torch.matmul, xc, wq,
                                                  heads=4, whole=True))
    out["cut"] = list(c.axis_cut)

# "model" cut 4 x 4 by the heads
cut = m.factor_axis(mesh, "model", (4, 4))
mesh = cut


def dtc(shape, placements, grad=False):
    local = list(shape)
    for i, p in enumerate(placements):
        if p.is_shard():
            local[p.dim] //= cut.size(i)
    stride = torch.empty(shape, device="meta").stride()
    t = DTensor.from_local(torch.empty(local, device="meta"), cut,
                           placements, run_check=False,
                           shape=torch.Size(shape), stride=stride)
    return t.detach().requires_grad_(grad)


with sh.gspmd_partitioning():
    xc = dtc((128, 1, 1536), [S(0), S(2), S(2)])
    wq = dtc((1536, 1536), [R, S(0), S(0)])
    for whole in (True, False):
        res = {}
        key = f"heads whole={whole}"
        out[key] = cost(lambda: res.setdefault("y", sh.reduced_by_heads(
            torch.matmul, xc, wq, heads=4, whole=whole)))
        out[key].update(where(res["y"]))
    p = dtc((4096,), [R, R, R])
    gp = dtc((4096,), [R, S(0), S(0)])
    with torch.no_grad():
        out["update cut"] = cost(lambda: p.add_(gp))
    out["update cut"].update(where(p))
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


def test_a_chunk_of_a_split_dim_keeps_each_part_split(cases):
    """(128, 1, 3072) split 16 ways (this rank's 8 x 192): its halves
    keep the split (8 x 96 a rank), each rank's block fetched by XLA's
    four collective-permutes (192 + 3 x 96 wide, the reference's
    f32[8,1,192] and f32[8,1,96] of xlstm-125m decode_32k); its quarters
    by sixteen (ten 48 and six 96 wide)."""
    h = cases["halves"]
    assert h["elements"] == {"collective-permute(g=256)": 8 * (192 + 3 * 96)}
    assert h["placements"] == ["S(0)", "S(2)"] and h["local"] == [8, 1, 96]
    assert cases["quarters"]["elements"] == {
        "collective-permute(g=256)": 8 * (10 * 48 + 6 * 96)}


def test_the_halves_gradients_are_joined_by_all_to_alls(cases):
    """Each half's (8, 1, 96) gradient block and the joined (8, 1, 192)
    go through an all-to-all over "model" (the reference's transposed
    concatenation), and the gradient keeps the split."""
    j = cases["joined"]
    assert j["elements"] == {"all-to-all(g=16)": 8 * (96 + 96 + 192)}
    assert j["placements"] == ["S(0)", "S(2)"]


def test_a_pad_runs_on_the_blocks_along_unsplit_dims(cases):
    """The causal conv's pad of the sequence (unsplit) moves nothing and
    keeps the placements; a pad along the split dim gathers it first."""
    assert cases["pad seq"]["elements"] == {}
    assert cases["pad seq"]["placements"] == ["S(0)", "S(2)"]
    assert cases["pad seq"]["local"] == [1, 4099, 4]
    p = cases["pad split"]
    assert p["elements"] == {"all-gather(g=16)": 4096 * 64}
    assert p["placements"] == ["S(0)", "R"] and p["local"] == [1, 4096, 66]


def test_partial_sums_follow_the_heads_cut(cases):
    """q = xc @ wq, xc's 1536 split 16 ways over "model" cut 4 x 4: its
    (8, 1, 1536) partial sums all-reduced over the first factor, the
    head sliced, its (8, 1, 384) over the second (the reference's q and
    k); with the head dim split too, over all 16 at once, then sliced
    (its v).  On "model" uncut, the walk asks for the 4 x 4 cut."""
    q = cases["heads whole=True"]
    assert q["elements"] == {"all-reduce(g=4)": 8 * 1536 + 8 * 384}
    assert q["placements"] == ["S(0)", "S(2)", "R"]
    assert q["local"] == [8, 1, 384]
    assert q["dot_flops"] == 2 * 8 * 96 * 1536
    v = cases["heads whole=False"]
    assert v["elements"] == {"all-reduce(g=16)": 8 * 1536}
    assert v["placements"] == ["S(0)", "S(2)", "S(2)"]
    assert v["local"] == [8, 1, 96]
    assert cases["cut"] == ["model", [4, 4]]


def test_an_update_takes_its_operands_split_on_a_cut_mesh(cases):
    """On "model" cut 4 x 4, a whole (4096,) parameter plus a gradient
    split over both factors leaves the update split (this rank's 256)."""
    c = cases["update cut"]
    assert c["elements"] == {}
    assert c["placements"] == ["R", "S(0)", "S(0)"] and c["local"] == [256]
