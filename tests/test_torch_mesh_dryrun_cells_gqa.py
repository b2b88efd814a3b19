"""The port's dry run held to the reference's partition on the GQA cells:
granite-3-2b (32 heads, 8 KV heads) x train_4k, prefill_32k and
decode_32k here, qwen2-vl-72b (64 heads, 8 KV heads) x train_4k and
decode_32k in ``test_torch_mesh_dryrun_cells_qwen.py``. Their queries
are viewed as (KV, group): GSPMD keeps the heads' 16-way split through
that view by cutting "model" into 8 x 2 sub-axes (KV over 8, the group
over 2), and the reference's partition issues all-gathers over the 8
and all-reduces over the 2 (the keys' and values' gradients). The port
walks such a cell again on a mesh with "model" cut so
(``launch.mesh.factor_axis``, from the view's shapes), and counts a
collective DTensor issues over each factor in turn as the one over the
whole axis. The test runs the reference's and the port's cells of the
arch in a subprocess each, at once (``_dryrun_check.check_cells``).
Also here: the collective counting on a factored mesh."""
from _dryrun_check import check_gqa_cells, result, start


def test_granite_cells_match_the_references_partition():
    check_gqa_cells("granite-3-2b", ("train_4k", "prefill_32k",
                                     "decode_32k"))


_FACTORED = r"""
import json
import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from repro_torch.launch import cost_analysis as ca
from repro_torch.launch import mesh as m
from repro_torch.parallel import sharding as sh
mesh = m.factor_axis(m.make_production_mesh(), "model", (8, 2))
R, S0 = Replicate(), Shard(0)

def moved(src, dst):
    pl = placements(src)
    n = 64
    for k, q in enumerate(pl):
        n //= mesh.size(k) if q.is_shard() else 1

    def run():
        x = DTensor.from_local(torch.empty((n, 32), device="meta"), mesh,
                               pl, run_check=False,
                               shape=torch.Size((64, 32)), stride=(32, 1))
        x.redistribute(mesh, placements(dst))
    return ca.count_step(run).coll_elements

def placements(p):
    return {"model": [R, S0, S0], "major": [R, S0, R], "none": [R, R, R],
            "partial": [R, Partial(), Partial()],
            "data": [S0, R, R]}[p]

print("RESULT " + json.dumps({
    "logical": {a: list(d) for a, d in sh.mesh_axes(mesh).items()},
    "placements": [q.dim for q in sh.NamedSharding(
        mesh, sh.PartitionSpec("data", "model")).placements()],
    "gather_model": moved("model", "none"),
    "gather_major": moved("major", "none"),
    "reduce_model": moved("partial", "none"),
    "scatter_model": moved("partial", "model"),
    "gather_data": moved("data", "none")}))
"""


def test_a_collective_over_the_factors_counts_once_over_the_axis():
    """On "model" cut into 8 x 2: a spec naming "model" is placed on
    both factors; DTensor gathers a (64, 32) block split over both in
    two all-gathers (over the 2, then the 8), counted as one
    all-gather(g=16) of the whole result's 2048 elements; one split over
    the major factor alone is an all-gather(g=8); a sum partial over
    both factors is one all-reduce(g=16) and, scattered, one
    reduce-scatter(g=16) of the 128 elements each rank keeps; the data
    axis is untouched."""
    r = result(start(_FACTORED), timeout=200)
    assert r["logical"] == {"data": [0], "model": [1, 2]}
    assert r["placements"] == [0, 1, 1]      # Shard(dim) of each mesh dim
    assert r["gather_model"] == {"all-gather(g=16)": 2048}
    assert r["gather_major"] == {"all-gather(g=8)": 2048}
    assert r["reduce_model"] == {"all-reduce(g=16)": 2048}
    assert r["scatter_model"] == {"reduce-scatter(g=16)": 128}
    assert r["gather_data"] == {"all-gather(g=16)": 2048}
