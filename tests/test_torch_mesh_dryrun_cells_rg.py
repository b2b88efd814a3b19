"""The port's dry run held to the reference's partition on
recurrentgemma-9b x train_4k (a file of its own so that ``--dist
loadfile`` gives its walk a worker).  As the reference's partition runs
the RG-LRU gates' backward: the gradient of each gate's output, split
over "model" as its users leave it, is gathered whole over "model" for
each of the two transposed products (``sharding.product_as``: two
f32[16,4096,4096] all-gathers a gate a layer, where the port reduced an
activation and a weight over all 256 ranks), and the update of
``b_a``, ``b_i`` and ``lam``, whose gradients come out split over
"model", leaves the step split (``sharding._take_split``: XLA's output
takes the update's split, so the parameter and its moments are not
aliased).  ``_dryrun_check.check_cells``: memory exact, the fallback
text equal, dot FLOPs within 1 %, each kind's elements within 1 %,
``replicated_ops == {}``."""
from _dryrun_check import check_cells


def test_recurrentgemma_train_cell_matches_the_references_partition():
    got = check_cells("recurrentgemma-9b", ("train_4k",), dot_rtol=0.01)
    kinds = got["train_4k"]["coll_elements"]
    assert kinds["all-gather(g=16)"] > 0
    # over all 256 ranks the optimizer's scalars alone (31 elements),
    # no gradient (8.7e8 elements before)
    assert kinds.get("all-reduce(g=256)", 0) < 1e3
