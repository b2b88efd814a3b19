"""The port's dry run held to the reference's partition on xlstm-125m's
four cells (a file of its own so that ``--dist loadfile`` gives its
walks a worker).  As the reference's partition runs the xLSTM blocks
(its HLO): the residual carried split over "model" (``ssm.carried``);
the ``up`` projection's halves and the sLSTM's four gate
pre-activations cut by collective-permutes that keep each part split
(``sharding.split_kept``, their gradients joined by all-to-alls:
``cat_kept``); q, k and the gates reduced over the first factor of
"model" cut 4 x 4 by the heads, the head sliced, then over the second,
v over all 16 (``sharding.reduced_by_heads``); the recurrences on the
split state; on the batch-of-one decode, the free "data" taking the
products' blocks.  ``_dryrun_check.check_cells``: memory exact, the
fallback text equal, dot FLOPs within 1 %, each kind's elements within
1 %, ``replicated_ops == {}``."""
from _dryrun_check import check_cells


def test_xlstm_cells_match_the_references_partition():
    shapes = ("train_4k", "prefill_32k", "decode_32k", "long_500k")
    got = check_cells("xlstm-125m", shapes, dot_rtol=0.01)
    for s in shapes:
        kinds = got[s]["coll_elements"]
        # the heads' cut and the split-keeping permutes, which the port
        # lacked (all-reduces over 64 and all 16 ranks instead)
        assert kinds["all-reduce(g=4)"] > 0, (s, kinds)
        assert kinds["collective-permute(g=256)"] > 0, (s, kinds)
        assert "all-reduce(g=64)" not in kinds, (s, kinds)
