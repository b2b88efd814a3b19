"""The port's dry run of deepseek-v3-671b ``train_4k`` held to the
reference's partition on the 2x16x16 mesh ("pod", "data", "model"; 512
devices), the chunked MoE on a batch split over "pod" x "data" (a file
of its own so that ``--dist loadfile`` gives its walk a worker).  A
chunk's 16 rows split over "data" alone, so "pod" is free inside the
chunk loop; the reference's partition uses it as these rules do
(``parallel/sharding.py``):

  * the router contracted over "pod" x "model" (``_contract_split``
    with ``_free_for``'s group): its split moved there in halves, its
    logits all-reduced over the 32, the weight gathered over the 32 for
    the rows' gradient, where the port contracted over "model" on both
    pods (all-reduce(g=32) read 0.17 of the reference's, the router's
    dot FLOPs 2x);
  * the loop's output gradient taken back whole into the chunks
    (``_RowsRegrouped``'s backward, ``_into_chunks``: an all-gather
    over pairs of "data" ranks, a collective-permute), where it came
    back partial over "pod" and was all-reduced there (all-reduce(g=2)
    read 33.8x); the regroup left out of the block's recompute, whose
    result no gradient reads;
  * the MoE input's gradient left in the chunk loop's layout
    (``_RowsInChunks``' backward), the shared expert's input gradient
    made there on 16 rows a rank (``grad_in_chunks``,
    ``product_into_chunks``), the norm's statistic and gradients moved
    between that layout and the rows' own (``rows_regrouped_pointwise``);
  * XLA's involuntary full rematerialization for the norm's scale
    gradient (``involuntary_full_remat``): its normalized input and
    its output's gradient gathered whole, f32[256,4096,7168] over "pod"
    x "data" and over "data" a layer (all-gather(g=32) read 0 of
    436,045,611,008 elements).

``_dryrun_check.check_cells(multi_pod=True)``: memory exact (output
within 1 KiB), the fallback text equal, dot FLOPs within 1 %, each
kind's elements within 1 %, kinds only the port issues under 0.1 % of
its elements, ``replicated_ops == {}``, the train step's temp within
2.5x of the reference's; and here (``check_kinds_held``) no op run
replicated, and the kinds the rules moved, and the dispatch's
all-to-alls, within 0.1 %."""
from _dryrun_check import check_kinds_held

# the kinds the rules above moved, and the dispatch's all-to-alls
KINDS = ("all-gather(g=16)", "all-gather(g=2)", "all-gather(g=32)",
         "all-reduce(g=16)", "all-reduce(g=2)", "all-reduce(g=32)",
         "all-to-all(g=16)", "collective-permute(g=512)")


def test_pod_deepseek_v3_train_places_the_chunked_moe():
    check_kinds_held("deepseek-v3-671b", "train_4k", KINDS)
