"""The port's dry run held to the reference's partition on the 2x16x16
mesh ("pod", "data", "model"; 512 devices) on xlstm-125m's long-context
decode and training step (a file of its own so that ``--dist loadfile``
gives its walks a worker), the cells the rules below repaired:

  * with a batch of one, "pod" x "data" (32 ranks) free and outranking
    "model" (16): an up projection's input, the residual split over
    "model" (48 columns a rank), moved to the 32 in halves (24 a rank)
    and contracted there, its partial sums all-reduced over the 32; the
    unembedding's input gathered over them; the sLSTM state gathered
    over them (``sharding._free_for``, ``_move_split``,
    ``_gathered_on_free``), where each moved to "data" alone and
    reduced or gathered over its 16: all-reduce(g=32) read 0 of the
    reference's 3,072 elements, all-gather(g=32) 0 of 1,920;
  * the training step's lookup, tokens over "pod" x "data": the table's
    splits swapped, its vocab gathered over "data", its gradient
    all-reduced over the 32 at once in the backward
    (``_table_for_lookup``), where DTensor's own lookup all-to-all'd the
    embedding and left the gradient partial over "pod" for the
    optimizer to reduce at each read: all-reduce(g=2) read 4.08 of the
    reference's;
  * each up projection's weight gradient reduced over "data", sliced,
    then over "pod" (``_reduced_in_stages`` of ``_RegatheredInput``'s
    product), where it was reduced over the 32 at once;
  * the sLSTM step's four gate gradients gathered whole over "model"
    where their 8 rows a rank cannot split 16 ways (``cat_kept``),
    where they were all-to-all'd: all-gather(g=16) read 0.79 and
    all-to-all(g=16) 1.85 of the reference's.

``_dryrun_check.check_cells(multi_pod=True)``: memory exact (output
within 1 KiB), the fallback text equal, dot FLOPs within 1 %, each
kind's elements within 1 %, kinds only the port issues under 0.1 % of
its elements, ``replicated_ops == {}``, the train step's temp within
2.5x of the reference's; and here the kinds each fault moved within
0.1 %."""
from _dryrun_check import check_cells

RTOL = 1e-3


def _close(cell, *kinds):
    """Each of ``kinds``'s elements within ``RTOL`` of the reference's."""
    ref = cell["reference_coll_elements"]
    for kind in kinds:
        got = cell["coll_elements"].get(kind, 0)
        assert abs(got / ref[kind] - 1) <= RTOL, (kind, got, ref[kind])


def test_pod_xlstm_train_and_long_context_decode():
    got = check_cells("xlstm-125m", ("train_4k", "long_500k"),
                      dot_rtol=0.01, multi_pod=True)
    _close(got["long_500k"], "all-reduce(g=32)", "all-gather(g=32)",
           "all-gather(g=16)")
    _close(got["train_4k"], "all-gather(g=16)", "all-reduce(g=2)",
           "all-to-all(g=16)")
