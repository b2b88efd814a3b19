"""The port's dry run held to the reference's partition on the second
production mesh, 2x16x16 ("pod", "data", "model"; 512 devices), on
gemma2-2b's four cells (a file of its own so that ``--dist loadfile``
gives its walks a worker).  The batch splits over "pod" x "data" (32),
the weights' FSDP dim over "data" alone.  As the reference's partition
runs the train step:

  * each weight gathered where it is stored (the FFN's, the tied
    table's for the logits) has its gradient all-reduced over "data"
    whole, sliced to its FSDP block and that block all-reduced over
    "pod" (``sharding._Gather``, ``sharding._reduced_in_stages``), where
    the port reduced the whole gathered gradient over all 32;
  * the embedding lookup takes the table to the tokens, split over
    "pod" x "data": the table's splits swapped (a collective-permute),
    its vocab gathered over "data", its gradient all-reduced over the
    32 at once (``sharding._table_for_lookup``), where
    DTensor all-to-all'd the tokens and all-reduced the masked lookup;
  * the gold logit's gradient stays split like the logits
    (``sharding.gathered_on_blocks``).

``_dryrun_check.check_cells(multi_pod=True)``: memory exact (output
within 1 KiB), the fallback text equal, dot FLOPs within 1 %, each
kind's elements within 1 %, kinds only the port issues under 0.1 % of
its elements, ``replicated_ops == {}``, the train step's temp within
2.5x of the reference's."""
from _dryrun_check import check_cells


def test_pod_serving_cells_match_the_references_partition():
    got = check_cells("gemma2-2b", ("prefill_32k", "decode_32k",
                                    "long_500k"), dot_rtol=0.01,
                      multi_pod=True)
    for s, cell in got.items():
        assert cell["mesh"] == "2x16x16" and cell["chips"] == 512, s


def test_pod_train_cell_matches_the_references_partition():
    got = check_cells("gemma2-2b", ("train_4k",), dot_rtol=0.01,
                      multi_pod=True)
    kinds = got["train_4k"]["coll_elements"]
    # the FFN's and the table's gradient blocks over "pod", the tokens
    # never moved (no all-to-all)
    assert kinds["all-reduce(g=2)"] > 0
    assert not any(k.startswith("all-to-all") for k in kinds), kinds
