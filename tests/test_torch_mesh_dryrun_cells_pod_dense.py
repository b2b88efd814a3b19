"""The port's dry run held to the reference's partition on the 2x16x16
mesh ("pod", "data", "model"; 512 devices) on the dense cells the
three rules below repaired (a file of its own so that ``--dist loadfile``
gives its walks a worker):

  * a norm's parameter gradient (``rms_norm``'s (1 + scale),
    ``layer_norm``'s scale and bias), the sum over the tokens, is
    all-reduced once in the backward, over "pod" x "data" at once
    (``sharding.reduced_product``), where it was left partial and
    reduced at each of its reads in the optimizer: all-reduce(g=32)
    read 1.0178 (whisper-base) and 1.0229 (gemma2-27b) of the
    reference's;
  * the long-context decode (batch one, "pod" and "data" free) gathers
    each layer's queries by way of both free axes: regrouped over
    "model", moved to the 32 ranks of "pod" x "data" (three
    collective-permutes) and all-reduced over the 32
    (``sharding._whole_by_free_dims``), where it moved them to "data"
    and all-gathered them there: all-reduce(g=32) read 0 of the
    reference's, all-gather(g=16) 2 (gemma2-27b) and 1,537
    (recurrentgemma-9b), collective-permutes 0.50 and 0.76;
  * the prefill's attention mask and rotary angles are built from
    positions split like the rows they meet
    (``sharding.rows_split_as``), where whole positions made the mask
    at the global batch on every rank: recurrentgemma-9b x prefill_32k's
    temp read 9.7444x the reference's, held here within 1.5x.

``_dryrun_check.check_cells(multi_pod=True)``: memory exact (output
within 1 KiB), the fallback text equal, dot FLOPs within 1 %, each
kind's elements within 1 %, kinds only the port issues under 0.1 % of
its elements, ``replicated_ops == {}``, a train step's temp within
2.5x of the reference's; and here the kinds each fault moved within
0.1 % (gemma3-4b's and gemma2-2b's excess, 0.97 % and 0.80 %, hid under
1 %)."""
from _dryrun_check import check_cells

RTOL = 1e-3


def _close(cell, *kinds):
    """Each of ``kinds``'s elements within ``RTOL`` of the reference's."""
    ref = cell["reference_coll_elements"]
    for kind in kinds:
        got = cell["coll_elements"].get(kind, 0)
        assert abs(got / ref[kind] - 1) <= RTOL, (kind, got, ref[kind])


def test_pod_whisper_train_reduces_each_norm_gradient_once():
    got = check_cells("whisper-base", ("train_4k",), dot_rtol=0.01,
                      multi_pod=True)
    _close(got["train_4k"], "all-reduce(g=32)")


def test_pod_gemma2_27b_train_and_long_context_decode():
    got = check_cells("gemma2-27b", ("train_4k", "long_500k"),
                      dot_rtol=0.01, multi_pod=True)
    _close(got["train_4k"], "all-reduce(g=32)")
    _close(got["long_500k"], "all-reduce(g=32)", "all-gather(g=16)",
           "collective-permute(g=512)")


def test_pod_recurrentgemma_long_context_decode():
    got = check_cells("recurrentgemma-9b", ("long_500k", "prefill_32k"),
                      dot_rtol=0.01, multi_pod=True)
    _close(got["long_500k"], "all-reduce(g=32)", "all-gather(g=16)",
           "collective-permute(g=512)")
    # the prefill's attention mask on the rank's own row (one of the 32
    # rows of "pod" x "data"), not on all 32: 9.7444x the reference's
    # temp before, three (32, 32768, 32768) bool blocks at its peak
    prefill = got["prefill_32k"]
    temp = prefill["memory"]["temp_bytes"]
    assert temp <= 1.5 * prefill["reference_memory"]["temp_bytes"], temp
