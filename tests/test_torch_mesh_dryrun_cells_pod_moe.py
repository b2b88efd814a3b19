"""The port's dry run held to the reference's partition on the 2x16x16
mesh ("pod", "data", "model"; 512 devices) on deepseek-v3-671b's
decode and prefill, the MoE on a batch split over "pod" x "data" (a
file of its own so that ``--dist loadfile`` gives its walks a worker):

  * the chunked MoE (``prefill_32k``, 256 rows of 4,096 tokens in 16
    chunks of 16 rows): its rows taken into chunks as the reference's
    scan reads them, each chunk's rows over "data" and the chunks
    whole (``sharding.rows_in_chunks``: a collective-permute of each
    rank's 8 rows, an all-gather of the 16 chunks over "pod"), and its
    output laid out as the batch by one collective-permute
    (``sharding.rows_laid_out_as``), where the views before the chunk
    loop ran replicated (58 a step), the whole activation was gathered
    over "pod" (all-gather(g=2) 16x the reference's) and no
    collective-permute was issued;
  * the flat MoE (``decode_32k``, 128 tokens): the top-k's scores and
    the dispatch's expert ids gathered over the 32 ranks of "pod" x
    "data" in one all-gather each, the tokens joined with the zero row
    by all-to-alls over the 32, gathered into the experts' buckets by
    an all-reduce over "pod" x "model", combined on blocks over "pod" x
    "model" and cut to the tokens by XLA's collective-permutes, where
    the port gathered in two stages (all-gather(g=16), then g=2) and
    issued no all-to-all(g=32).

``_dryrun_check.check_cells(multi_pod=True)``: memory exact (output
within 1 KiB), the fallback text equal, dot FLOPs within 1 %, each
kind's elements within 1 %, kinds only the port issues under 0.1 % of
its elements, ``replicated_ops == {}``; and here the kinds these rules
moved within 0.1 %.  Two gaps stay, each named: the prefill's
collective-permutes carry 4,096 rows of each chunk where the
reference's carry 4,097 (it moves the combined rows before cutting off
the bucket's sentinel row: 0.9998 of its elements), and the decode's
all-to-all(g=32) lacks the reference's one f32[1,1,224] all-to-all of
the zero row, which XLA hoists out of its layer loop (7,168
elements)."""
from _dryrun_check import check_cells

RTOL = 1e-3
ZERO_ROW = 32 * 224     # the reference's hoisted all-to-all of the zero row


def _close(cell, *kinds):
    """Each of ``kinds``'s elements within ``RTOL`` of the reference's."""
    ref = cell["reference_coll_elements"]
    for kind in kinds:
        got = cell["coll_elements"].get(kind, 0)
        assert abs(got / ref[kind] - 1) <= RTOL, (kind, got, ref[kind])


def test_pod_deepseek_v3_decode_and_prefill():
    got = check_cells("deepseek-v3-671b", ("decode_32k", "prefill_32k"),
                      dot_rtol=0.01, multi_pod=True)
    decode, prefill = got["decode_32k"], got["prefill_32k"]
    _close(decode, "all-gather(g=32)", "all-reduce(g=32)",
           "collective-permute(g=512)")
    assert "all-gather(g=2)" not in decode["coll_elements"]
    assert decode["coll_elements"]["all-to-all(g=32)"] == \
        decode["reference_coll_elements"]["all-to-all(g=32)"] - ZERO_ROW
    _close(prefill, "all-gather(g=2)", "all-to-all(g=16)",
           "collective-permute(g=512)")
