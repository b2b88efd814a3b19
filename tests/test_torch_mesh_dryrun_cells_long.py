"""The port's dry run held to the reference's partition on the
long-context decode of the archs whose query heads split over "model"
while the cache's sequence takes "model" too (``long_500k``: batch 1,
``cache_seq`` on "model"): gemma2-27b (32 heads, 16 KV heads) and
recurrentgemma-9b (16 heads, one KV head; its RG-LRU layers' gates
beside).  As the reference's partition runs them (its HLO): the
queries' split moved to the free "data" (a collective-permute of each
rank's f32[1,1,1,2,128]) and gathered there for the scores
(``sharding._whole_over_free``); the value product and the RG-LRU
gates run with their output split over "data", their partial sums
over "model" all-reduced a block at a time and the split moved back to
"model" (a collective-permute, ``sharding.product_as``); the new key
and value gathered whole for the cache's write (``sharding.set_slot``).
Each arch in one test (``_dryrun_check.check_cells``: memory exact, the
fallback text equal, dot FLOPs within 1 %, each kind's elements within
1 %, ``replicated_ops == {}``)."""
import pytest

from _dryrun_check import check_cells


@pytest.mark.parametrize("arch", ["gemma2-27b", "recurrentgemma-9b"])
def test_long_context_decode_matches_the_references_partition(arch):
    got = check_cells(arch, ("long_500k",), dot_rtol=0.01)
    assert got["long_500k"]["coll_elements"]["collective-permute(g=256)"] > 0
