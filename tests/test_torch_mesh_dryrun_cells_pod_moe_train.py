"""The port's dry run of deepseek-v3-671b ``train_4k`` on the 2x16x16
mesh ("pod", "data", "model"; 512 devices), the chunked MoE on a batch
split over "pod" x "data" (a file of its own so that ``--dist
loadfile`` gives its ~65 s walk a worker).  The forward's chunked MoE
takes the reference's partition (``sharding.rows_in_chunks`` and
``rows_laid_out_as``, as on ``prefill_32k``): its views before the
chunk loop no longer run replicated (116 a step), and the dispatch's
all-to-alls are the reference's (1.33x before).

The cell as a whole still differs from the reference's partition, so
it is held here by what this partition fixes, not by ``check_cells``'s
every kind (ROADMAP queue 3, PERF.md §6): the reference routes each
chunk over "pod" x "model" (all-reduce(g=32) of the logits, where the
port reduces over "model" on both pods), assembles the MoE input's
gradient in the chunk loop's layout, and gathers each MoE layer's
normalized input and its gradient whole (all-gather(g=32) and g=16 of
f32[256,4096,7168], XLA's "involuntary full rematerialization") for
the norm's scale gradient.

Held: memory exact (``check_cells(memory_only=True)``: argument and
alias bytes, output within 1 KiB, temp within 2.5x of the
reference's), ``replicated_ops == {}``, dot FLOPs within 1 %, and the
all-to-all(g=16) elements within 0.1 % of the reference's."""
from _dryrun_check import check_cells

RTOL = 1e-3


def test_pod_deepseek_v3_train_places_the_chunked_moe():
    cell = check_cells("deepseek-v3-671b", ("train_4k",), memory_only=True,
                       multi_pod=True)["train_4k"]
    assert cell["replicated_ops"] == {}, cell["replicated_ops"]
    dot = cell["dot_flops_per_device"] / cell["reference_dot_flops"]
    assert abs(dot - 1) <= 0.01, dot
    got = cell["coll_elements"]["all-to-all(g=16)"]
    want = cell["reference_coll_elements"]["all-to-all(g=16)"]
    assert abs(got / want - 1) <= RTOL, (got, want)
