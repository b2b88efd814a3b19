"""The port's dry run of deepseek-v2-236b ``train_4k`` held to the
reference's partition on the 2x16x16 mesh ("pod", "data", "model"; 512
devices), by the rules that hold deepseek-v3-671b's
(``test_torch_mesh_dryrun_cells_pod_moe_train.py``): the router
contracted over "pod" x "model", the chunk loop's output gradient
taken back whole into the chunks, the MoE input's gradient and the two
shared experts' made in the chunk loop's layout, and XLA's involuntary
full rematerialization of the norm's input and gradient for its scale's
gradient (f32[256,4096,5120] a layer).  A file of its own so that
``--dist loadfile`` gives its walk a worker.

Held: ``check_cells(multi_pod=True)`` (memory exact, fallbacks equal,
each kind within 1 %, ``replicated_ops == {}``, temp within 2.5x), dot
FLOPs within 1 %, and the kinds the rules moved within 0.1 % of the
reference's."""
from _dryrun_check import check_kinds_held

KINDS = ("all-gather(g=16)", "all-gather(g=2)", "all-gather(g=32)",
         "all-reduce(g=16)", "all-reduce(g=2)", "all-reduce(g=32)",
         "all-to-all(g=16)", "collective-permute(g=512)")


def test_pod_deepseek_v2_train_takes_the_references_partition():
    check_kinds_held("deepseek-v2-236b", "train_4k", KINDS)
