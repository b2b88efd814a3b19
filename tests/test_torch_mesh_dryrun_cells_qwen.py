"""The port's dry run held to the reference's partition on qwen2-vl-72b
(64 heads, 8 KV heads) x train_4k and decode_32k: its queries viewed as
(KV, group) keep the heads' split over "model" cut into 8 x 2, as on
granite-3-2b (``test_torch_mesh_dryrun_cells_gqa.py``; a file of its
own so that ``--dist loadfile`` runs it on a worker of its own)."""
from _dryrun_check import check_gqa_cells


def test_qwen2_vl_cells_match_the_references_partition():
    check_gqa_cells("qwen2-vl-72b", ("train_4k", "decode_32k"))
