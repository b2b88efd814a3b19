"""The port's dry run held to the reference's partition on the cells
``test_torch_mesh_dryrun.py`` does not pin, part one: the serving
cells, whose memory is XLA's for a step that does not read every
argument (prefill overwrites its donated cache whole, so XLA drops it
and aliases nothing; a decode step never reads the encoder's weights),
gemma2-27b x train_4k, whose token ids are permuted to "model" and
gathered there for the lookup (the reference's one collective-permute
of that cell), and the cells that matched already (gemma3-4b x
train_4k, gemma2-2b and recurrentgemma-9b x decode_32k). Each test
runs the reference's and the port's cells of one arch in a subprocess
each, at once (``_dryrun_check.check_cells``: argument and alias bytes
exact, output within 1 KiB, the fallback text equal, dot FLOPs within
10 %, each kind of collective's elements within 1 %, kinds only the
port issues under 0.1 % of its elements, ``replicated_ops == {}``).
The deepseek serving cells are held so with dot FLOPs within 1 %: their
MoE takes the reference's flat (decode) or chunked (prefill) branch on
the DTensor token stream, partitioned as GSPMD partitions it
(deepseek-v2-236b x train_4k in ``test_torch_mesh_dryrun_cells_moe.py``).
Also here: the dead-argument rule on a toy step."""
import pytest
import torch

from repro_torch.launch import cost_analysis as ca
from repro_torch.launch.dryrun import step_memory

from _dryrun_check import check_cells


@pytest.mark.parametrize("arch,shapes", [
    ("gemma2-2b", ("prefill_32k", "decode_32k")),
    ("gemma3-4b", ("train_4k", "prefill_32k")),
    ("whisper-base", ("prefill_32k", "decode_32k")),
    ("gemma2-27b", ("train_4k",)),
    ("recurrentgemma-9b", ("decode_32k",)),
])
def test_cells_match_the_references_partition(arch, shapes):
    got = check_cells(arch, shapes)
    for s in shapes:
        by_tree = got[s]["memory"]["argument_bytes_by_tree"]
        if s == "prefill_32k":        # the cache, overwritten whole
            assert by_tree["cache"] == 0 == got[s]["memory"]["alias_bytes"]


@pytest.mark.parametrize("arch", ["deepseek-v2-236b", "deepseek-v3-671b"])
def test_deepseek_cells_memory_is_the_references(arch):
    """The serving cells' partition, not their memory alone: the decode's
    all-to-alls (the tokens' split moved off the rows the zero row makes
    uneven, and back) and collective-permutes (the rows moved off
    "data" for the bucket gather, the combined rows back and re-cut to
    the tokens' blocks), the prefill's all-gather of the router's
    scores for its top-k."""
    got = check_cells(arch, ("prefill_32k", "decode_32k"), dot_rtol=0.01)
    decode = got["decode_32k"]["coll_elements"]
    assert decode["collective-permute(g=256)"] > 0
    assert decode["all-to-all(g=16)"] > 0
    assert got["prefill_32k"]["coll_elements"]["all-gather(g=16)"] > 0


def test_a_buffer_overwritten_whole_is_neither_argument_nor_alias():
    """A step that writes a donated buffer whole never reads it: XLA
    drops it from the arguments and aliases nothing to it.  One written
    in part keeps the rest (a dynamic-update-slice reads its operand),
    one only read is an argument; each donated leaf read is aliased to
    an output of its shape and dtype, each output once."""
    whole, part, read = (torch.empty((4, 8), device="meta")
                         for _ in range(3))
    other = torch.empty((4, 8), device="meta", dtype=torch.bfloat16)
    out = []

    def step():
        whole.copy_(torch.zeros((4, 8), device="meta"))
        part.narrow(0, 1, 1).copy_(torch.ones((1, 8), device="meta"))
        out.extend([whole, part, read * 2, other + 1])

    cost = ca.count_step(step, watch=[whole, part, read, other])
    assert [cost.read_of(t) for t in (whole, part, read, other)] \
        == [False, True, True, True]
    by_tree, memory = step_memory(
        {"cache": [whole, part], "inputs": [read, other]},
        [whole, part, read, other], out, cost.read_of)
    assert by_tree == {"cache": 128, "inputs": 128 + 64}
    # four f32 (4, 8) outputs and one bf16: part and read are aliased
    # (read and donated), other too (its own bf16 output); whole is not
    assert memory == {"output_bytes": 3 * 128 + 64, "alias_bytes":
                      2 * 128 + 64}
