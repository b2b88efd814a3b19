"""The port's dry run (``repro_torch.launch.dryrun``, ``launch.mesh``,
``launch.cost_analysis``) against the reference's, on the CPU, and the
repairs that let the model's steps run on ``meta`` tensors.

A dry-run world is a process group (the ``fake`` backend), so every run
of ``make_production_mesh`` here happens in a subprocess of its own:
under ``--dist loadfile`` a group made in the pytest worker would leak
into the next test file on that worker.  The reference runs in a
subprocess too, with its production mesh rebuilt with Auto axes (JAX
0.9 makes Explicit axes, where its own ``tests/test_dryrun.py`` fails);
nothing in ``src/repro`` changes for that.

What must hold:
  * on gemma2-2b x train_4k and x long_500k, and whisper-base x train_4k
    (16x16 mesh, full config), the port's per-device ``argument_bytes``
    and ``alias_bytes`` equal the reference's compiled
    ``memory_analysis`` exactly, its ``output_bytes`` within 1 KiB
    (XLA's remainder: the output tuple's table, 8 bytes a leaf), and the
    fallback text is the reference's;
  * the port's DTensor walk of one rank's share of the step against one
    SPMD partition of the reference's compiled HLO: dot FLOPs within
    10 % (the reference's, from its HLO with its own ``parse_module``,
    ``_dot_flops`` and ``_trip_count``), collective traffic within a
    factor 2, each kind of collective's elements within 1 % (the
    reference's read from the same HLO), a positive ``collective_s``
    and a bottleneck over three terms; total FLOPs and bytes printed
    with their ratios;
  * the ep_sm MoE's own collectives are counted once, by kind and group,
    beside the all-reduces DTensor issues; every collective is priced by
    the reference's ring-traffic model, copied unchanged;
  * a scan step counted by ``count_as`` costs what its loop costs; with
    ``BY_SOURCE`` the dot FLOPs split by the code that ran them;
  * ``route``'s counts are ``torch.bincount``'s, bit for bit;
    ``resolve_device`` takes ``"meta"`` only when asked.
"""
import numpy as np
import pytest
import torch

from repro.launch import hlo_analysis as jhlo
from repro_torch.configs import get_smoke_config
from repro_torch.device import resolve_device
from repro_torch.launch import cost_analysis as ca
from repro_torch.models import moe
from repro_torch.models import params as P

from _dryrun_check import check_cells as _check_cells
from _dryrun_check import result as _result
from _dryrun_check import start as _start

CELLS = ("train_4k", "long_500k")

_WORLD = r"""
import json
import torch.distributed as dist
from repro_torch.launch import mesh as m
from repro_torch.launch.dryrun import run_cell
single = m.make_production_mesh()
multi = m.make_production_mesh(multi_pod=True)
print("RESULT " + json.dumps({
    "backend": dist.get_backend(), "world": dist.get_world_size(),
    "single": [list(single.shape), list(single.mesh_dim_names),
               m.n_chips(single), single.get_coordinate()],
    "multi": [list(multi.shape), list(multi.mesh_dim_names),
              m.n_chips(multi)],
    "data_group": dist.get_world_size(single.get_group("data")),
    "ep_sm": run_cell("deepseek-v3-671b", "prefill_32k", False,
                      opt_override={"expert_sharding": "ep_sm",
                                    "n_experts": 16},
                      verbose=False, smoke=True)}))
"""


def test_dry_run_world_and_production_meshes():
    """The ``fake`` backend (a private module of torch, pinned here): a
    512-rank world in one process, and both production meshes over it.
    The ep_sm MoE's collectives (deepseek-v3 smoke with 16 experts, so
    that they divide over "data"), walked as one rank's share, as the
    reference's partition issues them (its HLO, Auto axes): each chunk
    routed whole outside the body, its router's f32 scores (16 rows of
    4096 tokens, 16 experts) all-gathered over "data" for the top-k
    (33,554,432 elements over 2 MoE layers x 16 chunks); each MoE
    layer's tiled all-to-all of its dispatched rows and its inverse, the
    rank's 16 rows of 4096 tokens (its 2 of prefill_32k's 32 sequences)
    in (16 x 16, 1, C=640, 64) bf16, and the body's one all-reduce over
    "model" of its (16, 4096, 64) output (``_SumReplicas``); beside them
    the all-reduces DTensor issues: the FFNs' d_ff and the table's vocab
    split over "model", and each chunk's expert counts summed over the
    rank's tokens (``sharding.partial_scatter_add``, 16 int64 a chunk:
    the reference's prefill drops its unused load, so its HLO has no
    such all-reduce; the walk runs every op)."""
    r = _result(_start(_WORLD), timeout=200)
    assert r["backend"] == "fake" and r["world"] == 512
    assert r["single"] == [[16, 16], ["data", "model"], 256, [0, 0]]
    assert r["multi"] == [[2, 16, 16], ["pod", "data", "model"], 512]
    assert r["data_group"] == 16
    cell = r["ep_sm"]
    assert cell["status"] == "ok", cell
    moe, chunks, tokens = 2, 16, 2 * 32768 * 64  # MoE layers; the rank's
    ag = moe * chunks * (16 * 4096 * 16) * 4      # the scores, f32
    a2a = moe * 2 * (16 * 16 * 640 * 64) * 2      # (fwd, inverse), bf16
    ar = (moe * 16 * 4096 * 64 * 2    # the body's sum over "model", bf16
          + 3 * tokens * 2            # dense FFN + 2 shared: d_ff split
          + tokens * 4                # embedding rows: vocab split, f32
          + moe * chunks * 16 * 8)    # each chunk's expert counts, int64
    assert cell["coll_breakdown"] == {"all-gather(g=16)": ag,
                                      "all-to-all(g=16)": a2a,
                                      "all-reduce(g=16)": ar}
    assert cell["coll_elements"]["all-gather(g=16)"] == 33_554_432
    assert cell["coll_elements"]["all-to-all(g=16)"] == 41_943_040
    assert cell["coll_traffic_per_device"] == sum(
        ca._collective_traffic(k.split("(")[0], v, int(k[k.index("=") + 1:-1]))
        for k, v in cell["coll_breakdown"].items())
    assert cell["replicated_ops"] == {}
    assert cell["terms"]["collective_s"] > 0


def test_gemma2_cells_match_the_references_run_cell():
    got = _check_cells("gemma2-2b", CELLS)
    assert got["train_4k"]["memory"]["argument_bytes"] == 384_748_552
    assert got["long_500k"]["memory"]["argument_bytes"] == 3_794_860_040
    assert got["train_4k"]["memory"]["alias_bytes"] == 384_224_260
    assert got["long_500k"]["memory"]["alias_bytes"] == 1_760_179_200
    print(got["train_4k"]["sharding_fallbacks"])


def test_whisper_train_cell_matches_the_references_partition():
    """A second arch whose heads cannot split over "model" (8 heads), with
    square attention projections (8 x 64 = d_model 512) and a vocab that
    cannot split either (51865): its table moves to "model" for the
    lookup and the unembedding, as the reference's partition moves it."""
    got = _check_cells("whisper-base", ("train_4k",))
    assert got["train_4k"]["memory"]["argument_bytes"] == 103_370_120
    assert got["train_4k"]["memory"]["alias_bytes"] == 35_736_964


@pytest.mark.parametrize("kind", ["all-reduce", "all-gather",
                                  "reduce-scatter", "all-to-all",
                                  "collective-permute", "other"])
def test_collective_traffic_is_the_references(kind):
    for g in (1, 2, 4, 8, 16, 256, 512):
        for rb in (0.0, 4.0, 1e6, 3.5e9):
            assert ca._collective_traffic(kind, rb, g) == \
                jhlo._collective_traffic(kind, rb, g), (kind, g, rb)
    assert ca.DTYPE_BYTES == jhlo.DTYPE_BYTES
    a, b = ca.Cost(1.0, 2.0, {"all-reduce(g=2)": 3.0}, 4.0, 0.5), ca.Cost()
    b.add(a, 2.0)
    assert (b.flops, b.bytes, b.coll_bytes, b.coll_traffic, b.dot_flops) \
        == (2.0, 4.0, {"all-reduce(g=2)": 6.0}, 8.0, 1.0)


def test_count_as_weights_a_scan_step_forward_and_backward():
    """One step counted as n costs what the n-step loop costs, forward
    and backward (the reference multiplies a while body by its trip
    count), but for the loop's n - 1 adds that sum the weight's
    gradient over its n uses."""
    n = 7
    w = torch.empty((16, 16), device="meta", requires_grad=True)
    x = torch.empty((4, 16), device="meta", requires_grad=True)

    def loop():
        h = x
        for _ in range(n):
            h = torch.tanh(h @ w)
        h.sum().backward()

    def weighted():
        h = ca.count_as(n, lambda: torch.tanh(x @ w), [x, w])
        h.sum().backward()

    want = ca.count_step(loop)
    w.grad = x.grad = None
    got = ca.count_step(weighted)
    assert want.flops - got.flops == (n - 1) * w.numel(), (got, want)
    assert want.bytes - got.bytes == (n - 1) * 3 * w.numel() * 4
    assert got.flops == n * (2 * 4 * 16 * 16 + 4 * 16          # mm, tanh
                             + 4 * 16 + 2 * 2 * 4 * 16 * 16    # backward
                             ) + 4 * 16                        # the sum
    mm = ca.count_step(lambda: x @ w)
    assert mm.flops == mm.dot_flops == 2 * 4 * 16 * 16
    assert mm.bytes == (4 * 16 + 16 * 16 + 4 * 16) * 4


def test_by_source_splits_the_dot_flops_by_the_code_that_ran_them(
        monkeypatch):
    """With ``cost_analysis.BY_SOURCE`` set (``tests/_dryrun_survey.py
    --sources``), each dot's FLOPs are filed under the innermost model
    frame that ran it — in the backward pass the one that made the
    autograd node — and the split sums to ``dot_flops``; off, the
    default, nothing is split."""
    from repro_torch.models.layers import ffn
    params = {k: torch.empty(shape, device="meta", requires_grad=True)
              for k, shape in (("w_up", (16, 32)), ("w_gate", (16, 32)),
                               ("w_down", (32, 16)))}
    x = torch.empty((4, 16), device="meta", requires_grad=True)

    def step():
        ffn(params, x, torch.float32).sum().backward()

    assert ca.count_step(step).by_source == {}
    monkeypatch.setattr(ca, "BY_SOURCE", True)
    cost = ca.count_step(step)
    assert cost.by_source == {
        "dot | models/layers.py:ffn": 3 * 2 * 4 * 16 * 32,
        "dot | bwd models/layers.py:ffn": 6 * 2 * 4 * 16 * 32}
    assert sum(cost.by_source.values()) == cost.dot_flops


@pytest.mark.parametrize("arch", ["deepseek-v2-236b", "deepseek-v3-671b"])
def test_route_counts_equal_bincount(arch):
    """``route``'s expert counts: ``scatter_add_`` (which has a meta
    kernel) in place of ``torch.bincount``, bit for bit."""
    cfg = get_smoke_config(arch).replace(compute_dtype="float32")
    p = P.init(moe.moe_spec(cfg), torch.Generator().manual_seed(0),
               "float32", "cpu")
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (3, 37, cfg.d_model)).astype(np.float32))
    ids, _, _, load = moe.route(cfg, p, x)
    counts = torch.bincount(ids.reshape(-1), minlength=cfg.n_experts)
    want = counts.float() / torch.clamp_min(counts.float().sum(), 1.0)
    assert torch.equal(load, want)
    m = torch.empty((3, 37, cfg.d_model), device="meta")
    pm = {k: v.to("meta") if torch.is_tensor(v) else v for k, v in p.items()}
    assert moe.route(cfg, pm, m)[3].shape == (cfg.n_experts,)


def test_resolve_device_takes_meta_only_when_asked(monkeypatch):
    assert resolve_device("meta") == torch.device("meta")
    assert resolve_device("cpu") == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(ValueError, match="unsupported device"):
        resolve_device("mps")
