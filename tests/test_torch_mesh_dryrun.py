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
  * a scan step counted by ``count_as`` costs what its loop costs;
  * ``route``'s counts are ``torch.bincount``'s, bit for bit;
    ``resolve_device`` takes ``"meta"`` only when asked.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.launch import hlo_analysis as jhlo
from repro_torch.configs import get_smoke_config
from repro_torch.device import resolve_device
from repro_torch.launch import cost_analysis as ca
from repro_torch.models import moe
from repro_torch.models import params as P

ROOT = Path(__file__).resolve().parents[1]
CELLS = ("train_4k", "long_500k")

_REF = (ROOT / "tests" / "_dryrun_ref.py").read_text()

_PORT = r"""
import json, sys
from repro_torch.launch.dryrun import run_cell
out = {s: run_cell(sys.argv[1], s, False, verbose=False)
       for s in sys.argv[2:]}
print("RESULT " + json.dumps(out))
"""

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


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    return env


def _start(snippet, *args):
    return subprocess.Popen([sys.executable, "-c", snippet, *args],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, env=_env(), cwd=ROOT)


def _result(proc, timeout=300):
    out, err = proc.communicate(timeout=timeout)
    for line in out.splitlines():
        if line.startswith("RESULT "):
            return json.loads(line[len("RESULT "):])
    raise AssertionError(err[-2000:])


def test_dry_run_world_and_production_meshes():
    """The ``fake`` backend (a private module of torch, pinned here): a
    512-rank world in one process, and both production meshes over it.
    The ep_sm MoE's own collectives (deepseek-v3 smoke with 16 experts,
    so that they divide over "data"), walked as one rank's share, are
    counted once: each MoE layer's tiled all-to-all of its dispatched
    rows and its inverse, the rank's 16 rows of 4096 tokens (its 2 of
    prefill_32k's 32 sequences) in (16 x 16, 1, C=640, 64) bf16, and
    the body's one all-reduce over "model" of its (16, 4096, 64) output
    (``_SumReplicas``); beside them the all-reduces DTensor issues: the
    FFNs' d_ff and the table's vocab split over "model", the router's
    load counted over the whole batch."""
    r = _result(_start(_WORLD), timeout=200)
    assert r["backend"] == "fake" and r["world"] == 512
    assert r["single"] == [[16, 16], ["data", "model"], 256, [0, 0]]
    assert r["multi"] == [[2, 16, 16], ["pod", "data", "model"], 512]
    assert r["data_group"] == 16
    cell = r["ep_sm"]
    assert cell["status"] == "ok", cell
    moe, tokens = 2, 2 * 32768 * 64       # MoE layers; the rank's tokens
    a2a = moe * 2 * (16 * 16 * 640 * 64) * 2      # (fwd, inverse), bf16
    ar = (moe * 16 * 4096 * 64 * 2    # the body's sum over "model", bf16
          + 3 * tokens * 2            # dense FFN + 2 shared: d_ff split
          + tokens * 4                # embedding rows: vocab split, f32
          + moe * (16 + 1) * 4)       # the router's expert load, total
    assert cell["coll_breakdown"] == {"all-to-all(g=16)": a2a,
                                      "all-reduce(g=16)": ar}
    assert cell["coll_traffic_per_device"] == sum(
        ca._collective_traffic(k.split("(")[0], v, int(k[k.index("=") + 1:-1]))
        for k, v in cell["coll_breakdown"].items())
    assert cell["replicated_ops"] == {}
    assert cell["terms"]["collective_s"] > 0


def _check_cells(arch, shapes):
    """The port's dry run of ``arch`` x ``shapes`` on the 16x16 mesh
    against the reference's ``run_cell`` and one SPMD partition of its
    HLO, each run in its subprocess at once.  The reference's dots run
    in float32 on this CPU (XLA's float normalization), so the
    collectives of their results carry twice the port's bf16 bytes: each
    kind is held by the elements it moves."""
    ref, port = _start(_REF, arch, *shapes), _start(_PORT, arch, *shapes)
    want, got = _result(ref), _result(port)
    for s in shapes:
        w, g = want[s], got[s]
        assert w["status"] == "ok" and g["status"] == "ok", (w, g)
        assert g["chips"] == w["chips"] == 256
        gm, wm = g["memory"], w["memory"]
        assert gm["argument_bytes"] == wm["argument_bytes"], (s, gm, wm)
        assert gm["alias_bytes"] == wm["alias_bytes"], (s, gm, wm)
        # XLA's output adds the output tuple's table: 8 bytes a leaf
        assert 0 <= wm["output_bytes"] - gm["output_bytes"] <= 1024, (gm, wm)
        assert g["sharding_fallbacks"] == w["sharding_fallbacks"], s
        dot = g["dot_flops_per_device"] / w["dot_flops"]
        coll = g["coll_traffic_per_device"] / w["coll_traffic_per_device"]
        assert abs(dot - 1) <= 0.10, (s, dot)
        assert 0.5 <= coll <= 2.0, (s, coll, g["coll_breakdown"],
                                    w["coll_breakdown"])
        # each kind of collective by the elements it moves: the
        # reference's CPU compile carries f32 activations and s32 indices
        # where the port carries bf16 and int64, so the bytes (the ratio
        # above) differ by kind but the data moved does not.  Readings
        # (PERF.md): gemma2-2b train_4k all-gather 1.0011, all-reduce
        # 0.9978, all-to-all 1.0000, collective-permute 0.9991, long_500k
        # 1.0000; whisper-base train_4k 1.0000 to 1.0001
        ge, we = g["coll_elements"], w["coll_elements"]
        for k, n in we.items():
            assert abs(ge.get(k, 0) / n - 1) <= 0.01, (s, k, ge, we)
        extra = sum(v for k, v in ge.items() if k not in we)
        assert extra <= 1e-3 * sum(ge.values()), (s, ge, we)
        t = g["terms"]
        assert set(t) == {"compute_s", "memory_s", "collective_s"}
        assert t["collective_s"] > 0 and t["compute_s"] > 0 \
            and t["memory_s"] > 0
        assert g["bottleneck"] == max(t, key=t.get)
        assert g["replicated_ops"] == {}, g["replicated_ops"]
        print(f"{arch} x {s} per device, port / reference: dot FLOPs "
              f"{g['dot_flops_per_device']:.4e} / {w['dot_flops']:.4e} "
              f"({dot:.4f}); FLOPs {g['flops_per_device']:.4e} / "
              f"{w['hlo_flops_per_device']:.4e} "
              f"({g['flops_per_device'] / w['hlo_flops_per_device']:.4f}); "
              f"bytes (eager, unfused / fused) {g['bytes_per_device']:.4e} / "
              f"{w['hlo_bytes_per_device']:.4e} "
              f"({g['bytes_per_device'] / w['hlo_bytes_per_device']:.4f}); "
              f"collective traffic {g['coll_traffic_per_device']:.4e} / "
              f"{w['coll_traffic_per_device']:.4e} ({coll:.4f}); elements "
              + ", ".join(f"{k} {ge.get(k, 0):.6e} / {n:.6e} "
                          f"({ge.get(k, 0) / n:.4f})" for k, n in we.items())
              + f"; port only {extra:.0f}; "
              f"argument bytes {gm['argument_bytes']:,}; alias "
              f"{gm['alias_bytes']:,}; output {gm['output_bytes']:,} / "
              f"{wm['output_bytes']:,}; walk {g['step_s']} s")
    return got


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
