"""The port's dry run (``repro_torch.launch.dryrun``, ``launch.mesh``,
``launch.cost_analysis``) against the reference's, on the CPU, and the
two repairs that let the model's steps run on ``meta`` tensors.

A dry-run world is a process group (the ``fake`` backend), so every run
of ``make_production_mesh`` here happens in a subprocess of its own:
under ``--dist loadfile`` a group made in the pytest worker would leak
into the next test file on that worker.  The reference runs in a
subprocess too, with its production mesh rebuilt with Auto axes (JAX
0.9 makes Explicit axes, where its own ``tests/test_dryrun.py`` fails);
nothing in ``src/repro`` changes for that.

What must hold:
  * on gemma2-2b x train_4k and x long_500k (16x16 mesh, full config),
    the port's per-device ``argument_bytes`` equals the reference's
    compiled ``memory_analysis`` exactly, and the fallback text is the
    reference's;
  * the collectives the port calls are counted by kind and group, and
    priced by the reference's ring-traffic model, copied unchanged;
  * a scan step counted by ``count_as`` costs what its loop costs;
  * ``route``'s counts are ``torch.bincount``'s, bit for bit;
    ``resolve_device`` takes ``"meta"`` only when asked.

The reference's ``hlo_flops_per_device`` is printed beside the port's
even split of its global FLOPs, unbounded: they count different things
(one SPMD partition's fused HLO against the whole eager step / 256).
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

_REF = r"""
import json, sys
import repro.launch.dryrun as d        # sets the 512-device flag first
import jax

def auto_mesh(*, multi_pod=False):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return jax.make_mesh(shape, axes,
                         axis_types=(jax.sharding.AxisType.Auto,) * len(axes))

d.mesh_lib.make_production_mesh = auto_mesh
out = {s: d.run_cell("gemma2-2b", s, False, verbose=False)
       for s in sys.argv[1:]}
print("RESULT " + json.dumps(out))
"""

_PORT = r"""
import json, sys
from repro_torch.launch.dryrun import run_cell
out = {s: run_cell("gemma2-2b", s, False, verbose=False)
       for s in sys.argv[1:]}
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
    The collectives the port calls itself (the ep_sm MoE: deepseek-v3
    smoke with 16 experts, so that they divide over "data") are counted
    on ``meta`` tensors by kind and group, each result's bytes from its
    shape: 2 MoE layers x 16 chunks of 16 rows, a chunk's all-to-all
    result (16, 1, C=640, 64) bf16, its all-reduce (1, 4096, 64), its
    all-gather (16, 4096, 64)."""
    r = _result(_start(_WORLD), timeout=200)
    assert r["backend"] == "fake" and r["world"] == 512
    assert r["single"] == [[16, 16], ["data", "model"], 256, [0, 0]]
    assert r["multi"] == [[2, 16, 16], ["pod", "data", "model"], 512]
    assert r["data_group"] == 16
    cell = r["ep_sm"]
    assert cell["status"] == "ok", cell
    per = 2 * 16 * 2                      # layers x chunks x bf16 bytes
    a2a, ar, ag = (per * 2 * 16 * 640 * 64, per * 4096 * 64,
                   per * 16 * 4096 * 64)
    assert cell["port_collectives"]["coll_breakdown"] == {
        "all-to-all(g=16)": a2a, "all-reduce(g=16)": ar,
        "all-gather(g=16)": ag}
    assert cell["port_collectives"]["coll_traffic"] == \
        ca._collective_traffic("all-to-all", a2a, 16) \
        + ca._collective_traffic("all-reduce", ar, 16) \
        + ca._collective_traffic("all-gather", ag, 16)


def test_gemma2_cells_match_the_references_run_cell():
    ref, port = _start(_REF, *CELLS), _start(_PORT, *CELLS)
    want, got = _result(ref), _result(port)
    for s in CELLS:
        w, g = want[s], got[s]
        assert w["status"] == "ok" and g["status"] == "ok", (w, g)
        assert g["chips"] == w["chips"] == 256
        assert g["memory"]["argument_bytes"] == \
            w["memory"]["argument_bytes"], (s, g["memory"], w["memory"])
        assert g["sharding_fallbacks"] == w["sharding_fallbacks"], s
        assert g["terms"]["collective_s"] is None
        assert "not counted" in g["collective_s_reason"]
        assert g["terms"]["compute_s"] > 0 and g["terms"]["memory_s"] > 0
        print(f"gemma2-2b x {s}: argument_bytes {g['memory']['argument_bytes']:,}"
              f" (reference {w['memory']['argument_bytes']:,}); "
              f"{g['memory']['argument_bytes_by_tree']}")
    assert got["train_4k"]["memory"]["argument_bytes"] == 384_748_552
    assert got["long_500k"]["memory"]["argument_bytes"] == 3_794_860_040
    w, g = want["train_4k"], got["train_4k"]
    print(f"train_4k FLOPs per device: reference hlo_flops_per_device "
          f"{w['hlo_flops_per_device']:.4e} (one partition's HLO); port "
          f"flops_per_device_even_split {g['flops_per_device_even_split']:.4e}"
          f" (the eager step's global {g['flops_global']:.4e} / 256)")
    print(got["train_4k"]["sharding_fallbacks"])


@pytest.mark.parametrize("kind", ["all-reduce", "all-gather",
                                  "reduce-scatter", "all-to-all",
                                  "collective-permute", "other"])
def test_collective_traffic_is_the_references(kind):
    for g in (1, 2, 4, 8, 16, 256, 512):
        for rb in (0.0, 4.0, 1e6, 3.5e9):
            assert ca._collective_traffic(kind, rb, g) == \
                jhlo._collective_traffic(kind, rb, g), (kind, g, rb)
    assert ca.DTYPE_BYTES == jhlo.DTYPE_BYTES
    a, b = ca.Cost(1.0, 2.0, {"all-reduce(g=2)": 3.0}, 4.0), ca.Cost()
    b.add(a, 2.0)
    assert (b.flops, b.bytes, b.coll_bytes, b.coll_traffic) == \
        (2.0, 4.0, {"all-reduce(g=2)": 6.0}, 8.0)


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
    assert mm.flops == 2 * 4 * 16 * 16
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
