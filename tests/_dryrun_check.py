"""The port's dry run held to the reference's partition, cell by cell:
``check_cells`` runs the reference (``tests/_dryrun_ref.py``: its
``run_cell`` on the 16x16 mesh, or the 2x16x16 one, rebuilt with Auto
axes, and one SPMD partition's dot FLOPs and collective elements read
from its HLO) of
one arch's cells in a subprocess, and the port's
(``repro_torch.launch.dryrun.run_cell``) in a subprocess a cell, all
at once, and asserts that they agree.  Shared by ``tests/test_torch_mesh_dryrun*.py``."""
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

_REF = (ROOT / "tests" / "_dryrun_ref.py").read_text()

_PORT = r"""
import json, sys
from repro_torch.launch.dryrun import run_cell
multi_pod = sys.argv[1] == "--multi-pod"
arch, shapes = sys.argv[1 + multi_pod], sys.argv[2 + multi_pod:]
out = {s: run_cell(arch, s, multi_pod, verbose=False) for s in shapes}
print("RESULT " + json.dumps(out))
"""


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    return env


def start(snippet, *args):
    return subprocess.Popen([sys.executable, "-c", snippet, *args],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, env=_env(), cwd=ROOT)


def result(proc, timeout=300):
    out, err = proc.communicate(timeout=timeout)
    for line in out.splitlines():
        if line.startswith("RESULT "):
            return json.loads(line[len("RESULT "):])
    raise AssertionError(err[-2000:])


def check_cells(arch, shapes, memory_only=False, dot_rtol=0.10,
                multi_pod=False):
    """The port's dry run of ``arch`` x ``shapes`` on the 16x16 mesh
    (``multi_pod``: the 2x16x16 one, on both sides) against the
    reference's ``run_cell`` and one SPMD partition of its
    HLO, each run in subprocesses at once.  The reference's dots run
    in float32 on this CPU (XLA's float normalization), so the
    collectives of their results carry twice the port's bf16 bytes: each
    kind is held by the elements it moves.  ``memory_only``: the
    argument, alias and output bytes alone (a cell whose partition
    differs, recorded in ROADMAP.md); ``dot_rtol``: the dot FLOPs'
    tolerance."""
    # the reference compiles its cells in one process; the port walks
    # each cell in one of its own, all at once
    flag = ("--multi-pod",) if multi_pod else ()
    ref = start(_REF, *flag, arch, *shapes)
    ports = [start(_PORT, *flag, arch, s) for s in shapes]
    want, got = result(ref, 600), {}
    for port in ports:
        got.update(result(port, 600))
    for s in shapes:
        w, g = want[s], got[s]
        assert w["status"] == "ok" and g["status"] == "ok", (w, g)
        # the reference's elements by kind and dot FLOPs, for a caller's
        # closer look
        g["reference_coll_elements"] = w["coll_elements"]
        g["reference_dot_flops"] = w["dot_flops"]
        g["reference_memory"] = w["memory"]
        assert g["chips"] == w["chips"] == (512 if multi_pod else 256)
        gm, wm = g["memory"], w["memory"]
        assert gm["argument_bytes"] == wm["argument_bytes"], (s, gm, wm)
        assert gm["alias_bytes"] == wm["alias_bytes"], (s, gm, wm)
        # XLA's output adds the output tuple's table: 8 bytes a leaf
        assert 0 <= wm["output_bytes"] - gm["output_bytes"] <= 1024, (gm, wm)
        # the working memory beyond arguments and outputs, by eager
        # PyTorch's buffers against XLA's: reported, and held only for a
        # train step, below (the reference's CPU compile runs dots in f32
        # and schedules on its own terms); a train or prefill step holds
        # some
        temp = gm["temp_bytes"]
        assert isinstance(temp, int) and temp >= 0, gm
        assert temp > 0 or s.split("_")[0] not in ("train", "prefill"), gm
        temps = (f"temp {temp:,} / {wm['temp_bytes']:,} "
                 f"({temp / max(wm['temp_bytes'], 1):.4f})")
        # a train step's temp within 2.5x of XLA's: the logits' gradient
        # kept split like the logits (``sharding.gathered_on_blocks``),
        # not the gold gather's whole (256, 4096, vocab) f32 zeros and
        # its (16, 4096, vocab) scatter (3.1-57x before; PERF.md §6).
        # Readings on 16x16: gemma2-2b 0.8132, gemma3-4b 0.8936,
        # gemma2-27b 0.8550, whisper-base 1.2666, granite-3-2b 1.2592,
        # qwen2-vl-72b 0.4293, recurrentgemma-9b 1.8778, deepseek-v2-236b
        # 1.0911, xlstm-125m 1.4197; gemma2-2b on 2x16x16 0.8110,
        # xlstm-125m there 1.3499.  A prefill step's likewise: its
        # attention mask and rotary angles built from positions split
        # like the rows they meet (``sharding.rows_split_as``), not from
        # whole ones carrying the global batch ((32, 32768, 32768) bool
        # blocks on every rank: up to 4.96x on 16x16 and 9.74x on
        # 2x16x16 before; PERF.md §6).  Readings on 16x16 0.3381
        # (xlstm-125m) to 1.4478 (gemma2-2b), recurrentgemma-9b 1.2186;
        # on 2x16x16 0.3392 to 1.4485 (gemma2-2b), recurrentgemma-9b
        # 1.2096
        assert s.split("_")[0] not in ("train", "prefill") \
            or temp <= 2.5 * wm["temp_bytes"], (s, temps)
        if memory_only:
            print(f"{arch} x {s} per device: argument bytes "
                  f"{gm['argument_bytes']:,}; alias {gm['alias_bytes']:,}; "
                  f"output {gm['output_bytes']:,} / {wm['output_bytes']:,}; "
                  f"{temps}; walk {g['step_s']} s")
            continue
        assert g["sharding_fallbacks"] == w["sharding_fallbacks"], s
        dot = g["dot_flops_per_device"] / w["dot_flops"]
        coll = g["coll_traffic_per_device"] / w["coll_traffic_per_device"]
        assert abs(dot - 1) <= dot_rtol, (s, dot)
        assert 0.5 <= coll <= 2.0, (s, coll, g["coll_breakdown"],
                                    w["coll_breakdown"])
        # each kind of collective by the elements it moves: the
        # reference's CPU compile carries f32 activations and s32 indices
        # where the port carries bf16 and int64, so the bytes (the ratio
        # above) differ by kind but the data moved does not.  Readings
        # (PERF.md §6): gemma2-2b train_4k all-gather 1.0000, all-reduce
        # 0.9977, all-to-all 1.0000, collective-permute 1.0000, long_500k
        # 1.0000; whisper-base and granite-3-2b train_4k every kind
        # 1.0000, qwen2-vl-72b 0.9997 to 1.0002; on 2x16x16 each dense
        # train cell's all-reduce(g=32) 1.0000 (each norm's gradient
        # reduced once, in the backward), every kind of gemma2-27b and
        # recurrentgemma-9b long_500k 1.0000; deepseek-v3-671b and
        # deepseek-v2-236b decode_32k every kind 1.0000 but all-reduce
        # (g=32) 1.0001-1.0004 and all-to-all(g=32) 0.9981 (XLA hoists
        # the zero row's all-to-all out of the layer loop), prefill_32k
        # every kind 1.0000 but collective-permute(g=512) 0.9998 (the
        # reference moves each chunk's rows with the bucket's sentinel);
        # xlstm-125m long_500k every kind 1.0000, train_4k every kind
        # 1.0000 but collective-permute(g=512) 0.9995 and all-reduce(g=4)
        # 1.0004
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
              f"{wm['output_bytes']:,}; {temps}; walk {g['step_s']} s")
    return got


def check_kinds_held(arch, shape, kinds, rtol=1e-3, multi_pod=True):
    """``arch`` x ``shape`` through ``check_cells`` (dot FLOPs within
    1 %), no op run replicated, and each of ``kinds``'s elements within
    ``rtol`` of the reference's: the kinds the rules that repaired the
    cell moved.  Returns the cell."""
    cell = check_cells(arch, (shape,), dot_rtol=0.01,
                       multi_pod=multi_pod)[shape]
    assert cell["replicated_ops"] == {}, cell["replicated_ops"]
    dot = cell["dot_flops_per_device"] / cell["reference_dot_flops"]
    assert abs(dot - 1) <= 0.01, dot
    ref = cell["reference_coll_elements"]
    for kind in kinds:
        got = cell["coll_elements"].get(kind, 0)
        assert abs(got / ref[kind] - 1) <= rtol, (kind, got, ref[kind])
    return cell


def check_gqa_cells(arch, shapes):
    """``check_cells`` of a GQA arch, whose queries viewed as (KV, group)
    keep their heads' split over "model" cut into 8 x 2: its train cell
    has the collectives over each factor (the keys' and values'
    gradients gathered over the 8 and summed over the 2)."""
    got = check_cells(arch, shapes)
    train = got["train_4k"]["coll_elements"]
    assert train["all-gather(g=8)"] > 0 and train["all-reduce(g=2)"] > 0
