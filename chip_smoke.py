#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py

Builds the port's hand-written Hopper kernels from ``src/repro_torch/
csrc`` and drives the service-enhanced RDMA datapath (paper Fig. 1):

  0. device   the card's name and power limit (nvidia-smi)
  1. build    nvcc, one process per kernel source, all at once
  2. kernels  AES-128-ECB, CRC32 and the DPI MLP at main-path sizes
              against their plain PyTorch versions on the card.  A
              kernel's ``ms`` is its device time from a torch.profiler
              trace (median launch; CUDA events around back-to-back
              calls if the trace holds no device time), ``call_ms`` the
              wrapper's whole call by CUDA events
  3. main     256 QPs x 128 KiB (one 8192-packet, 32 MiB receive batch)
              RDMA-written across a lossy link by two RdmaNodes; the
              sender encrypts, the receiver decrypts on-path and runs DPI
              on the parallel path.  Run with the kernels, then with the
              plain versions: every byte must land and the two runs must
              agree on every tick and counter
  4. chain    the receive chain with an ICRC tap on one 8192-packet batch
              of that traffic, kernels against plain versions, bit-exact
  5. incast   the 8:1 ack-clocked incast on the card reproduces the row
              of BENCH_fig6_multipath.json exactly

Two paths are driven through the kernels, each with the launch
counters set to 0 just before it and read just after it: the main path
(phase 3, kernel arm), which launches AES and DPI, and the ICRC chain
(phase 4, kernel arm), which launches all three.  The line before the
last is a JSON object with every kernel's path, launches on that path
(and on each path apart), error, time, plain time, bound and library
time; the last line is the run's verdict.
Any failure raises, so the script exits non-zero and prints no verdict;
it also exits non-zero, printing nothing, without a CUDA device or
without the port's sources beside it.
"""
import json
import statistics
import subprocess
import sys
import time
import zlib
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

KEY = np.arange(16, dtype=np.uint8)
N_QPS = 256
MSG_BYTES = 128 * 1024          # per QP: 32 packets of the 4 KiB MTU
MTU = 4096
N_PKTS = N_QPS * MSG_BYTES // MTU                     # 8192 packets, 32 MiB
DPI_RTOL = DPI_ATOL = 1e-5

# H100 SXM data-sheet peaks
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12


def _median_ms(fn, reps: int, burst: int = 1) -> float:
    """Median over ``reps`` of the CUDA-event time of ``burst``
    back-to-back calls of ``fn``, per call (one warm-up call first)."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(burst):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / burst)
    return statistics.median(times)


def _kernel_ms(fn, kernel: str, reps: int):
    """Device time of one launch of the CUDA kernel whose name holds
    ``kernel``: the median over ``reps`` launches in a torch.profiler
    trace, so host work in the wrapper is not counted.  Returns (ms,
    "profiler"), or (ms, "events") from ``_median_ms`` over bursts of 10
    calls when the trace holds no device time for the kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    times = [e.time_range.elapsed_us() / 1e3 for e in prof.events()
             if kernel in e.name
             and e.device_type == torch.autograd.DeviceType.CUDA
             and e.time_range.elapsed_us() > 0]
    if len(times) == reps:
        return statistics.median(times), "profiler"
    return _median_ms(fn, 5, burst=10), "events"


def _bound_ms(n_bytes: float, flops: float):
    by_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    by_ops = flops / FP32_FLOPS * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops,
                                                            "operations")


def phase_device() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(out)
    return out


def phase_build() -> float:
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    paths = _build.build_all()
    secs = time.perf_counter() - t0
    print(f"[build] {len(paths)} kernels in {secs:.2f} s")
    for name, so in paths.items():
        log = so.with_suffix(".log")
        if log.exists():
            for line in log.read_text().splitlines():
                if "registers" in line or "spill" in line:
                    print(f"[build] {name}: {line.strip()}")
    return secs


def phase_kernels(dev, params) -> dict:
    """Each kernel against its plain version at main-path sizes."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels.dpi_mlp import dpi_params_from_numpy
    gen = torch.Generator(device=dev).manual_seed(0)
    # the round keys live on the card, as AesService keeps them
    rk = torch.as_tensor(ops.expand_key(KEY)).to(dev)
    out = {}

    # --- AES-128-ECB: FIPS-197, then 32 MiB of random blocks ------------
    pt = torch.tensor(list(bytes.fromhex("00112233445566778899aabbccddeeff")),
                      dtype=torch.uint8, device=dev)[None]
    ct = ops.aes_ecb(pt, rk)
    assert bytes(ct.cpu().numpy()[0]).hex() == \
        "69c4e0d86a7b0430d8cdb78070b4c55a", "AES FIPS-197 vector"
    blocks = torch.randint(0, 256, (N_PKTS * MTU // 16, 16), generator=gen,
                           device=dev, dtype=torch.uint8)
    enc = ops.aes_ecb(blocks, rk)
    enc_ref = ops.aes_ecb(blocks, rk, impl="ref")
    dec = ops.aes_ecb(enc, rk, decrypt=True)
    dec_ref = ops.aes_ecb(enc, rk, decrypt=True, impl="ref")
    torch.cuda.synchronize()
    assert torch.equal(enc, enc_ref), "AES encrypt differs from plain"
    assert torch.equal(dec, dec_ref), "AES decrypt differs from plain"
    assert torch.equal(dec, blocks), "AES round trip"
    err = max(int((enc.int() - enc_ref.int()).abs().max()),
              int((dec.int() - dec_ref.int()).abs().max()))
    enc_ms, _ = _kernel_ms(lambda: ops.aes_ecb(blocks, rk),
                           "aes_ecb_kernel", 20)
    dec = lambda: ops.aes_ecb(enc, rk, decrypt=True)  # noqa: E731
    ms, ms_from = _kernel_ms(dec, "aes_ecb_kernel", 20)
    call_ms = _median_ms(dec, 5, burst=10)
    plain_ms = _median_ms(
        lambda: ops.aes_ecb(enc, rk, decrypt=True, impl="ref"), 3)
    bound, by = _bound_ms(2 * blocks.numel(), 0)
    out["aes_ecb"] = dict(max_abs_err=err, ms=ms, ms_from=ms_from,
                          call_ms=call_ms, plain_ms=plain_ms, bound_ms=bound,
                          bound_by=by, library_ms=None)
    print(f"[kernels] aes_ecb {blocks.shape[0]} blocks: bit-exact enc+dec, "
          f"decrypt kernel_ms={ms:.4f} ({ms_from}) call_ms={call_ms:.4f} "
          f"encrypt kernel_ms={enc_ms:.4f} plain_ms={plain_ms:.3f} "
          f"bound_ms={bound:.4f} ({by})")

    # --- CRC32: 8192 x 4096 payloads, ragged lengths ---------------------
    pay = torch.randint(0, 256, (N_PKTS, MTU), generator=gen, device=dev,
                        dtype=torch.uint8)
    ragged = torch.rand(N_PKTS, generator=gen, device=dev) < 0.25
    plen = torch.where(
        ragged, torch.randint(0, MTU + 1, (N_PKTS,), generator=gen,
                              device=dev), MTU).to(torch.int32)
    crc = ops.crc32(pay, plen)
    crc_ref = ops.crc32(pay, plen, impl="ref")
    torch.cuda.synchronize()
    assert torch.equal(crc, crc_ref), "CRC32 differs from plain"
    pay_h, plen_h, crc_h = pay[:64].cpu().numpy(), plen[:64].cpu().numpy(), \
        crc[:64].cpu().numpy()
    for i in range(64):
        assert crc_h[i] == zlib.crc32(pay_h[i, :plen_h[i]].tobytes()), \
            f"CRC32 differs from zlib at packet {i}"
    ms, ms_from = _kernel_ms(lambda: ops.crc32(pay, plen), "crc32_kernel",
                             20)
    call_ms = _median_ms(lambda: ops.crc32(pay, plen), 5, burst=10)
    plain_ms = _median_ms(lambda: ops.crc32(pay, plen, impl="ref"), 3)
    n_bytes = int(plen.clamp(0, MTU).sum()) + 4 * N_PKTS + 4 * N_PKTS
    bound, by = _bound_ms(n_bytes, 0)
    out["crc32"] = dict(max_abs_err=int((crc - crc_ref).abs().max()), ms=ms,
                        ms_from=ms_from, call_ms=call_ms, plain_ms=plain_ms,
                        bound_ms=bound, bound_by=by, library_ms=None)
    print(f"[kernels] crc32 {N_PKTS}x{MTU} ragged ({n_bytes} B): bit-exact "
          f"vs plain and zlib, kernel_ms={ms:.4f} ({ms_from}) "
          f"call_ms={call_ms:.4f} plain_ms={plain_ms:.3f} "
          f"bound_ms={bound:.4f} ({by})")

    # --- DPI MLP: 524,288 beats with the trained fixture ------------------
    tparams = dpi_params_from_numpy(params, dev)
    scores = ops.dpi_scores(pay, tparams)
    scores_ref = ops.dpi_scores(pay, tparams, impl="ref")
    torch.cuda.synchronize()
    worst = float((scores - scores_ref).abs().max())
    torch.testing.assert_close(scores, scores_ref, rtol=DPI_RTOL,
                               atol=DPI_ATOL)
    ms, ms_from = _kernel_ms(lambda: ops.dpi_scores(pay, tparams),
                             "dpi_mlp_kernel", 10)
    call_ms = _median_ms(lambda: ops.dpi_scores(pay, tparams), 5, burst=5)
    plain_ms = _median_ms(lambda: ops.dpi_scores(pay, tparams, impl="ref"),
                          5)
    # the library yardstick: the same MLP as three fp32 cuBLAS calls on
    # pre-scaled weights (the port never calls this)
    w1 = tparams["w1"].float() * tparams["s1"]
    w2 = tparams["w2"].float() * tparams["s2"]
    w3 = tparams["w3"].float() * tparams["s3"]

    def library():
        x = pay.reshape(-1, 64).float() / 128.0 - 1.0
        h = torch.relu(torch.addmm(tparams["b1"], x, w1))
        h = torch.relu(torch.addmm(tparams["b2"], h, w2))
        return h @ w3
    library_ms = _median_ms(library, 5)
    beats = pay.numel() // 64
    bound, by = _bound_ms(pay.numel() + 4 * beats, 2 * 16448 * beats)
    out["dpi_mlp"] = dict(max_abs_err=worst, ms=ms, ms_from=ms_from,
                          call_ms=call_ms, plain_ms=plain_ms, bound_ms=bound,
                          bound_by=by, library_ms=library_ms)
    print(f"[kernels] dpi_mlp {beats} beats: worst abs error {worst:.3e} "
          f"(rtol=atol={DPI_RTOL}), kernel_ms={ms:.4f} ({ms_from}) "
          f"call_ms={call_ms:.4f} plain_ms={plain_ms:.3f} library_ms={library_ms:.4f} "
          f"bound_ms={bound:.4f} ({by})")
    return out


def _traffic():
    """Per QP one 128 KiB message: even QPs benign, odd QPs with 20 %
    embedded executable beats (numpy seed 0)."""
    from repro_torch.data.dpi_dataset import payload_with_embedded_malware
    rng = np.random.default_rng(0)
    return [payload_with_embedded_malware(MSG_BYTES, 0.2 if q % 2 else 0.0,
                                          rng) for q in range(N_QPS)]


def run_main_path(dev, params, data, impl):
    """Phase 3: the secure_flow link, 256 QPs, one arm (``impl=None``:
    the kernels; ``"ref"``: the plain versions)."""
    import torch
    from repro_torch.core.netsim import LinkConfig, Network
    from repro_torch.core.rdma import RdmaNode, run_network
    from repro_torch.core.services import (AesService, DpiService,
                                           ServiceChain)
    key = KEY
    net = Network(2, LinkConfig(loss_prob=0.02, latency_ticks=3, seed=1))
    chain = ServiceChain(
        on_path=[AesService(key=key, decrypt=True, impl=impl, device=dev)],
        parallel_after=[DpiService(params=params, impl=impl, device=dev)])
    a = RdmaNode(0, net, engine="batched", device=dev)
    b = RdmaNode(1, net, services=chain, engine="batched", device=dev)
    qpns = [a.init_rdma(MSG_BYTES, b)[0] for _ in range(N_QPS)]
    batches = []
    on_packets = b.on_packets

    def record(pkts):
        batches.append(len(pkts))
        on_packets(pkts)
    b.on_packets = record

    t0 = time.perf_counter()
    enc = AesService(key=key, impl=impl, device=dev)
    flat = np.stack(data).reshape(-1, MTU)
    ct = enc(torch.from_numpy(flat).to(dev),
             torch.full((flat.shape[0],), MTU, dtype=torch.int32,
                        device=dev)).cpu().numpy().reshape(N_QPS, -1)
    for q, qpn in enumerate(qpns):
        a.rdma_write(qpn, ct[q])
    ticks = run_network([a, b], max_ticks=50_000)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    for q, qpn in enumerate(qpns):
        got = b._qp_buffer[a.remote_qpn(qpn)][1][:MSG_BYTES]
        assert np.array_equal(got, data[q]), f"QP {qpn}: bytes differ"
    return dict(ticks=ticks, wall_s=wall, max_batch=max(batches),
                rx_batches=len(batches), dpi_flagged=b.stats.dpi_flagged,
                retransmissions=a.stats.retransmissions,
                snapshots=[a.snapshot(), b.snapshot()],
                engine=[{k: v.tolist() for k, v in n.engine_counters().items()}
                        for n in (a, b)], ciphertext=ct)


def run_chain(dev, params, ct, impl):
    """Phase 4: the receive chain with an ICRC tap on one batch."""
    import torch
    from repro_torch.core.services import (AesService, CrcService,
                                           DpiService, ServiceChain)
    chain = ServiceChain(
        parallel=[CrcService(impl=impl, device=dev)],
        on_path=[AesService(key=KEY, decrypt=True, impl=impl, device=dev)],
        parallel_after=[DpiService(params=params, impl=impl, device=dev)])
    pay = torch.from_numpy(ct.reshape(-1, MTU)).to(dev)
    plen = torch.full((pay.shape[0],), MTU, dtype=torch.int32, device=dev)
    out, flags = chain.process(pay, plen)
    torch.cuda.synchronize()
    return out, flags


def phase_incast(dev) -> dict:
    from repro_torch.core.netsim import dcqcn_fabric_profile, incast_scenario
    rows = json.loads((ROOT / "BENCH_fig6_multipath.json").read_text())
    want = next(r for r in rows["incast_cc"]
                if r["fan_in"] == 8 and r["cc"] == "ack_clocked")
    t0 = time.perf_counter()
    res = incast_scenario(8, message_bytes=want["message_bytes"],
                          fabric_cfg=dcqcn_fabric_profile(),
                          congestion_control="ack_clocked", device=dev)
    wall = time.perf_counter() - t0
    hot = res.fabric.port_stats[0]
    got = {"ticks": res.ticks, "tail_dropped": hot.tail_dropped,
           "ecn_marked": hot.ecn_marked, "max_queue": hot.max_depth,
           "retransmissions": sum(s.stats.retransmissions
                                  for s in res.senders),
           "cnp_tx": res.receiver.stats.cnp_tx,
           "cnp_rx": sum(s.stats.cnp_rx for s in res.senders)}
    assert got == {k: want[k] for k in got}, (got, want)
    for i, d in enumerate(res.payloads):
        assert (res.receiver._qp_buffer[i + 1][1][:len(d)] == d).all()
    print(f"[incast] 8:1 ack_clocked on {dev}: {got} == "
          f"BENCH_fig6_multipath.json, wall_s={wall:.2f}")
    return got


def main() -> int:
    if not (SRC / "repro_torch").is_dir():
        print("chip_smoke.py: the port's sources (src/repro_torch) are not "
              "beside this script", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    from repro_torch.data import load_dpi_params_seed0
    from repro_torch.kernels import ops

    # fp32 products stay fp32 in the plain versions and the yardstick
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    t_start = time.perf_counter()
    smi = phase_device()
    phase_build()
    params = load_dpi_params_seed0()
    kern = phase_kernels(dev, params)

    data = _traffic()
    # ---- each path with the kernels, counters from 0 around each --------
    ops.reset_launches()
    main_k = run_main_path(dev, params, data, impl=None)
    on_main = ops.launches()
    ops.reset_launches()
    chain_k = run_chain(dev, params, main_k["ciphertext"], impl=None)
    on_chain = ops.launches()
    # ---- the same with the plain versions -------------------------------
    ops.reset_launches()
    main_p = run_main_path(dev, params, data, impl="ref")
    chain_p = run_chain(dev, params, main_p["ciphertext"], impl="ref")
    assert not any(ops.launches().values()), "the plain arm launched a kernel"

    for k in ("ticks", "max_batch", "rx_batches", "dpi_flagged",
              "retransmissions", "snapshots", "engine"):
        assert main_k[k] == main_p[k], f"main path: {k} differs between " \
            f"kernels ({main_k[k]}) and plain versions ({main_p[k]})"
    assert (main_k["ciphertext"] == main_p["ciphertext"]).all()
    assert main_k["dpi_flagged"] > 0, "DPI flagged nothing"
    print(f"[main] {N_QPS} QPs x {MSG_BYTES} B: all bytes delivered, "
          f"ticks={main_k['ticks']} max_rx_batch={main_k['max_batch']} "
          f"rx_batches={main_k['rx_batches']} "
          f"dpi_flagged={main_k['dpi_flagged']} "
          f"retransmissions={main_k['retransmissions']} "
          f"wall_s kernels={main_k['wall_s']:.2f} "
          f"plain={main_p['wall_s']:.2f}; equal between arms")
    assert torch.equal(chain_k[0], chain_p[0]), "chain payload differs"
    assert torch.equal(chain_k[1], chain_p[1]), "chain flags differ"
    assert bool((chain_k[1] & 2).any()), "chain: DPI flagged nothing"
    print(f"[chain] crc | aes-dec | dpi on {chain_k[0].shape[0]} packets: "
          f"payload and flags bit-exact between kernels and plain versions")
    print(f"[main] kernel launches on the main path: {on_main}")
    print(f"[chain] kernel launches on the ICRC chain: {on_chain}")
    for name in ("aes_ecb", "dpi_mlp"):
        assert on_main[name] > 0, f"kernel {name} was not launched on the " \
            "main path"
    for name, n in on_chain.items():
        assert n > 0, f"kernel {name} was not launched on the ICRC chain"

    phase_incast(dev)

    # name -> (source, TPU kernel it replaces, the path it is counted on)
    sources = {"aes_ecb": ("src/repro_torch/csrc/aes_ecb.cu",
                           "src/repro/kernels/aes_ecb.py:69", "main"),
               "crc32": ("src/repro_torch/csrc/crc32.cu",
                         "src/repro/kernels/crc32.py:58", "icrc_chain"),
               "dpi_mlp": ("src/repro_torch/csrc/dpi_mlp.cu",
                           "src/repro/kernels/dpi_mlp.py:48", "main")}
    counts = {"main": on_main, "icrc_chain": on_chain}
    print(f"[done] {smi}; total wall_s={time.perf_counter() - t_start:.1f}")
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "path": path, "launches": counts[path][name],
         "launches_by_path": {p: c[name] for p, c in counts.items()},
         **kern[name]}
        for name, (src, rep, path) in sources.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
