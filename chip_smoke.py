#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py

Builds the port's hand-written Hopper kernels from ``src/repro_torch/
csrc`` and drives four paths of the system: the service-enhanced RDMA
datapath (paper Fig. 1), the §8 streaming ingest into a full-size DLRM,
the allreduce fabric, and the §8 ingest of encrypted shards that trains
the DLRM; then the telemetry plane and the fused epoch core,
data-parallel DLRM training over the allreduce, the host-sync
census, the LM model stack's serving and training paths, the mesh
layer, and the DPI model's training, the sharded landing zone and the
elastic checkpoint restore.

  0. device   the card's name and power limit (nvidia-smi)
  1. build    nvcc, one process per kernel source, all at once; each
              kernel function's registers, shared memory and spills
              from ptxas's report; the fold's, preprocessing's, CRC's
              and fused epoch's SASS (cuobjdump): instructions,
              innermost loop, subroutines, local-memory instructions,
              shared/global/generic loads and stores, warp syncs,
              ballots and convergence barriers
  2. kernels  AES-128-ECB, CRC32, the DPI MLP, the DLRM preprocessing,
              the segmented reduce and the fused decrypt+DPI pass at
              main-path sizes against their plain PyTorch versions on
              the card.  A kernel's ``ms`` is
              its device time from a torch.profiler trace (median
              launch; CUDA events around back-to-back calls if the
              trace holds no device time), ``call_ms`` the wrapper's
              whole call by CUDA events.  CRC32 is checked against zlib
              on every packet and timed L2 cold (``ms``: a rotation of
              payload copies larger than the L2) and warm (back to back
              on one 32 MiB batch, which the 50 MB L2 can hold).  Also:
              the segmented reduce and torch.sum in turns; the
              preprocessing tile beside a one-element PyTorch add (the
              launch floor)
  3. main     256 QPs x 128 KiB (one 8192-packet, 32 MiB receive batch)
              RDMA-written across a lossy link by two RdmaNodes; the
              sender encrypts, the receiver decrypts on-path and runs DPI
              on the parallel path.  Run with the kernels, then with the
              plain versions: every byte must land and the two runs must
              agree on every tick and counter; prints the beats of each
              DPI kernel launch and the blocks of each AES launch, and
              times AES and DPI at each of those sizes, CRC32 at its RX
              batches and the chain's batch, the fused kernel at
              launches of a few hundred tiles, and the fold and the
              preprocessing at the shapes phases 6-8 launch them at
  4. chain    the receive chain with an ICRC tap on one 8192-packet batch
              of that traffic, kernels against plain versions, bit-exact;
              the tap's (CrcService) whole call timed by CUDA events
  5. incast   the 8:1 ack-clocked incast on the card reproduces the row
              of BENCH_fig6_multipath.json exactly
  6. ingest   (a) the BENCH_fig10_dlrm.json smoke rows (sync, streamed
              over 1 and 4 replicas) reproduced exactly on the card;
              (b) full size: 1 MiB shards (6656 records) striped over
              4 replicas x 2 QPs, each 2-packet tile preprocessed by the
              kernel as it lands, every landed batch scored by the
              full-config DLRM (26 tables of 100,000 x 64), with the
              kernels and with the plain versions; (c) one shard with
              the preprocessing on-path in the RX pipeline instead
  7. allreduce (a) the BENCH_fig11_allreduce.json 4-node smoke rows
              reproduced exactly; (b) full size: 4 ranks allreduce the
              DLRM's 499,521 dense-MLP parameters as float32, ring and
              in-fabric offload, with the kernels and with the plain
              versions, bit-identical to the oracle
  8. secure   full size, as 6b, but the replicas hold every shard
              AES-128-ECB encrypted at rest: each tile goes through the
              fused decrypt+DPI kernel, then the preprocessing kernel on
              the plaintext, and every landed batch trains the full-config
              DLRM for 5 SGD steps at lr 0.05 (examples/dlrm_ingest.py's
              trainer), with the kernels and with the plain versions from
              the same seeded weights: equal reports, landed words and DPI
              flags, and the loss falls on every shard
  9. fused    (0) the kernel's device time (CUDA events behind a sleep
              on the card) on the first epoch of fig6, fig11, 6b at
              window 16 and 7b, in each instantiation; the SM clock
              before and after the phase;
              (a) BENCH_fig6_multipath.json's traced_incast (8:1 Clos,
              spine failure) through the port's telemetry ``instrument``:
              flat() equals the row (386 keys), 31 ticks, 745 trace
              events, the Chrome trace byte-identical to the same run on
              the CPU; (b) the committed fused rows in fused epochs, each
              beside its tick arm: fig6's fused_epoch_equivalence (4:1,
              32 KiB), fig10's streamed_fused r4, fig11's fused ring, every
              epoch's output blob bit-identical to epoch_ref on a CPU copy
              of its input; the host<->card transfers of a fused epoch
              counted at the tensor API; (c) full width: 6b's ingest (at its
              window, and at a window of 16, whose worlds fuse) and 7b's
              ring in fused epochs, equal to their tick arms, the first 3
              epochs of each held against epoch_ref; epochs, ticks per
              epoch, refusals, the kernel instantiation each epoch ran
              (the blob in shared memory or in device memory), its serial
              events and latency bound, the kernel's call time per epoch
              and per tick (CUDA events) and the walls
 10. exchange (a) ``repro_torch.examples.allreduce_dlrm`` as the
              reference runs it: the smoke DLRM, 4 workers x 64 records,
              8 steps, each worker's gradient exchanged by the offloaded
              allreduce, every sum bit-identical to the oracle, the
              parameters bit-identical to the oracle fold, the loss
              falling; (b) full width: the ``config()`` DLRM's
              166,899,521-f32 gradients of 4 workers exchanged by the
              fused ring in 80 buckets of at most 2,097,152 f32
              (``allreduce_bucketed``), joined bit-identical to the
              oracle of the whole gradients for every rank, no fused
              epoch refused or aborted (a refusal raises), one or two
              steps; epochs, ``fused_epoch`` call time, the host's share
              (``try_pack``, ``_apply``, folds, gradient copies) and the
              wall of each step
 11. census   ``repro_torch.analysis.census.run_census`` on the card and
              on the CPU, beside BENCH_sync_census.json: equal ticks,
              and every call site whose count differs listed
 12. lm       the LM model stack served (no hand-written kernel on this
              path): (a) every smoke arch of ``repro_torch.configs`` at
              float32, weights drawn once on the CPU, ``serve_batch`` on
              the card (batch 2, prompt 24, 8 new tokens): the CPU's
              greedy tokens, prefill and decode logits within 1e-4;
              then ``repro_torch.examples.serve.main()`` on the card at
              bf16; (b) gemma2-2b's full ``config()`` (2,614,341,888
              parameters) served at the reference's defaults (batch 4,
              prompt 32, 16 tokens, bf16): init, prefill and decode
              times, tok/s, peak memory, and the peak of one decode
              step on a cache of 48 (the statistics reset around it);
              at float32 decode equals the
              forward within 2e-3 on all 26 layers, and a 2-layer
              truncation of it agrees between card and CPU within 1e-3
 13. train    LM training (no hand-written kernel on this path): (a)
              ``repro_torch.examples.quickstart.main`` on the card
              (gemma2-2b smoke, 120 steps, checkpoints in a temp
              directory): the loss falls; then the smoke Trainer crashes
              at step 6 and resumes from step 4 on the card; (b)
              gemma2-2b's full ``config()`` (f32 parameters, bf16
              compute, AdamW, remat on) trains 3 steps on one batch of
              2 x 1024 tokens at lr 1e-4: a finite loss that falls step
              to step; each step's ms, tokens/s and peak memory; a
              fourth step traced in its halves (forward+backward, the
              optimizer) for the card's busy share; and one float32 step
              of a 2-layer truncation on the card and on the CPU from
              the same weights: loss, new parameters and AdamW slots
              within stated tolerances
 14. mesh     the mesh layer (no hand-written kernel on this path): (a)
              ``python -m repro_torch.launch.dryrun --arch gemma2-2b
              --shape train_4k`` in a subprocess (its ``fake`` world of
              512 ranks must not meet this process's NCCL one), one
              rank's share of the step walked as DTensors: ``ok``, the
              reference's per-device argument bytes (384,748,552) and
              alias bytes (384,224,260) exactly, its two fallbacks, its
              partition's dot FLOPs within 10 % and collective traffic
              within 2x (committed: the card machine has no JAX); the
              three H100 roofline terms printed; beside it, each in a
              process of its own, granite-3-2b x train_4k and
              deepseek-v3-671b x decode_32k (the MoE's flat branch)
              and gemma2-27b x long_500k (queries and cache sequence
              both over "model") held to their reference partitions
              (DRYRUN_GQA_REF, DRYRUN_MOE_REF, DRYRUN_LONG_REF: memory
              exact, every kind's elements within 1 %, dot FLOPs within
              10 %, 1 % and 1 %, no op replicated), and so xlstm-125m x
              train_4k, gemma2-27b x train_4k and deepseek-v3-671b x
              prefill_32k (DRYRUN_XLSTM_REF, DRYRUN_GEMMA_REF,
              DRYRUN_MLA_REF: dot FLOPs within 1 %), and on the
              2x16x16 mesh gemma2-2b x train_4k (DRYRUN_POD_REF: the
              same, its two fallbacks), whisper-base x train_4k (each
              norm's gradient reduced once in the backward;
              DRYRUN_POD_WHISPER_REF, its three fallbacks) and gemma2-27b
              x long_500k (the queries gathered by way of "pod" x
              "data"; DRYRUN_POD_LONG_REF), and deepseek-v3-671b x
              decode_32k and prefill_32k (the MoE on a batch over "pod" x
              "data"; DRYRUN_POD_MOE_DECODE_REF,
              DRYRUN_POD_MOE_PREFILL_REF, the prefill's one fallback)
              and train_4k (the router over "pod" x "model", the MoE
              input's gradient in the chunk loop's layout, XLA's full
              rematerialization for its norm's scale gradient;
              DRYRUN_POD_MOE_TRAIN_REF, the prefill's fallback),
              and xlstm-125m x long_500k and train_4k (the up
              projections and the sLSTM state over "pod" x "data", the
              lookup's gradient reduced once; DRYRUN_POD_XLSTM_LONG_REF,
              DRYRUN_POD_XLSTM_TRAIN_REF), and recurrentgemma-9b x
              prefill_32k (the attention mask and rotary angles on the
              rank's own rows; DRYRUN_POD_RG_PREFILL_REF, its temp
              within 1.5x);
              every train and prefill cell's temp bytes within
              DRYRUN_TEMP_FACTOR of the reference's; (b) a one-rank
              NCCL world (``make_host_mesh()``): the shard_map MoE
              (``expert_sharding="ep_sm"``, deepseek-v3 smoke, float32,
              4 x 4096 tokens) forward and gradients against the card's
              no-mesh path within 1e-5, 2 all-to-alls and 1 all-reduce
              made a chunk; ``repro_torch.launch.train --smoke
              --steps 20`` (granite-3-2b) on that mesh, its losses equal
              to the same Trainer without a mesh; (c) the dry run's
              per-device argument bytes of gemma2-2b at phase 13b's batch
              (2 x 1024, AdamW, a one-card mesh) at or below the
              ``max_memory_allocated`` phase 13b measured; the dry run's
              walk of that step and of 12b's decode step on a mesh of
              one device (a process of its own, ``start_memory_walks``):
              its ``peak_bytes`` within 5 % of 13b's and of the decode
              step's ``max_memory_allocated``
 15. placement DPI training, the sharded landing zone and the elastic
              restore: (a) ``train_dpi_params(make_dataset(2048,
              seed=0), steps=200)`` on the card against the CPU from the
              same CPU-generator weights (worst float error before
              ternarization within 1e-5 of each leaf's largest
              magnitude, ternary entries that differ, walls), the card's
              weights scoring ``make_dataset(512, seed=2)`` through the
              DPI kernel above 0.85, then
              ``repro_torch.examples.secure_flow.main`` on the card,
              which trains the same weights and flags the malicious
              flow; on an NCCL world of one: (b) 6b's first shard
              landed in a zone sharded ("data", None), its
              ``full_tensor()`` bit-equal to the unsharded zone; (c)
              gemma2-2b's full ``config()`` parameters (float32, 10.46
              GB, the weights 13b starts from) written once and restored
              by the train rules on the mesh of one, every leaf a
              ``DTensor`` bit-equal to what was written; walls

Seventeen paths are driven through the kernels, each with the launch
counters set to 0 just before it and read just after it: the main path
(phase 3, kernel arm: AES, DPI), the ICRC chain (phase 4: all three
services), ingest (6b, kernel arm, its warm-up tile included: preproc),
ingest_onpath (6c: preproc), allreduce_ring and allreduce_offload (7b,
kernel arms: reduce_fold), secure_ingest (8, kernel arm, its warm-up
tile included: fused decrypt+DPI, preproc), and in phase 9 fig6_fused,
fig10_fused, fig11_fused, ingest_fused, ingest_fused_w16 and
allreduce_ring_fused (fused_epoch, and the kernels each path runs), and
in phase 10 dlrm_exchange (reduce_fold) and dlrm_exchange_full
(fused_epoch, reduce_fold), and in phase 15 secure_flow_trained (the
example with its trained inspector: AES, DPI) and ingest_sharded (15b:
preproc). Each
path prints the shapes of its fold and preprocessing launches. The line
before the last is a JSON object with every kernel's path, launches on
that path (and on each path apart), error, time, plain time, bound and
library time; the last line is the run's verdict. Any failure raises, so
the script exits non-zero and prints no verdict; it also exits non-zero,
printing nothing, without a CUDA device or without the port's sources
beside it.

    python3 chip_smoke.py --mesh DATA MODEL

runs the mesh layer across DATA x MODEL cards, one process a card, in an
NCCL world: on ``make_host_mesh(DATA, MODEL)`` the shard_map MoE of
phase 14b against each card's no-mesh path (forward, gradients, the
collectives called, fwd+bwd wall), then a data-parallel ``Trainer`` on
``make_host_mesh(data=DATA x MODEL)`` against one process on one card
(losses); then phase 6b's first shard landed over "data" of a
(DATA x MODEL, 1) mesh on every card (each block bit-equal to rank 0's
unsharded rows; tiles decoded against landed), gemma2-2b's full
parameters written once by rank 0 and restored by the train rules on
(DATA, MODEL) and (DATA x MODEL, 1) meshes (every block bit-equal to
the file's slice; bytes resident a card), and a save from the (DATA,
MODEL) ``DTensor``s byte-identical to rank 0's file; one JSON line of
every rank's results.

    python3 chip_smoke.py --launch-sizes [SRC]

times the kernels of the ``repro_torch`` under SRC (default ``src``) at
the paths' launch sizes, and the fused epoch kernel on the phase-9
worlds' first epochs, and prints them, with the card, its SM clock
before and after and the SASS summary, as one JSON line: run on a parent
tree unpacked under ``build/`` and on this one in turns (parent, change,
change, parent) in one call, it compares the two on one card.
"""
import atexit
import contextlib
import itertools
import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
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
# DLRM records (paper §8): 13 dense + 26 sparse int32 words, 26 whole
# records per 4 KiB packet; the full config's Modulus range
N_DENSE, N_SPARSE, MOD = 13, 26, 100_000
REC_W = N_DENSE + N_SPARSE
RPP = (MTU // 4) // REC_W                             # 26 records / packet
SHARD_PKTS = (1 << 20) // MTU                         # IngestConfig default
# full-size shards in 6b: from the third shard on, this striping (two
# QPs per replica on one shaped link) hits the reference's duplicate-
# READ fault, kept bit for bit by the port (ROADMAP.md section 3,
# tests/test_torch_ingest.py::test_duplicate_read_fault_is_the_references),
# and lands the previous shard's bytes on the second QP of each replica
N_SHARDS = 2
LOGIT_RTOL = LOGIT_ATOL = 1e-5
# phase 8 trains as examples/dlrm_ingest.py does: 5 SGD steps per shard.
# Between the arms the losses may differ only by the order of the
# embedding gradient's atomic adds on the card
SGD_STEPS, SGD_LR = 5, 0.05
LOSS_RTOL, LOSS_ATOL = 1e-5, 1e-6
DPI_THRESHOLD = 1.0             # DpiService's flag threshold
ALLREDUCE_ELEMS = 154_944 + 344_577     # full DLRM's dense-MLP parameters

# H100 SXM data-sheet peaks (dense), and its L2 cache
HBM_BYTES_PER_S = 3.35e12
L2_BYTES = 50e6
FP32_FLOPS = 67e12
INT8_OPS = 1979e12
BF16_FLOPS = 989e12
# shared-memory table lookups: one 32-lane wavefront an SM a cycle, at the
# data sheet's 132 SMs and 1.98 GHz boost clock (the clock of the fp32
# figure: 132 x 128 lanes x 2 x 1.98 GHz = 67 TFLOP/s).  The kernels'
# AES design makes 160 a 16-byte block (16 bytes x 10 rounds); AES needs
# none (a bitsliced body makes no lookups), so they bound the design
# (``bound_design_ms``), not the function (``bound_ms``)
SMEM_LOOKUPS_PER_S = 132 * 32 * 1.98e9
AES_LOOKUPS = 16 * 10
# the fused kernel at launches of a few hundred tiles (4 a 4 KiB packet):
# 264 and 268 tiles paired, 1056 the last paired, 1060 the first unpaired
# on an H100's 132 SMs x 16 warps; and the secure ingest's 2-packet tile
FUSED_PKTS = (2, 66, 67, 264, 265)


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


def _trace(calls, reps: int):
    """One torch.profiler trace of ``reps`` turns of ``calls``, a list of
    (key, fn) called in that order each turn, after one warm-up turn.
    Returns key -> the device ms of each call in order (the CUDA kernel
    events whose name holds key), or None if a key's events are not one a
    call (a trace that holds no device time)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _, fn in calls:
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            for _, fn in calls:
                fn()
        torch.cuda.synchronize()
    events = sorted((e for e in prof.events()
                     if e.device_type == torch.autograd.DeviceType.CUDA
                     and e.time_range.elapsed_us() > 0),
                    key=lambda e: e.time_range.start)
    out = {}
    for key in dict(calls):
        times = [e.time_range.elapsed_us() / 1e3 for e in events
                 if key in e.name]
        want = reps * sum(k == key for k, _ in calls)
        if len(times) != want:
            print(f"[trace] {key}: {len(times)} kernel events, {want} "
                  "calls", file=sys.stderr)
            return None
        out[key] = times
    return out


def _traced_medians(calls, reps: int, tries: int = 3):
    """key -> the median device ms of ``_trace(calls, reps)``, taking the
    trace again (up to ``tries`` times) when its kernel events do not
    match the calls; None if none did."""
    for _ in range(tries):
        times = _trace(calls, reps)
        if times is not None:
            return {k: statistics.median(v) for k, v in times.items()}
    return None


def _kernel_ms(fn, kernel: str, reps: int):
    """Device time of one launch of the CUDA kernel whose name holds
    ``kernel``: the median over ``reps`` launches in a torch.profiler
    trace, so host work in the wrapper is not counted.  Returns (ms,
    "profiler"), or (ms, "events") from ``_median_ms`` over bursts of 10
    calls when no trace holds the kernel's device time."""
    times = _traced_medians([(kernel, fn)], reps)
    if times is not None:
        return times[kernel], "profiler"
    return _median_ms(fn, 5, burst=10), "events"


def _rotation(fn_of, x):
    """A call of ``fn_of`` on the next of a rotation of copies of ``x``
    that together hold more than twice the L2 cache, so that each call
    reads its input from device memory ("cold"), not from the L2."""
    n = max(2, math.ceil(2 * L2_BYTES / (x.numel() * x.element_size())))
    bufs = [x] + [x.clone() for _ in range(n - 1)]
    turn = itertools.count()
    return lambda: fn_of(bufs[next(turn) % n])


def _bound_ms(n_bytes: float, flops: float = 0.0, *, int8_ops: float = 0.0,
              bf16_flops: float = 0.0, lookups: float = 0.0):
    """The largest of the bytes' time at the memory rate and the time of
    each unit's operations at its peak: fp32 FLOPs on the CUDA cores, int8
    and bf16 work together on the tensor cores, shared-memory table
    lookups.  The units run side by side, so their times do not add."""
    by_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    by_ops = max(flops / FP32_FLOPS,
                 int8_ops / INT8_OPS + bf16_flops / BF16_FLOPS,
                 lookups / SMEM_LOOKUPS_PER_S) * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops,
                                                            "operations")


# the DPI MLP's operations per beat in the kernels' design (csrc/
# dpi_mma.cuh): layer 1 in int8 (64 x 128 MACs), layer 2 as three bf16
# passes (3 x 128 x 64 MACs), layer 3 in fp32 (64 MACs); and the fp32 MLP
# that the plain version and the earlier kernels run (16,448 MACs)
DPI_INT8_OPS = 2 * 64 * 128
DPI_BF16_FLOPS = 3 * 2 * 128 * 64
DPI_FP32_FLOPS = 2 * 64
DPI_FP32_MLP_FLOPS = 2 * (64 * 128 + 128 * 64 + 64)


def _dpi_bounds(n_bytes: float, beats: int, lookups: float = 0.0):
    """(bound_ms, bound_by, bound_fp32_ms) of a DPI pass over ``beats``
    beats that moves ``n_bytes`` (and makes ``lookups`` AES table
    lookups, which only a design bound counts)."""
    bound, by = _bound_ms(n_bytes, DPI_FP32_FLOPS * beats,
                          int8_ops=DPI_INT8_OPS * beats,
                          bf16_flops=DPI_BF16_FLOPS * beats, lookups=lookups)
    return bound, by, _bound_ms(n_bytes, DPI_FP32_MLP_FLOPS * beats)[0]


def _aes_copies() -> int:
    """kCopies, the table copies of ``csrc/aes_round.cuh``, from the
    header."""
    src = (SRC / "repro_torch/csrc/aes_round.cuh").read_text()
    return int(re.search(r"constexpr int kCopies = (\d+);", src).group(1))


def phase_device() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(out)
    return out


def _sm_clock_mhz() -> int:
    """The card's SM clock now (``nvidia-smi --query-gpu=clocks.sm``),
    MHz."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    return int(out)


def _ptxas(log: str) -> list:
    """Per entry function of a ``ptxas -v`` report: its registers, static
    shared memory, stack frame and spills in bytes."""
    fields = (("registers", r"Used (\d+) registers"),
              ("smem_bytes", r"(\d+) bytes smem"),
              ("stack_bytes", r"(\d+) bytes stack frame"),
              ("spill_stores", r"(\d+) bytes spill stores"),
              ("spill_loads", r"(\d+) bytes spill loads"))
    out = []
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            out.append(dict(function=m.group(1), **{k: 0 for k, _ in fields}))
        elif out:
            for key, pat in fields:
                m = re.search(pat, line)
                if m:
                    out[-1][key] = int(m.group(1))
    return out


def _demangle(names: list) -> list:
    """C++ names through c++filt where the machine has it."""
    try:
        out = subprocess.run(["c++filt"], input="\n".join(names),
                             capture_output=True, text=True, check=True,
                             timeout=60).stdout.splitlines()
    except (OSError, subprocess.SubprocessError):
        return names
    return out if len(out) == len(names) else names


def sass_summary(so: Path, kernel: str) -> dict:
    """Per kernel function of the library whose name holds ``kernel``, from
    its SASS (``cuobjdump -sass``): the instructions; the instructions of
    its innermost loop, from the address a backward branch jumps to, up to
    and with that branch (the shortest such span); each subroutine it
    calls (such as a software division) with its instructions up to its
    RET; and its local-memory instructions (LDL, STL: spills or arrays
    indexed at run time)."""
    import shutil
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([tool, "-sass", str(so)], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    funcs, body = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            body = funcs.setdefault(m.group(1), [])
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+([^;]*?)\s*;", line)
        if m and body is not None:
            body.append((int(m.group(1), 16), m.group(2)))
    names = [n for n in funcs if kernel in n]
    out = {}
    for name, pretty in zip(names, _demangle(names)):
        ins = funcs[name]
        at = {addr: i for i, (addr, _) in enumerate(ins)}
        loops, subs = [], {}
        for i, (_, op) in enumerate(ins):
            m = re.search(r"\b(BRA|CALL)\S*\s+`?\(?(0x[0-9a-f]+)", op)
            if not m or int(m.group(2), 16) not in at:
                continue
            j = at[int(m.group(2), 16)]
            if m.group(1) == "BRA" and j < i:
                loops.append(i - j + 1)
            elif m.group(1) == "CALL":
                ret = next((k for k in range(j, len(ins))
                            if ins[k][1].split()[0].startswith("RET")), None)
                subs[m.group(2)] = None if ret is None else ret - j + 1
        local = sum(1 for _, op in ins
                    if re.search(r"(^|\s)(LDL|STL)(\.|\s|$)", op))
        ops = {}
        for _, op in ins:
            m = re.match(r"(?:@!?U?P\w+\s+)?(LDS|STS|LDG|STG|LD|ST|LDGSTS|"
                         r"WARPSYNC|VOTE|BSSY|BSYNC)(\.|\s|$)", op)
            if m:
                ops[m.group(1)] = ops.get(m.group(1), 0) + 1
        out[pretty] = dict(instructions=len(ins),
                           innermost_loop=min(loops) if loops else None,
                           calls=subs, local_memory=local, ops=ops)
    return out


def _sass_of_paths(paths: dict) -> dict:
    """``sass_summary`` of the fold, preprocessing, CRC and fused epoch
    kernels that the paths launch (every preproc_kernel, crc32_kernel
    and fused_epoch_kernel; reduce_fold_kernel at K = 2, 3 and 4),
    source name -> function -> summary; empty where the machine has no
    cuobjdump."""
    out = {}
    for name, kernel in (("reduce", "reduce_fold_kernel"),
                         ("preproc", "preproc_kernel"),
                         ("crc32", "crc32_kernel"),
                         ("fused_epoch", "fused_epoch_kernel")):
        try:
            funcs = sass_summary(paths[name], kernel)
        except (OSError, subprocess.SubprocessError) as e:
            print(f"[build] {name}: no SASS summary ({e})", file=sys.stderr)
            funcs = {}
        out[name] = {
            f: v for f, v in funcs.items()
            if not re.search(r"Add[FI]32, \d+,", f)
            or re.search(r"Add[FI]32, [234],", f)}
    return out


def phase_build() -> tuple:
    """Builds every kernel; returns source name -> its ptxas report, and
    ``_sass_of_paths``."""
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    paths = _build.build_all()
    secs = time.perf_counter() - t0
    print(f"[build] {len(paths)} kernels in {secs:.2f} s")
    reports = {}
    for name, so in paths.items():
        log = so.with_suffix(".log")
        reports[name] = _ptxas(log.read_text()) if log.exists() else []
        for f in reports[name]:
            print(f"[build] {name}: {f['function']}: {f['registers']} "
                  f"registers, {f['smem_bytes']} B static smem, "
                  f"{f['stack_bytes']} B stack, spill stores "
                  f"{f['spill_stores']} B, spill loads {f['spill_loads']} B")
    sass = _sass_of_paths(paths)
    for name, funcs in sass.items():
        for f, v in funcs.items():
            print(f"[build] {name} SASS: {f}: {v['instructions']} "
                  f"instructions, innermost loop {v['innermost_loop']}, "
                  f"calls {v['calls']}, local-memory instructions "
                  f"{v['local_memory']}, memory and warp ops {v['ops']}")
    return reports, sass


def phase_kernels(dev, params) -> dict:
    """Each kernel against its plain version at main-path sizes."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels.crc32 import team as crc_team
    from repro_torch.kernels.crc32 import warp_lookups
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
    n_bytes = 2 * blocks.numel()
    bound, by = _bound_ms(n_bytes)
    design, design_by = _bound_ms(n_bytes,
                                  lookups=AES_LOOKUPS * blocks.shape[0])
    out["aes_ecb"] = dict(max_abs_err=err, ms=ms, ms_from=ms_from,
                          ms_encrypt=enc_ms, call_ms=call_ms,
                          plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                          bound_bytes_ms=bound, bound_design_ms=design,
                          bound_design_by=f"{design_by}: shared-memory "
                          "lookups", library_ms=None, copies=_aes_copies())
    print(f"[kernels] aes_ecb {blocks.shape[0]} blocks: bit-exact enc+dec, "
          f"decrypt kernel_ms={ms:.4f} ({ms_from}) call_ms={call_ms:.4f} "
          f"encrypt kernel_ms={enc_ms:.4f} plain_ms={plain_ms:.3f} "
          f"bound_ms={bound:.4f} ({by}) bound_bytes_ms={bound:.4f} "
          f"bound_design_ms={design:.4f} (lookups); kCopies={_aes_copies()}")

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
    pay_h, plen_h, crc_h = pay.cpu().numpy(), plen.cpu().numpy(), \
        crc.cpu().numpy()
    for i in range(N_PKTS):
        assert crc_h[i] == zlib.crc32(pay_h[i, :plen_h[i]].tobytes()), \
            f"CRC32 differs from zlib at packet {i}"
    # warm: back to back over one 32 MiB batch, which the 50 MB L2 can
    # hold; cold (``ms``, held against the bound): over a rotation of
    # copies, each launch reading its rows from device memory
    warm, warm_from = _kernel_ms(lambda: ops.crc32(pay, plen),
                                 "crc32_kernel", 20)
    ms, ms_from = _kernel_ms(_rotation(lambda p: ops.crc32(p, plen), pay),
                             "crc32_kernel", 21)
    call_ms = _median_ms(lambda: ops.crc32(pay, plen), 5, burst=10)
    plain_ms = _median_ms(lambda: ops.crc32(pay, plen, impl="ref"), 3)
    under = plen.clamp(0, MTU).long()
    n_bytes = int(under.sum()) + 4 * N_PKTS + 4 * N_PKTS
    bound, by = _bound_ms(n_bytes, 0)
    # the design's lookups: each warp lookup instruction is 32 lanes'
    # lookups, one wavefront (kernels/crc32.py:warp_lookups)
    lanes, chunk = crc_team(MTU, 16)
    lookups = 32 * warp_lookups(plen_h, MTU, 16)
    design, design_by = _bound_ms(n_bytes, lookups=lookups)
    by_lookups = lookups / SMEM_LOOKUPS_PER_S * 1e3
    out["crc32"] = dict(max_abs_err=int((crc - crc_ref).abs().max()), ms=ms,
                        ms_from=f"{ms_from}, L2 cold", ms_warm=warm,
                        ms_warm_from=warm_from, call_ms=call_ms,
                        plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                        bound_bytes_ms=bound, bound_design_ms=design,
                        bound_design_by=f"{design_by}: shared-memory "
                        "lookups", bound_lookups_ms=by_lookups,
                        lookups=lookups, team=lanes,
                        chunk_bytes=chunk, library_ms=None)
    print(f"[kernels] crc32 {N_PKTS}x{MTU} ragged ({n_bytes} B): bit-exact "
          f"vs plain and zlib on all {N_PKTS} packets, kernel_ms={ms:.4f} "
          f"({ms_from}, L2 cold) kernel_ms_warm={warm:.4f} ({warm_from}) "
          f"call_ms={call_ms:.4f} plain_ms={plain_ms:.3f} "
          f"bound_ms={bound:.4f} ({by}) bound_design_ms={design:.4f} "
          f"({design_by}; the {lookups} lookups alone {by_lookups:.4f}); "
          f"team {lanes} lanes x {chunk} B")

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
    bound, by, bound_fp32 = _dpi_bounds(pay.numel() + 4 * beats, beats)
    out["dpi_mlp"] = dict(max_abs_err=worst, ms=ms, ms_from=ms_from,
                          call_ms=call_ms, plain_ms=plain_ms, bound_ms=bound,
                          bound_by=by, bound_fp32_ms=bound_fp32,
                          library_ms=library_ms)
    print(f"[kernels] dpi_mlp {beats} beats: worst abs error {worst:.3e} "
          f"(rtol=atol={DPI_RTOL}), kernel_ms={ms:.4f} ({ms_from}) "
          f"call_ms={call_ms:.4f} plain_ms={plain_ms:.3f} library_ms={library_ms:.4f} "
          f"bound_ms={bound:.4f} ({by}) bound_fp32_ms={bound_fp32:.4f}")
    out["preproc"] = _kernel_preproc(dev, gen)
    out["reduce_fold"] = _kernel_reduce(dev, gen)
    out["fused_decrypt_dpi"] = _kernel_fused(dev, gen, tparams)
    return out


def _secure_key():
    """The at-rest AES key of the secure paths: 16 bytes from a seeded
    torch.Generator."""
    import torch
    return torch.randint(0, 256, (16,), dtype=torch.uint8,
                         generator=torch.Generator().manual_seed(8)).numpy()


def _kernel_fused(dev, gen, tparams) -> dict:
    """The fused decrypt+DPI pass at the main path's batch (8192 packets
    x 4 KiB, 32 MiB): plaintext bit-exact and scores within 1e-5 against
    the plain version; an encrypt -> fused-decrypt round trip; a packet
    count that is not a multiple of BLOCK_N; the tile entry (a full and
    a short final tile) against the one-shot rows.  Timed beside the
    port's own two-kernel chain (aes_ecb decrypt, then dpi_mlp) on the
    same bytes."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels.fused_chain import (BLOCK_N, fused_decrypt_dpi,
                                                 fused_decrypt_dpi_tile)
    rk = torch.as_tensor(ops.expand_key(_secure_key())).to(dev)
    pay = torch.randint(0, 256, (N_PKTS, MTU), generator=gen, device=dev,
                        dtype=torch.uint8)
    plain, scores = fused_decrypt_dpi(pay, rk, tparams)
    wplain, wscores = fused_decrypt_dpi(pay, rk, tparams, impl="ref")
    torch.cuda.synchronize()
    assert torch.equal(plain, wplain), "fused: plaintext differs from plain"
    worst = float((scores - wscores).abs().max())
    torch.testing.assert_close(scores, wscores, rtol=DPI_RTOL, atol=DPI_ATOL)
    back, _ = fused_decrypt_dpi(
        ops.aes_ecb(pay.reshape(-1, 16), rk).reshape(N_PKTS, MTU), rk,
        tparams)
    ragged = N_PKTS // 8 + 3
    assert ragged % BLOCK_N
    r_plain, r_scores = fused_decrypt_dpi(pay[:ragged], rk, tparams)
    t_full = fused_decrypt_dpi_tile(pay[:2], rk, tparams, tile_pkts=2)
    t_short = fused_decrypt_dpi_tile(pay[2:3], rk, tparams, tile_pkts=2)
    torch.cuda.synchronize()
    assert torch.equal(back, pay), "fused: encrypt -> decrypt round trip"
    assert torch.equal(r_plain, plain[:ragged]) and \
        torch.equal(r_scores, scores[:ragged]), f"fused: {ragged} packets"
    for (tp, ts), lo, hi in ((t_full, 0, 2), (t_short, 2, 3)):
        assert torch.equal(tp, plain[lo:hi]) and \
            torch.equal(ts, scores[lo:hi]), f"fused: tile [{lo}, {hi})"
    # one device MLP for both kernels: the same bits per beat
    assert torch.equal(scores, ops.dpi_scores(plain, tparams).amax(dim=1)), \
        "fused: scores differ from dpi_mlp's max over the plaintext"
    fn = lambda: fused_decrypt_dpi(pay, rk, tparams)  # noqa: E731
    ms, ms_from = _kernel_ms(fn, "fused_chain_kernel", 10)
    call_ms = _median_ms(fn, 5, burst=5)
    plain_ms = _median_ms(
        lambda: fused_decrypt_dpi(pay, rk, tparams, impl="ref"), 3)
    # the launch phase 8 makes: one 2-packet tile
    tile_ms, tile_from = _kernel_ms(lambda: fused_decrypt_dpi_tile(
        pay[:2], rk, tparams, tile_pkts=2), "fused_chain_kernel", 20)
    # the yardstick this kernel exists to beat: the port's two kernels,
    # in turns with it in one trace
    blocks = pay.reshape(-1, 16)
    turns = _traced_medians(
        [("fused_chain_kernel", fn),
         ("aes_ecb_kernel", lambda: ops.aes_ecb(blocks, rk, decrypt=True)),
         ("dpi_mlp_kernel", lambda: ops.dpi_scores(plain, tparams))], 10)
    if turns is None:
        raise RuntimeError("fused: no trace of the kernel and its chain")
    turn_ms, aes_ms = turns["fused_chain_kernel"], turns["aes_ecb_kernel"]
    dpi_ms = turns["dpi_mlp_kernel"]
    chain_call_ms = _median_ms(lambda: ops.dpi_scores(ops.aes_ecb(
        blocks, rk, decrypt=True).reshape(N_PKTS, MTU), tparams).amax(dim=1),
        5, burst=5)
    beats = pay.numel() // 64
    n_bytes = 2 * pay.numel() + 4 * N_PKTS
    bound, by, bound_fp32 = _dpi_bounds(n_bytes, beats)
    design, design_by, _ = _dpi_bounds(
        n_bytes, beats, lookups=AES_LOOKUPS * pay.numel() // 16)
    bound_bytes = _bound_ms(n_bytes)[0]
    print(f"[kernels] fused_decrypt_dpi {N_PKTS}x{MTU} ({pay.numel()} B): "
          f"plaintext bit-exact, scores worst abs error {worst:.3e} "
          f"(rtol=atol={DPI_RTOL}), round trip, {ragged} packets and tiles "
          f"equal; kernel_ms={ms:.4f} ({ms_from}) call_ms={call_ms:.4f} "
          f"plain_ms={plain_ms:.3f}; in turns in one trace: kernel_ms="
          f"{turn_ms:.4f}, two-kernel chain kernel_ms={aes_ms + dpi_ms:.4f} "
          f"(aes decrypt {aes_ms:.4f} + dpi {dpi_ms:.4f}); chain call_ms="
          f"{chain_call_ms:.4f} 2-packet tile kernel_ms={tile_ms:.4f} "
          f"({tile_from}) bound_ms={bound:.4f} ({by}) "
          f"bound_bytes_ms={bound_bytes:.4f} bound_fp32_ms={bound_fp32:.4f} "
          f"bound_design_ms={design:.4f} ({design_by}, with the AES "
          f"lookups); kCopies={_aes_copies()}")
    return dict(max_abs_err=worst, ms=ms, ms_from=ms_from, call_ms=call_ms,
                plain_ms=plain_ms, tile_ms=tile_ms, tile_ms_from=tile_from,
                ms_in_turns=turn_ms, chain_ms=aes_ms + dpi_ms,
                chain_call_ms=chain_call_ms, bound_ms=bound, bound_by=by,
                bound_bytes_ms=bound_bytes, bound_fp32_ms=bound_fp32,
                bound_design_ms=design,
                bound_design_by=f"{design_by}: MLP on the tensor cores, "
                "AES lookups in shared memory, the larger",
                library_ms=None, copies=_aes_copies())


def _dense_ulps(got, want) -> int:
    """Worst ulp distance between two (M, rec_w) preprocessed record
    matrices' dense words (non-negative float32, so the distance is the
    difference of their bit patterns)."""
    return int((got[:, :N_DENSE].long() - want[:, :N_DENSE].long())
               .abs().max()) if got.numel() else 0


def _kernel_preproc(dev, gen) -> dict:
    """DLRM preprocessing at the on-path batch of the main path (8192
    packets = 212,992 records) and at the tile shape (one 2-packet
    fragment tile, 52 records read in place from the packet matrix).
    Dense <= 1 ulp against plain, sparse bit-exact."""
    import torch
    from repro_torch.data import synthetic as syn
    from repro_torch.kernels import ops
    n_rec = N_PKTS * RPP
    raw = torch.from_numpy(syn.dlrm_shard(0, n_rec, N_DENSE,
                                          N_SPARSE)).to(dev)
    # full int32 range for the floor-mod: negatives, INT32_MIN/MAX
    full = torch.randint(-2**31, 2**31, (n_rec, REC_W), generator=gen,
                         device=dev, dtype=torch.int64).to(torch.int32)
    full[0, N_DENSE:N_DENSE + 2] = torch.tensor([-2**31, 2**31 - 1],
                                                dtype=torch.int32)
    tile = torch.from_numpy(np.frombuffer(syn.encode_dlrm_packets(
        syn.dlrm_shard(1, 2 * RPP, N_DENSE, N_SPARSE)).tobytes(),
        np.int32).reshape(2, MTU // 4).copy()).to(dev)[:, :RPP * REC_W]
    worst = 0
    for name, recs, kw in (("batch", raw, {}), ("full-range", full, {}),
                           ("tile", tile, {"rec_w": REC_W})):
        got = ops.preproc(recs, N_DENSE, MOD, **kw)
        want = ops.preproc(recs, N_DENSE, MOD, impl="ref", **kw)
        torch.cuda.synchronize()
        assert got.shape == want.shape, name
        assert torch.equal(got[:, N_DENSE:], want[:, N_DENSE:]), \
            f"preproc {name}: sparse differs from plain"
        ulps = _dense_ulps(got, want)
        assert ulps <= 1, f"preproc {name}: dense {ulps} ulp from plain"
        worst = max(worst, ulps)
    fn = lambda: ops.preproc(raw, N_DENSE, MOD)  # noqa: E731
    ms, ms_from = _kernel_ms(fn, "preproc_kernel", 20)
    call_ms = _median_ms(fn, 5, burst=10)
    plain_ms = _median_ms(lambda: ops.preproc(raw, N_DENSE, MOD,
                                              impl="ref"), 5)
    # the tile beside the launch floor: a one-element PyTorch add, the two
    # in turns in one trace
    one = torch.zeros(1, device=dev)
    tile_fn = lambda: ops.preproc(tile, N_DENSE, MOD, rec_w=REC_W)  # noqa: E731
    turns = _traced_medians([("preproc_kernel", tile_fn),
                             ("elementwise_kernel", lambda: one.add_(1.0))],
                            20)
    if turns is not None:
        tile_ms = turns["preproc_kernel"]
        add_ms = turns["elementwise_kernel"]
    else:
        tile_ms, add_ms = _kernel_ms(tile_fn, "preproc_kernel", 20)[0], None
    bound, by = _bound_ms(2 * raw.numel() * 4, 0)
    print(f"[kernels] preproc {n_rec}x{REC_W} i32 ({raw.numel() * 4} B) and "
          f"a {tile.shape[0] * RPP}-record tile: sparse bit-exact, dense worst "
          f"{worst} ulp vs plain, kernel_ms={ms:.4f} ({ms_from}) "
          f"call_ms={call_ms:.4f} plain_ms={plain_ms:.3f} "
          f"tile kernel_ms={tile_ms:.4f} bound_ms={bound:.4f} ({by}); "
          f"launch floor, a one-element add in the same trace: "
          f"{add_ms if add_ms is None else f'{add_ms:.4f}'} ms")
    return dict(max_abs_err=worst, err_unit="ulp (dense); sparse exact",
                ms=ms, ms_from=ms_from, call_ms=call_ms, plain_ms=plain_ms,
                tile_ms=tile_ms, one_element_add_ms=add_ms, bound_ms=bound,
                bound_by=by, library_ms=None)


def _kernel_reduce(dev, gen) -> dict:
    """The segmented reduce at (4, 8,388,608): 4 rows of 32 MiB, float32
    (with NaN, +-inf and -0.0 planted) and int32 (full range, so sums
    wrap).  Bit-exact against plain."""
    import torch
    from repro_torch.kernels import ops
    k, lanes = 4, 8 * 1024 * 1024
    xf = torch.randn((k, lanes), generator=gen, device=dev)
    xf[0, :4] = torch.tensor([float("nan"), float("inf"), -0.0, 1.0])
    xf[1, :4] = torch.tensor([1.0, float("-inf"), -0.0, float("inf")])
    xi = torch.randint(-2**31, 2**31, (k, lanes), generator=gen, device=dev,
                       dtype=torch.int64).to(torch.int32)
    for name, x in (("float32", xf), ("int32", xi)):
        got = ops.reduce_fold(x)
        want = ops.reduce_fold(x, impl="ref")
        torch.cuda.synchronize()
        assert torch.equal(got.view(torch.int32), want.view(torch.int32)), \
            f"reduce_fold {name}: bits differ from plain"
    ms, ms_from = _kernel_ms(lambda: ops.reduce_fold(xf),
                             "reduce_fold_kernel", 20)
    ms_i32, _ = _kernel_ms(lambda: ops.reduce_fold(xi),
                           "reduce_fold_kernel", 20)
    call_ms = _median_ms(lambda: ops.reduce_fold(xf), 5, burst=10)
    plain_ms = _median_ms(lambda: ops.reduce_fold(xf, impl="ref"), 5)
    # the library yardstick: one torch.sum over the int32 rows (the same
    # function for int32; for float32 its summation order differs), timed
    # in turns with the kernel on the same rows: library, kernel, kernel,
    # library, 5 rounds
    alt = _reduce_against_sum(xi)
    bound, by = _bound_ms((k + 1) * lanes * 4, 0)
    print(f"[kernels] reduce_fold ({k}, {lanes}) f32 and i32: bit-exact vs "
          f"plain (NaN/inf/-0.0, int32 wrap), kernel_ms f32={ms:.4f} "
          f"({ms_from}) i32={ms_i32:.4f} call_ms={call_ms:.4f} "
          f"plain_ms={plain_ms:.3f} bound_ms={bound:.4f} ({by}); in turns "
          f"({alt['from']}): i32 kernel median {alt['kernel_ms']:.4f} "
          f"(spread {alt['kernel_spread_ms']:.4f}), torch.sum i32 median "
          f"{alt['library_ms']:.4f} (spread {alt['library_spread_ms']:.4f})")
    return dict(max_abs_err=0, ms=ms, ms_from=ms_from, ms_int32=ms_i32,
                call_ms=call_ms, plain_ms=plain_ms, bound_ms=bound,
                bound_by=by, library_ms=alt["library_ms"], against_sum=alt)


def _reduce_against_sum(xi, rounds: int = 5) -> dict:
    """reduce_fold and torch.sum on the same int32 rows in turns: library,
    kernel, kernel, library, ``rounds`` times; device times from one
    trace (CUDA events over bursts of 10 calls, in the same turns, if the
    trace holds none).  Medians and spreads (max - min) in ms."""
    import torch
    from repro_torch.kernels import ops
    lib = lambda: torch.sum(xi, dim=0, dtype=torch.int32)  # noqa: E731
    kern = lambda: ops.reduce_fold(xi)  # noqa: E731
    order = [("reduce_kernel", lib), ("reduce_fold_kernel", kern),
             ("reduce_fold_kernel", kern), ("reduce_kernel", lib)]
    times, how = _trace(order, rounds), "profiler"
    if times is None:
        times, how = {"reduce_kernel": [], "reduce_fold_kernel": []}, "events"
        for _ in range(rounds):
            for key, fn in order:
                times[key].append(_median_ms(fn, 1, burst=10))
    k, s = times["reduce_fold_kernel"], times["reduce_kernel"]
    return {"from": how, "rounds": rounds,
            "kernel_ms": statistics.median(k),
            "kernel_spread_ms": max(k) - min(k),
            "library_ms": statistics.median(s),
            "library_spread_ms": max(s) - min(s),
            "kernel_turns": k, "library_turns": s}


def _traffic():
    """Per QP one 128 KiB message: even QPs benign, odd QPs with 20 %
    embedded executable beats (numpy seed 0)."""
    from repro_torch.data.dpi_dataset import payload_with_embedded_malware
    rng = np.random.default_rng(0)
    return [payload_with_embedded_malware(MSG_BYTES, 0.2 if q % 2 else 0.0,
                                          rng) for q in range(N_QPS)]


class _SizesPerLaunch:
    """Records, while it is entered, the size of every call that launches
    a kernel: the beats of each DPI call, the blocks and direction of
    each AES call, the (K, L) rows of each fold with their row stride and
    whether every row starts on a 16-byte boundary, and the (rows, words)
    of each preprocessing call with its row stride.  ``ops.dpi_scores``,
    ``ops.aes_ecb``, ``ops.reduce_fold`` and ``ops.preproc``, which the
    services, collectives and tile decoders reach, are wrapped; the launch
    counters stay the kernel wrappers'."""
    NAMES = ("dpi_scores", "aes_ecb", "reduce_fold", "preproc")

    def __enter__(self):
        from repro_torch.kernels import ops
        self.beats, self.aes, self.folds, self.preprocs = [], [], [], []
        self._orig = {n: getattr(ops, n) for n in self.NAMES}
        dpi_, aes_, fold_, pre_ = (self._orig[n] for n in self.NAMES)

        def dpi(payload, params, *, impl=None):
            if payload.is_cuda and impl is None and payload.numel():
                self.beats.append(payload.numel() // 64)
            return dpi_(payload, params, impl=impl)

        def aes(blocks, round_keys, *, decrypt=False, impl=None):
            if blocks.is_cuda and impl is None and blocks.numel():
                self.aes.append((blocks.shape[0], decrypt))
            return aes_(blocks, round_keys, decrypt=decrypt, impl=impl)

        def fold(x, *, impl=None):
            if x.is_cuda and impl is None and x.numel():
                aligned = x.data_ptr() % 16 == 0 and (
                    x.shape[0] == 1 or x.stride(0) * x.element_size() % 16
                    == 0)
                self.folds.append((*x.shape, x.stride(0), aligned))
            return fold_(x, impl=impl)

        def pre(recs, n_dense, modulus, *, rec_w=None, impl=None):
            if recs.is_cuda and impl is None and recs.numel():
                self.preprocs.append((*recs.shape, recs.stride(0)))
            return pre_(recs, n_dense, modulus, rec_w=rec_w, impl=impl)
        for n, f in zip(self.NAMES, (dpi, aes, fold, pre)):
            setattr(ops, n, f)
        return self

    def __exit__(self, *exc):
        from repro_torch.kernels import ops
        for n, f in self._orig.items():
            setattr(ops, n, f)

    def shapes(self) -> dict:
        """kernel -> {shape: launches} of the folds and preprocessing
        calls recorded."""
        def count(rows, fmt):
            out = {}
            for r in rows:
                out[fmt(*r)] = out.get(fmt(*r), 0) + 1
            return out
        return {"reduce_fold": count(self.folds, lambda k, n, s, a: (
                    f"({k}, {n}) row stride {s}"
                    + ("" if a else ", a row off 16 B"))),
                "preproc": count(self.preprocs, lambda r, w, s: (
                    f"({r}, {w}) row stride {s}"))}


# The launch sizes timed against the parent's kernels (``--launch-sizes``),
# as the paths record them (phases 3, 6, 7, 8 print each path's): the
# main path's DPI launches in beats and its AES launches (one encrypt of
# the 32 MiB batch, then decrypts of 4 x the DPI beats); the allreduce's
# folds (ring: (2, 124,881) f32 read in place from the (2, 499,524)-byte
# payload, row 1 4 bytes past a 16-byte boundary; offload: (3, 1,024) a
# 4 KiB packet, (3, 977) a chunk's last packet, the owner's (2, 124,881))
# and phase 2's (4, 8,388,608); the preprocessing tile (2 packet rows of
# 1,014 words, 1,024 apart), the on-path packet (1 row of 1,014) and
# phase 2's batch of 212,992 records; CRC32 at the ICRC chain's batch of
# 8192 full packets and at the main path's seven RX batches (its DPI
# beats / 64)
MAIN_DPI_BEATS = (513_344, 136_896, 18_112, 29_632, 5_760, 704, 128)
CRC_PKTS = tuple(b // (MTU // 64) for b in MAIN_DPI_BEATS)
MAIN_AES_LAUNCHES = ((N_PKTS * MTU // 16, False),) + tuple(
    (4 * b, True) for b in MAIN_DPI_BEATS)
FOLD_SHAPES = ((2, 124_881), (3, 1024), (3, 977), (4, 8 * 1024 * 1024))
PREPROC_SHAPES = ((2, 1014, 1024), (1, 1014, 1024),
                  (N_PKTS * RPP, REC_W, REC_W))


def time_launch_sizes(dev, aes_launches=MAIN_AES_LAUNCHES,
                      dpi_beats=MAIN_DPI_BEATS, fused_pkts=FUSED_PKTS,
                      folds=FOLD_SHAPES, preprocs=PREPROC_SHAPES,
                      crc_pkts=CRC_PKTS) -> dict:
    """Device ms of each kernel at launch sizes of the paths, on seeded
    random inputs: crc32 on the ICRC chain's 8192 full 4 KiB packets, L2
    cold (``_rotation``) and warm (back to back), and warm on the first
    ``crc_pkts`` of them, with the ICRC tap's whole call (``CrcService``,
    CUDA events) on all of them; aes_ecb at each (blocks, decrypt) of
    ``aes_launches``,
    dpi_mlp at ``dpi_beats``, the fused kernel at ``fused_pkts`` packets
    of 4 KiB, reduce_fold at each (K, L) of ``folds`` (float32, the rows
    back to back in one buffer as a payload lies, so row 1 of an odd L
    starts off a 16-byte boundary; the last shape in int32 too) and
    preproc at each (rows, words, row stride) of ``preprocs``; the tile
    (the first) in turns with a one-element add in one trace.  The median
    launch of a torch.profiler trace (a string marked "(events)" where no
    trace held the kernel).  Uses whichever ``repro_torch`` is on the
    path."""
    import torch
    from repro_torch.data import load_dpi_params_seed0
    from repro_torch.kernels import ops
    from repro_torch.kernels.dpi_mlp import dpi_params_from_numpy
    from repro_torch.kernels.fused_chain import fused_decrypt_dpi
    gen = torch.Generator(device=dev).manual_seed(5)
    rk = torch.as_tensor(ops.expand_key(KEY)).to(dev)

    def timed(fn, kernel):
        ms, how = _kernel_ms(fn, kernel, 20)
        return ms if how == "profiler" else f"{ms} ({how})"

    def rand_bytes(*shape):
        return torch.randint(0, 256, shape, generator=gen, device=dev,
                             dtype=torch.uint8)
    crc = {}
    pay = rand_bytes(N_PKTS, MTU)
    full = torch.full((N_PKTS,), MTU, dtype=torch.int32, device=dev)
    chain = f"{N_PKTS} x {MTU} full (ICRC chain)"
    crc[f"{chain}, L2 cold"] = timed(
        _rotation(lambda p: ops.crc32(p, full), pay), "crc32_kernel")
    crc[f"{chain}, warm"] = timed(lambda: ops.crc32(pay, full),
                                  "crc32_kernel")
    for n in crc_pkts:
        crc[f"{n} x {MTU} full, warm"] = timed(
            lambda: ops.crc32(pay[:n], full[:n]), "crc32_kernel")
    crc[f"CrcService call on {chain} (events)"] = _crc_service_ms(pay)
    aes = {}
    for n, decrypt in sorted(set(aes_launches)):
        blocks = rand_bytes(n, 16)
        aes[f"{'decrypt' if decrypt else 'encrypt'} {n}"] = timed(
            lambda: ops.aes_ecb(blocks, rk, decrypt=decrypt),
            "aes_ecb_kernel")
    tparams = dpi_params_from_numpy(load_dpi_params_seed0(), dev)
    dpi = {}
    for beats in dpi_beats:
        pay = rand_bytes(beats, 64)
        dpi[f"{beats} beats"] = timed(lambda: ops.dpi_scores(pay, tparams),
                                      "dpi_mlp_kernel")
    fused = {}
    for n in fused_pkts:
        pay = rand_bytes(n, MTU)
        fused[f"{n} x {MTU} ({n * MTU // 1024} tiles)"] = timed(
            lambda: fused_decrypt_dpi(pay, rk, tparams),
            "fused_chain_kernel")
    folds_ms = {}
    for i, (k, lanes) in enumerate(folds):
        words = rand_bytes(k * lanes * 4).view(torch.int32).view(k, lanes)
        dtypes = (torch.float32, torch.int32) if i == len(folds) - 1 else \
            (torch.float32,)
        for dt in dtypes:
            x = words.view(dt)
            folds_ms[f"({k}, {lanes}) {str(dt)[6:]}"] = timed(
                lambda: ops.reduce_fold(x), "reduce_fold_kernel")
    pre = {}
    for i, (rows, cols, stride) in enumerate(preprocs):
        recs = rand_bytes(rows * stride * 4).view(torch.int32).view(
            rows, stride)[:, :cols]
        fn = lambda: ops.preproc(recs, N_DENSE, MOD, rec_w=REC_W)  # noqa: E731
        key = f"({rows}, {cols}) row stride {stride}"
        if i == 0:
            one = torch.zeros(1, device=dev)
            turns = _traced_medians([("preproc_kernel", fn),
                                     ("elementwise_kernel",
                                      lambda: one.add_(1.0))], 20)
            if turns is not None:
                pre[key] = turns["preproc_kernel"]
                pre["one-element add, in turns with the tile"] = \
                    turns["elementwise_kernel"]
                continue
        pre[key] = timed(fn, "preproc_kernel")
    return {"aes_ecb": aes, "crc32": crc, "dpi_mlp": dpi,
            "fused_decrypt_dpi": fused, "reduce_fold": folds_ms,
            "preproc": pre}


class _FirstEpoch(Exception):
    pass


def _first_epoch_blobs(dev) -> dict:
    """The input blob (a CPU copy) and shape key of the first fused
    epoch of each phase-9 path whose worlds fuse: fig6's 4:1 x 32 KiB
    incast, fig11's 4 x 16 KiB ring, 6b's ingest at a window of 16 and
    7b's full-width ring.  Each path runs until it calls
    ``kernels.fused_epoch.fused_epoch`` and is cut there."""
    from repro_torch.core.ingest import BalboaIngest, make_dlrm_tile_decoder
    from repro_torch.core.netsim import FabricConfig, incast_scenario
    from repro_torch.kernels import fused_epoch as fe
    ring = next(r for r in json.loads((ROOT / "BENCH_fig11_allreduce.json")
                                      .read_text())["allreduce"]
                if r["mode"] == "ring")
    paths = {
        "fig6 4:1 x 32 KiB": lambda: incast_scenario(
            4, message_bytes=32768, fabric_cfg=FabricConfig(
                port_bandwidth=4, port_delay=2, queue_capacity=24, seed=7),
            epoch_mode="fused", device=dev),
        "fig11 ring 4 x 16 KiB": lambda: run_allreduce(
            dev, _allreduce_tensors(ring["message_bytes"] // 4,
                                    ring["world"]), offload=False,
            fabric_cfg=FabricConfig(port_bandwidth=4, port_delay=2,
                                    queue_capacity=48, seed=7),
            epoch_mode="fused"),
        "ingest (6b), window 16": lambda: BalboaIngest(
            _ingest_cfg("fused", 16), None, _dlrm_shard_fn(SHARD_PKTS),
            tile_to_batch=make_dlrm_tile_decoder(N_DENSE, N_SPARSE, MOD),
            device=dev).fetch_shard_streaming(0),
        "allreduce ring (7b)": lambda: run_allreduce(
            dev, _allreduce_tensors(ALLREDUCE_ELEMS), offload=False,
            epoch_mode="fused")}
    out, orig = {}, fe.fused_epoch

    def grab(blob, skey):
        out[name] = (blob.cpu().clone(), skey)
        raise _FirstEpoch
    fe.fused_epoch = grab
    try:
        for name, fn in paths.items():
            try:
                fn()
            except _FirstEpoch:
                pass
            assert name in out, f"{name}: no fused epoch"
    finally:
        fe.fused_epoch = orig
    return out


def time_fused_epochs(dev, reps: int = 15) -> dict:
    """``fused_epoch`` on each ``_first_epoch_blobs`` world: the wrapper's
    launch and, where the tree has ``launch_epoch``, each instantiation
    by hand, each launch on a fresh copy of the input blob: ``ms`` the
    median of ``reps`` launches' device time, by CUDA events around the
    launch recorded behind a 0.1 ms sleep on the card (so the wrapper's
    host work is done before the start event runs), ``call_ms`` the
    median of CUDA events around the whole call on an idle card (the
    wrapper's host work included), per epoch and per tick; every output bit-equal to ``epoch_ref``'s (its
    sha256 printed, to compare trees); the serial events, and the latency
    bound at the SM clock read just after the world's launches.  Uses
    whichever ``repro_torch`` is on the path."""
    import hashlib
    import torch
    from repro_torch.kernels import fused_epoch as fe
    variants = {"wrapper": fe.fused_epoch_cuda}
    if hasattr(fe, "launch_epoch"):
        for where in fe.RESIDENCIES:
            variants[where] = (lambda b, k, w=where:
                               fe.launch_epoch(b, k, w))
    out = {}
    for name, (blob0, skey) in _first_epoch_blobs(dev).items():
        lay = fe.cached_layout(skey)
        ref = blob0.clone()
        t0 = time.perf_counter()
        fe.epoch_ref(ref, skey)
        ref_ms = (time.perf_counter() - t0) * 1e3
        want = ref.numpy()
        steps = lay.get(want, "steps")
        events = _serial_events(lay, blob0.numpy(), want)
        rec = {"blob_words": blob0.numel(), "steps": steps,
               "serial_events": events,
               "bound_ms": _bound_ms(2 * 4 * blob0.numel())[0],
               "plain_ms_cpu": ref_ms,
               "sha256": hashlib.sha256(want.tobytes()).hexdigest()[:16]}
        if hasattr(fe, "residency"):
            rec["picked"] = fe.residency(skey, fe.smem_limit(dev))
        src = blob0.to(dev)
        buf = torch.empty_like(src)
        for vname, launch in variants.items():
            if vname == "shared" and rec.get("picked") == "global":
                continue

            def timed(behind_sleep, launch=launch):
                buf.copy_(src)
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                torch.cuda.synchronize()
                if behind_sleep:
                    torch.cuda._sleep(200_000)
                start.record()
                launch(buf, skey)
                end.record()
                end.synchronize()
                assert np.array_equal(buf.cpu().numpy(), want), \
                    f"{name} {vname}: differs from epoch_ref"
                return start.elapsed_time(end)
            timed(True)
            ms = statistics.median(timed(True) for _ in range(reps))
            call = statistics.median(timed(False) for _ in range(reps))
            rec[vname] = {"ms": ms, "ms_per_tick": ms / steps,
                          "call_ms": call}
        rec["sm_clock_mhz"] = _sm_clock_mhz()
        rec["bound_design_ms"] = _latency_bound_ms(events,
                                                   rec["sm_clock_mhz"])
        out[name] = rec
        print(f"[launch-sizes] fused_epoch {name}: " + ", ".join(
            f"{v} {rec[v]['ms']:.4f} ms ({rec[v]['ms_per_tick']:.5f} a "
            f"tick; call {rec[v]['call_ms']:.4f})" for v in variants
            if v in rec)
            + f"; {steps} ticks, {events} serial events, latency bound "
            f"{rec['bound_design_ms']:.5f} ms at {rec['sm_clock_mhz']} MHz, "
            f"epoch_ref {ref_ms:.2f} ms (CPU)", file=sys.stderr)
    return out


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


def _crc_service_ms(pay) -> float:
    """The whole call of the ICRC tap (``CrcService``) on the full packets
    ``pay`` ((N, MTU) uint8 on the card), by CUDA events."""
    import torch
    from repro_torch.core.services import CrcService
    plen = torch.full((pay.shape[0],), MTU, dtype=torch.int32,
                      device=pay.device)
    tap = CrcService(device=pay.device)
    return _median_ms(lambda: tap(pay, plen), 5, burst=10)


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


def _dlrm_shard_fn(n_pkts: int):
    from repro_torch.data import synthetic as syn
    return lambda i: syn.encode_dlrm_packets(
        syn.dlrm_shard(i, RPP * n_pkts, N_DENSE, N_SPARSE))


def _decode_host(raw):
    """The host-side decode of the synchronous baseline (fig10_dlrm.py's
    ``_decode_host``) — the copy the streaming plane exists to
    eliminate."""
    words = np.frombuffer(raw.tobytes(), np.int32).reshape(-1, MTU // 4)
    recs = words[:, :RPP * REC_W].reshape(-1, REC_W)
    dense = np.log1p(np.maximum(recs[:, :N_DENSE], 0).astype(np.float32))
    sparse = (recs[:, N_DENSE:] % MOD).astype(np.int32)
    return {"dense": dense, "sparse": sparse}


def phase_fig10(dev) -> dict:
    """Phase 6a: BENCH_fig10_dlrm.json's smoke rows on the card, with
    benchmarks/fig10_dlrm.py's settings (32 packets, links shaped to 1
    packet per tick, 2-packet tiles)."""
    import torch
    from repro_torch.core.ingest import (BalboaIngest, IngestConfig,
                                         make_dlrm_tile_decoder)
    from repro_torch.core.rdma import step_network
    rows = json.loads((ROOT / "BENCH_fig10_dlrm.json").read_text())["ingest"]
    n_pkts = rows["n_pkts"]
    nbytes = n_pkts * MTU
    # the synchronous single-QP store-and-forward baseline, ticks counted
    # until the last byte lands
    ing = BalboaIngest(
        IngestConfig(batch_bytes=nbytes, n_storage_nodes=1,
                     link_bw_pkts_per_tick=1),
        None, _dlrm_shard_fn(n_pkts), decode_fn=_decode_host, device=dev)
    qp, st = ing.qps[0], ing.storage[0]
    st.load_shard(st.node._qp_buffer[qp.qpn_r][1], 0)
    t0 = ing.net.now
    ing.trainer.rdma_read(qp.qpn_l, nbytes)
    while ing.trainer.rx_progress(qp.qpn_l) < nbytes:
        step_network([ing.trainer, st.node])
        assert ing.net.now - t0 < 100_000, "sync baseline stuck"
    ticks = ing.net.now - t0
    raw = ing.trainer._qp_buffer[qp.qpn_l][1][:nbytes]
    ing.host_payload_bytes += nbytes
    ing._to_device(_decode_host(raw.copy()))
    got = {"sync": {"ticks": ticks, "nbytes": nbytes,
                    "goodput": nbytes / max(ticks, 1),
                    "host_bytes": ing.host_payload_bytes}, "streamed": {}}
    for r in (1, 4):
        ing = BalboaIngest(
            IngestConfig(batch_bytes=nbytes, n_storage_nodes=r,
                         link_bw_pkts_per_tick=1, tile_pkts=2),
            None, _dlrm_shard_fn(n_pkts),
            tile_to_batch=make_dlrm_tile_decoder(N_DENSE, N_SPARSE, MOD),
            device=dev)
        batch, rep = ing.fetch_shard_streaming(0)
        torch.cuda.synchronize()
        got["streamed"][str(r)] = {
            "ticks": rep.ticks, "nbytes": rep.nbytes,
            "goodput": rep.goodput_bytes_per_tick,
            "overlap": rep.overlap_efficiency, "tiles": rep.tiles,
            "stripes": len(rep.stripes), "host_bytes": ing.host_payload_bytes}
    want = {"sync": {k: rows["sync"][k] for k in got["sync"]},
            "streamed": {r: {k: rows["streamed"][r][k] for k in v}
                         for r, v in got["streamed"].items()}}
    assert got == want, (got, want)
    print(f"[ingest] fig10 smoke rows on {dev}: sync ticks="
          f"{got['sync']['ticks']} host_bytes={got['sync']['host_bytes']}; "
          + "; ".join(f"streamed r{r} ticks={v['ticks']} "
                      f"overlap={v['overlap']} tiles={v['tiles']}"
                      for r, v in got["streamed"].items())
          + " == BENCH_fig10_dlrm.json")
    return got


def _poisoned(raw):
    raise AssertionError("host decode touched payload bytes")


def _ingest_cfg(epoch_mode=None, fc_window=None):
    from repro_torch.core.ingest import IngestConfig
    return IngestConfig(batch_bytes=SHARD_PKTS * MTU, n_storage_nodes=4,
                        qps_per_node=2, tile_pkts=2, link_bw_pkts_per_tick=1,
                        epoch_mode=epoch_mode, fc_window=fc_window)


def run_ingest(dev, model, impl, n_shards, epoch_mode=None,
               fc_window=None) -> dict:
    """Phase 6b, one arm: stream ``n_shards`` full-size shards, each tile
    preprocessed on the card as it lands, and score every landed batch
    with the DLRM (loss and accuracy against the synthetic labels).
    Phase 9c runs it again in fused epochs (``epoch_mode``), at 6b's
    window and at ``fc_window``."""
    import torch
    from repro_torch.core.ingest import BalboaIngest, make_dlrm_tile_decoder
    from repro_torch.data import synthetic as syn

    ing = BalboaIngest(
        _ingest_cfg(epoch_mode, fc_window), None,
        _dlrm_shard_fn(SHARD_PKTS), decode_fn=_poisoned,
        tile_to_batch=make_dlrm_tile_decoder(N_DENSE, N_SPARSE, MOD,
                                             impl=impl), device=dev)
    shards = []
    t0 = time.perf_counter()
    stream_s = score_s = 0.0
    it = ing.stream_batches(n_shards)
    for i in range(n_shards):
        ts = time.perf_counter()
        batch, rep = next(it)
        torch.cuda.synchronize()
        tm = time.perf_counter()
        stream_s += tm - ts
        raw = syn.dlrm_shard(i, RPP * SHARD_PKTS, N_DENSE, N_SPARSE)
        label = torch.from_numpy(syn.dlrm_labels(raw, N_DENSE, MOD)).to(dev)
        with torch.no_grad():
            loss, m = model.loss({**batch, "label": label})
            logits = model(batch["dense"], batch["sparse"])
        loss, acc = float(loss), float(m["acc"])
        score_s += time.perf_counter() - tm
        np.testing.assert_allclose(
            batch["dense"].cpu().numpy(),
            np.log1p(np.maximum(raw[:, :N_DENSE], 0)), rtol=1e-5)
        assert np.isfinite(loss) and logits.shape == (len(raw),)
        shards.append(dict(
            report=(rep.ticks, rep.tiles, rep.overlap_efficiency,
                    rep.refetches, rep.events),
            dense=batch["dense"], sparse=batch["sparse"], logits=logits,
            loss=loss, acc=acc))
    wall = time.perf_counter() - t0
    assert ing.host_payload_bytes == 0
    return dict(shards=shards, wall_s=wall, stream_s=stream_s,
                score_s=score_s)


def run_ingest_onpath(dev) -> dict:
    """Phase 6c: shard 0 with the preprocessing ON-PATH, inside the
    trainer's RX pipeline (``PreprocService``); the tile decoder only
    splits columns."""
    import torch
    from repro_torch.core.ingest import BalboaIngest, make_dlrm_tile_decoder
    from repro_torch.core.services import PreprocService, ServiceChain
    chain = ServiceChain(on_path=[PreprocService(
        n_dense=N_DENSE, n_sparse=N_SPARSE, modulus=MOD, device=dev)])
    ing = BalboaIngest(
        _ingest_cfg(), chain, _dlrm_shard_fn(SHARD_PKTS),
        tile_to_batch=make_dlrm_tile_decoder(N_DENSE, N_SPARSE, None),
        device=dev)
    t0 = time.perf_counter()
    batch, rep = ing.fetch_shard_streaming(0)
    torch.cuda.synchronize()
    return dict(batch=batch, ticks=rep.ticks, tiles=rep.tiles,
                wall_s=time.perf_counter() - t0)


def _allreduce_tensors(n_elems: int, world: int = 4, seed: int = 13):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(n_elems).astype(np.float32)
            for _ in range(world)]


def run_allreduce(dev, xs, *, offload, impl=None, fabric_cfg=None,
                  epoch_mode=None) -> dict:
    """One allreduce over the verbs (make_ring_group defaults unless a
    fabric is given), its output held bit for bit against the oracle."""
    from repro_torch.core.collectives import allreduce_oracle, make_ring_group
    world, n_elems = len(xs), xs[0].size
    t0 = time.perf_counter()
    g = make_ring_group(world, n_elems * 4 + world * 4, fabric_cfg=fabric_cfg,
                        offload=offload, impl=impl, epoch_mode=epoch_mode,
                        device=dev)
    out = g.allreduce(xs)
    wall = time.perf_counter() - t0
    want = allreduce_oracle(xs)
    for r in range(world):
        assert (out[r].view(np.uint8) == want.view(np.uint8)).all(), \
            f"allreduce rank {r} not bit-identical to the oracle " \
            f"(offload={offload}, impl={impl})"
    nbytes = n_elems * 4
    ticks = max(g.stats.ticks, 1)
    res = {"world": world, "message_bytes": nbytes,
           "mode": "offload" if offload else "ring", "cc": "ack_clocked",
           "lossy": g.net.cfg.loss_prob > 0, "ticks": ticks,
           "algbw_B_per_tick": round(nbytes / ticks, 2),
           "busbw_B_per_tick": round(2 * (world - 1) / world * nbytes
                                     / ticks, 2),
           "retransmissions": sum(n.stats.retransmissions for n in g.nodes),
           "tail_dropped": g.net.total_tail_dropped}
    if offload:
        red = g.service.reducer
        res.update(switch_absorbed=red.absorbed,
                   switch_forwarded=red.reduced_forwarded,
                   switch_acks=red.acks_synthesized,
                   switch_naks=red.naks_synthesized,
                   switch_peak_slots=red.peak_slots)
    return dict(row=res, reducer=g.snapshot(), wall_s=wall)


def phase_fig11(dev) -> list:
    """Phase 7a: BENCH_fig11_allreduce.json's 4-node smoke rows on the
    card, on benchmarks/fig11_allreduce.py's base fabric."""
    from repro_torch.core.netsim import FabricConfig
    base = FabricConfig(port_bandwidth=4, port_delay=2, queue_capacity=48,
                        seed=7)
    rows = json.loads((ROOT / "BENCH_fig11_allreduce.json").read_text())
    got = []
    for want in rows["allreduce"]:
        xs = _allreduce_tensors(want["message_bytes"] // 4, want["world"])
        row = run_allreduce(dev, xs, offload=want["mode"] == "offload",
                            fabric_cfg=base)["row"]
        assert row == want, (row, want)
        got.append(row)
    print(f"[allreduce] fig11 smoke rows on {dev}: "
          + "; ".join(f"{r['mode']} ticks={r['ticks']}" for r in got)
          + " == BENCH_fig11_allreduce.json, bit-identical to the oracle")
    return got


def phase_ingest(dev, shapes: dict, keep: dict) -> dict:
    """Phase 6: the fig10 rows, then the full-size streaming ingest into
    the full-config DLRM with the kernels and with the plain versions,
    then the on-path variant.  Returns the launch counts of the two
    ingest paths, puts their launches' shapes
    (``_SizesPerLaunch.shapes``) in ``shapes``, and the model and the
    kernel arm in ``keep`` (phase 9 holds its fused arm against it)."""
    import torch
    from repro_torch.configs.dlrm import config
    from repro_torch.kernels import ops
    from repro_torch.models.dlrm import DLRM
    phase_fig10(dev)
    cfg = config()
    model = DLRM(cfg, seed=0, device=dev).eval()
    n_params = sum(p.numel() for p in model.parameters())
    ops.reset_launches()
    with _SizesPerLaunch() as sizes:
        kern = run_ingest(dev, model, None, N_SHARDS)
    on_ingest = ops.launches()
    shapes["ingest"] = sizes.shapes()
    ops.reset_launches()
    with _SizesPerLaunch() as sizes:
        onpath = run_ingest_onpath(dev)
    on_onpath = ops.launches()
    shapes["ingest_onpath"] = sizes.shapes()
    ops.reset_launches()
    plain = run_ingest(dev, model, "ref", N_SHARDS)
    assert not any(ops.launches().values()), "the plain arm launched a kernel"

    worst_ulp, worst_logit = 0, 0.0
    for i, (k, p) in enumerate(zip(kern["shards"], plain["shards"])):
        assert k["report"] == p["report"], \
            f"shard {i}: ticks/tiles/overlap/refetches/events differ"
        assert torch.equal(k["sparse"], p["sparse"]), f"shard {i}: sparse"
        ulps = int((k["dense"].view(torch.int32).long()
                    - p["dense"].view(torch.int32).long()).abs().max())
        assert ulps <= 1, f"shard {i}: dense {ulps} ulp between arms"
        worst_ulp = max(worst_ulp, ulps)
        torch.testing.assert_close(k["logits"], p["logits"], rtol=LOGIT_RTOL,
                                   atol=LOGIT_ATOL)
        worst_logit = max(worst_logit,
                          float((k["logits"] - p["logits"]).abs().max()))
    s0 = kern["shards"][0]
    assert torch.equal(onpath["batch"]["dense"].view(torch.int32),
                       s0["dense"].view(torch.int32)), "on-path dense"
    assert torch.equal(onpath["batch"]["sparse"], s0["sparse"]), \
        "on-path sparse"
    rep = s0["report"]
    losses = [s["loss"] for s in kern["shards"]]
    accs = [s["acc"] for s in kern["shards"]]
    print(f"[ingest] full size: {N_SHARDS} shards x {SHARD_PKTS} packets "
          f"({RPP * SHARD_PKTS} records) over 4 replicas x 2 QPs, 2-packet "
          f"tiles; shard 0 ticks={rep[0]} tiles={rep[1]} overlap={rep[2]} "
          f"refetches={rep[3]}; DLRM {n_params} parameters, loss "
          f"{min(losses):.4f}..{max(losses):.4f} acc {min(accs):.3f}.."
          f"{max(accs):.3f}; kernels vs plain: reports equal, sparse "
          f"bit-exact, dense worst {worst_ulp} ulp, logits worst abs "
          f"{worst_logit:.3e} (rtol=atol={LOGIT_RTOL}); host_payload_bytes=0")
    print(f"[ingest] wall_s kernels={kern['wall_s']:.2f} (stream "
          f"{kern['stream_s']:.2f} score {kern['score_s']:.2f}) plain="
          f"{plain['wall_s']:.2f} (stream {plain['stream_s']:.2f} score "
          f"{plain['score_s']:.2f})")
    print(f"[ingest] on-path PreprocService: shard 0 ticks="
          f"{onpath['ticks']} tiles={onpath['tiles']} wall_s="
          f"{onpath['wall_s']:.2f}, landed batch bit-identical to the "
          f"tile-decoder arm")
    print(f"[ingest] kernel launches on ingest: {on_ingest}; on "
          f"ingest_onpath: {on_onpath}; preproc launches by shape: ingest "
          f"{shapes['ingest']['preproc']}, ingest_onpath "
          f"{shapes['ingest_onpath']['preproc']}")
    assert on_ingest["preproc"] > 0, "preproc not launched on ingest"
    assert on_onpath["preproc"] > 0, "preproc not launched on ingest_onpath"
    keep.update(model=model, ingest=kern)
    return {"ingest": on_ingest, "ingest_onpath": on_onpath}


def phase_allreduce(dev, shapes: dict, keep: dict) -> dict:
    """Phase 7: the fig11 rows, then the full-size allreduce (ring and
    offload) with the kernels and with the plain versions.  Returns the
    launch counts of the two allreduce paths, puts their launches'
    shapes in ``shapes`` and the ring's kernel arm in ``keep``."""
    from repro_torch.kernels import ops
    phase_fig11(dev)
    xs = _allreduce_tensors(ALLREDUCE_ELEMS)
    counts, runs = {}, {}
    for mode in ("ring", "offload"):
        ops.reset_launches()
        with _SizesPerLaunch() as sizes:
            runs[mode] = run_allreduce(dev, xs, offload=mode == "offload")
        counts[f"allreduce_{mode}"] = ops.launches()
        shapes[f"allreduce_{mode}"] = sizes.shapes()
    ops.reset_launches()
    plain = {mode: run_allreduce(dev, xs, offload=mode == "offload",
                                 impl="ref") for mode in ("ring", "offload")}
    assert not any(ops.launches().values()), "the plain arm launched a kernel"
    for mode, k in runs.items():
        p = plain[mode]
        assert k["row"] == p["row"] and k["reducer"] == p["reducer"], \
            f"allreduce {mode}: kernels {k['row']} vs plain {p['row']}"
        r = k["row"]
        print(f"[allreduce] full size {mode}: 4 ranks x {ALLREDUCE_ELEMS} "
              f"f32 ({r['message_bytes']} B), bit-identical to the oracle, "
              f"ticks={r['ticks']} busbw={r['busbw_B_per_tick']} B/tick "
              f"retransmissions={r['retransmissions']}"
              + (f" switch_absorbed={r['switch_absorbed']}"
                 if mode == "offload" else "")
              + f"; wall_s kernels={k['wall_s']:.2f} plain={p['wall_s']:.2f}"
              f"; launches {counts[f'allreduce_{mode}']}; reduce_fold "
              f"launches by shape "
              f"{shapes[f'allreduce_{mode}']['reduce_fold']}")
        assert counts[f"allreduce_{mode}"]["reduce_fold"] > 0, \
            f"reduce_fold not launched on allreduce_{mode}"
    keep["allreduce_ring"] = runs["ring"]
    return counts


def _sgd_step(model, batch) -> float:
    """One step of examples/dlrm_ingest.py's trainer: the loss, its
    gradient, ``p - lr * g``.  Returns the loss before the update."""
    import torch
    model.zero_grad(set_to_none=True)
    loss, _ = model.loss(batch)
    loss.backward()
    with torch.no_grad():
        for p in model.parameters():
            p -= SGD_LR * p.grad
    return float(loss.detach())


def _secure_shards(dev) -> list:
    """Phase 8's data: each full-size shard's record packets, AES-128-ECB
    encrypted at rest under the seeded key (once, with the kernel, before
    any timed window), as numpy for the storage replicas."""
    import torch
    from repro_torch.kernels import ops
    rk = torch.as_tensor(ops.expand_key(_secure_key())).to(dev)
    shards = []
    for i in range(N_SHARDS):
        pt = _dlrm_shard_fn(SHARD_PKTS)(i)
        ct = ops.aes_ecb(torch.from_numpy(pt.reshape(-1, 16).copy()).to(dev),
                         rk).cpu().numpy().reshape(-1)
        assert not np.array_equal(ct, pt)
        shards.append(ct)
    return shards


def run_secure_ingest(dev, model, tparams, shards, impl) -> dict:
    """Phase 8, one arm: stream the encrypted shards; each tile is
    decrypted and inspected by the fused pass as it lands, then
    preprocessed from the plaintext; every landed batch trains the DLRM
    for SGD_STEPS steps."""
    import torch
    from repro_torch.core.ingest import BalboaIngest, make_dlrm_tile_decoder
    from repro_torch.data import synthetic as syn
    from repro_torch.kernels import ops
    from repro_torch.kernels.fused_chain import fused_decrypt_dpi_tile
    rk = torch.as_tensor(ops.expand_key(_secure_key())).to(dev)
    decode = make_dlrm_tile_decoder(N_DENSE, N_SPARSE, MOD, impl=impl)

    def tile_to_batch(tile):
        plain, score = fused_decrypt_dpi_tile(tile, rk, tparams, tile_pkts=2,
                                              impl=impl)
        return {**decode(plain), "dpi_score": score}

    ing = BalboaIngest(_ingest_cfg(), None, lambda i: shards[i],
                       decode_fn=_poisoned, tile_to_batch=tile_to_batch,
                       device=dev)
    out = []
    t0 = time.perf_counter()
    stream_s = train_s = 0.0
    it = ing.stream_batches(len(shards))
    for i in range(len(shards)):
        ts = time.perf_counter()
        batch, rep = next(it)
        torch.cuda.synchronize()
        tm = time.perf_counter()
        stream_s += tm - ts
        raw = syn.dlrm_shard(i, RPP * SHARD_PKTS, N_DENSE, N_SPARSE)
        label = torch.from_numpy(syn.dlrm_labels(raw, N_DENSE, MOD)).to(dev)
        b = {"dense": batch["dense"], "sparse": batch["sparse"],
             "label": label}
        losses = [_sgd_step(model, b) for _ in range(SGD_STEPS)]
        with torch.no_grad():
            after = float(model.loss(b)[0])
        torch.cuda.synchronize()
        train_s += time.perf_counter() - tm
        # the decrypted records are the plaintext records
        np.testing.assert_allclose(
            batch["dense"].cpu().numpy(),
            np.log1p(np.maximum(raw[:, :N_DENSE], 0)), rtol=1e-5)
        assert np.array_equal(batch["sparse"].cpu().numpy(),
                              raw[:, N_DENSE:] % MOD), f"shard {i}: sparse"
        assert batch["dpi_score"].shape == (SHARD_PKTS,)
        assert bool(torch.isfinite(batch["dpi_score"]).all())
        assert all(np.isfinite(losses)) and after < losses[0], \
            f"shard {i}: loss {losses[0]} -> {after} did not fall"
        out.append(dict(
            report=(rep.ticks, rep.tiles, rep.overlap_efficiency,
                    rep.refetches, rep.events),
            dense=batch["dense"], sparse=batch["sparse"],
            scores=batch["dpi_score"], losses=losses, after=after))
    wall = time.perf_counter() - t0
    assert ing.host_payload_bytes == 0
    return dict(shards=out, wall_s=wall, stream_s=stream_s, train_s=train_s)


def phase_secure_ingest(dev, params, shapes: dict) -> dict:
    """Phase 8: the full-size ingest with the shards encrypted at rest,
    fused decrypt+DPI per tile, training the full-config DLRM, with the
    kernels and with the plain versions (each arm from the same seeded
    weights).  Returns the launch counts of the secure_ingest path, and
    puts its launches' shapes in ``shapes``."""
    import torch
    from repro_torch.configs.dlrm import config
    from repro_torch.kernels import ops
    from repro_torch.kernels.dpi_mlp import dpi_params_from_numpy
    from repro_torch.models.dlrm import DLRM
    cfg = config()
    tparams = dpi_params_from_numpy(params, dev)
    shards = _secure_shards(dev)
    arms = {}
    for impl in (None, "ref"):
        model = DLRM(cfg, seed=0, device=dev)
        ops.reset_launches()
        with _SizesPerLaunch() as sizes:
            arms[impl] = run_secure_ingest(dev, model, tparams, shards, impl)
        counts = ops.launches()
        if impl is None:
            on_secure = counts
            shapes["secure_ingest"] = sizes.shapes()
        else:
            assert not any(counts.values()), "the plain arm launched a kernel"
        del model
    kern, plain = arms[None], arms["ref"]
    worst_score, worst_loss, flagged = 0.0, 0.0, []
    for i, (k, p) in enumerate(zip(kern["shards"], plain["shards"])):
        assert k["report"] == p["report"], \
            f"shard {i}: ticks/tiles/overlap/refetches/events differ"
        assert torch.equal(k["sparse"], p["sparse"]), f"shard {i}: sparse"
        assert torch.equal(k["dense"].view(torch.int32),
                           p["dense"].view(torch.int32)), f"shard {i}: dense"
        torch.testing.assert_close(k["scores"], p["scores"], rtol=DPI_RTOL,
                                   atol=DPI_ATOL)
        worst_score = max(worst_score,
                          float((k["scores"] - p["scores"]).abs().max()))
        nk = int((k["scores"] > DPI_THRESHOLD).sum())
        assert nk == int((p["scores"] > DPI_THRESHOLD).sum()), \
            f"shard {i}: flagged counts differ"
        flagged.append(nk)
        np.testing.assert_allclose(k["losses"] + [k["after"]],
                                   p["losses"] + [p["after"]],
                                   rtol=LOSS_RTOL, atol=LOSS_ATOL)
        worst_loss = max(worst_loss, float(np.abs(np.subtract(
            k["losses"] + [k["after"]], p["losses"] + [p["after"]])).max()))
    rep = kern["shards"][0]["report"]
    print(f"[secure] full size: {N_SHARDS} AES-encrypted shards x "
          f"{SHARD_PKTS} packets ({RPP * SHARD_PKTS} records) over 4 "
          f"replicas x 2 QPs, 2-packet tiles through fused decrypt+DPI then "
          f"preproc; shard 0 ticks={rep[0]} tiles={rep[1]} overlap={rep[2]} "
          f"refetches={rep[3]}; DPI flagged {flagged} of {SHARD_PKTS} "
          f"packets per shard (score > {DPI_THRESHOLD})")
    for i, s in enumerate(kern["shards"]):
        print(f"[secure] shard {i}: {SGD_STEPS} SGD steps at lr {SGD_LR}, "
              f"loss {s['losses'][0]:.6f} -> {s['after']:.6f} (steps "
              + ", ".join(f"{x:.6f}" for x in s["losses"]) + ")")
    print(f"[secure] kernels vs plain: reports equal, sparse and dense words "
          f"equal, scores worst abs {worst_score:.3e} (rtol=atol={DPI_RTOL}), "
          f"flagged counts equal, losses worst abs {worst_loss:.3e} "
          f"(rtol={LOSS_RTOL}, atol={LOSS_ATOL}); host_payload_bytes=0")
    for name, a in (("kernels", kern), ("plain", plain)):
        print(f"[secure] wall_s {name}: stream {a['stream_s']:.2f} train "
              f"{a['train_s']:.2f} total {a['wall_s']:.2f}")
    print(f"[secure] kernel launches on secure_ingest: {on_secure}; preproc "
          f"launches by shape {shapes['secure_ingest']['preproc']}")
    for name in ("fused_decrypt_dpi", "preproc"):
        assert on_secure[name] > 0, f"{name} not launched on secure_ingest"
    return {"secure_ingest": on_secure}


# ---------------------------------------------------------------------------
# phase 9: the telemetry plane and the fused epoch core
# ---------------------------------------------------------------------------

def _serial_events(lay, before, after) -> int:
    """The packets an epoch sent, delivered and retransmitted, summed
    over the nodes (the deltas of the blob's ``n_tx``, ``n_rx`` and
    ``n_retx``): the events that run one after another."""
    return int(sum((lay.get(after, n).astype(np.int64)
                    - lay.get(before, n)).sum()
                   for n in ("n_tx", "n_rx", "n_retx")))


# one shared-memory round trip, in SM cycles: the step of the fused epoch's
# latency bound (``_latency_bound_ms``)
SMEM_ROUND_TRIP_CYCLES = 30


def _latency_bound_ms(events: int, clock_mhz: float) -> float:
    """The fused epoch's latency design bound: its serial events, each
    one shared-memory round trip at the SM clock."""
    return events * SMEM_ROUND_TRIP_CYCLES / (clock_mhz * 1e3)


class _HeldEpochs:
    """While entered, every fused epoch the port runs on the card
    (``kernels.fused_epoch.fused_epoch``, which ``core.fused`` calls once
    an epoch) is timed by CUDA events around its launch, its serial
    events and the kernel instantiation it ran are recorded, and, for the
    first ``limit`` epochs (all when None), it is held against
    ``epoch_ref`` on a CPU copy of the same input blob: the output blobs
    must be bit-identical.  The copies this check makes are its own, not
    the port's."""

    def __init__(self, limit=None):
        self.limit = limit

    def __enter__(self):
        import torch
        from repro_torch.kernels import fused_epoch as fe
        self.fe, self._orig = fe, fe.fused_epoch
        # (ms, steps, words, serial events, instantiation); CPU ms
        self.epochs, self.ref_ms = [], []

        def run(blob, skey):
            hold = blob.is_cuda and (
                self.limit is None or len(self.ref_ms) < self.limit)
            host = blob.cpu().clone()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = self._orig(blob, skey)
            end.record()
            end.synchronize()
            lay = fe.cached_layout(skey)
            got = out.cpu().numpy()
            self.epochs.append((
                start.elapsed_time(end), lay.get(got, "steps"),
                blob.numel(), _serial_events(lay, host.numpy(), got),
                fe.fused_epoch_cuda.last_residency))
            if hold:
                t0 = time.perf_counter()
                fe.epoch_ref(host, skey)
                self.ref_ms.append((time.perf_counter() - t0) * 1e3)
                want = host.numpy()
                bad = [n for n in lay.index
                       if not np.array_equal(lay.get(got, n),
                                             lay.get(want, n))]
                assert not bad, f"fused_epoch kernel differs from " \
                    f"epoch_ref in {bad} ({skey})"
            return out
        fe.fused_epoch = run
        return self

    def __exit__(self, *exc):
        self.fe.fused_epoch = self._orig

    def summary(self) -> dict:
        ms = sum(e[0] for e in self.epochs)
        ticks = sum(e[1] for e in self.epochs)
        n = len(self.epochs)
        residency = {}
        for e in self.epochs:
            residency[e[4]] = residency.get(e[4], 0) + 1
        return {"kernel_ms": ms, "ms_per_epoch": ms / n if n else None,
                "ms_per_tick": ms / ticks if ticks else None,
                "held": len(self.ref_ms),
                "plain_ms_per_epoch_cpu": (statistics.mean(self.ref_ms)
                                           if self.ref_ms else None),
                "blob_words": max((e[2] for e in self.epochs), default=0),
                "serial_events": sum(e[3] for e in self.epochs),
                "residency": residency}


def _fused_path(name: str, fn, limit=None):
    """Run ``fn`` (one path in fused epochs) with the launch counters and
    the fused mode's counts set to 0 just before it and read just
    after; every launched epoch (or the first ``limit``) held against
    the plain version.  Returns (fn's result, the path's record)."""
    from repro_torch.core import fused
    from repro_torch.kernels import ops
    fused.STATS.reset()
    ops.reset_launches()
    with _HeldEpochs(limit) as held:
        t0 = time.perf_counter()
        res = fn()
        wall = time.perf_counter() - t0
    launches = ops.launches()
    rec = dict(fused.STATS.snapshot(), launches=launches, wall_s=wall,
               **held.summary())
    assert launches["fused_epoch"] == rec["epochs"], (name, rec)
    rec["ticks_per_epoch"] = rec["ticks"] / rec["epochs"] \
        if rec["epochs"] else None
    print(f"[fused] {name}: epochs={rec['epochs']} ticks={rec['ticks']} "
          f"ticks/epoch={rec['ticks_per_epoch']} refusals="
          f"{rec['refusals']} aborts={rec['aborts']}; fused_epoch launches "
          f"{launches['fused_epoch']} (instantiation: {rec['residency']}), "
          f"{rec['held']} held bit-equal to epoch_ref; kernel ms/epoch="
          f"{rec['ms_per_epoch']} ms/tick={rec['ms_per_tick']} (CUDA "
          f"events); serial events {rec['serial_events']}; wall_s="
          f"{wall:.2f}")
    return res, rec


def phase_telemetry(dev) -> dict:
    """Phase 9a: BENCH_fig6_multipath.json's ``traced_incast`` (8:1 Clos
    incast, selective repeat and spray, spine 0 failing at tick 10)
    through the port's ``instrument``, on the card and on the CPU."""
    import torch
    from repro_torch.core import telemetry as tm
    from repro_torch.core.netsim import clos_incast_scenario
    row = json.loads((ROOT / "BENCH_fig6_multipath.json").read_text())[
        "traced_incast"]

    def traced(d):
        rec = tm.FlightRecorder(capacity=1 << 20)
        t0 = time.perf_counter()
        res = clos_incast_scenario(
            row["fan_in"], message_bytes=row["message_bytes"],
            rx_mode="selective_repeat", path_select="spray",
            fail_spine_at=10, recorder=rec, device=d)
        reg, _ = tm.instrument(fabric=res.fabric,
                               nodes=[res.receiver] + res.senders,
                               recorder=rec)
        return reg.flat(), res.ticks, rec, time.perf_counter() - t0

    flat, ticks, rec, wall = traced(dev)
    cflat, cticks, crec, cwall = traced(torch.device("cpu"))
    want = row["telemetry"]
    bad = sorted(k for k in set(flat) | set(want)
                 if flat.get(k) != want.get(k))
    assert len(want) == 386 and not bad, f"telemetry differs at {bad[:20]}"
    assert ticks == row["ticks"] == 31 and cticks == ticks
    assert len(rec.events()) == row["trace_events"] == 745
    assert rec.dropped_events == 0 and cflat == flat
    trace = rec.chrome_trace_json()
    assert trace == crec.chrome_trace_json(), "chrome trace differs from " \
        "the CPU run's"
    print(f"[telemetry] traced_incast 8:1 on {dev}: flat() == "
          f"BENCH_fig6_multipath.json ({len(flat)} keys), ticks={ticks}, "
          f"{len(rec.events())} trace events, chrome_trace_json "
          f"({len(trace)} B) byte-identical to the CPU run; wall_s card="
          f"{wall:.2f} cpu={cwall:.2f}")
    return {"keys": len(flat), "ticks": ticks, "events": len(rec.events())}


def _fig6_world(dev, n_senders=4, message_bytes=32768):
    """The fig6 fused-equivalence incast, built as ``incast_scenario``
    builds it but not yet run."""
    from repro_torch.core.flow_control import DcqcnConfig
    from repro_torch.core.netsim import FabricConfig, SwitchedFabric, _per_port
    from repro_torch.core.rdma import RdmaNode
    cfg = FabricConfig(port_bandwidth=4, port_delay=2, queue_capacity=24,
                       seed=7)
    fabric = SwitchedFabric(n_senders + 1, cfg)
    line = float(_per_port(cfg.port_bandwidth, n_senders + 1)[0])
    dcqcn = DcqcnConfig(line_rate=line, initial_rate=line / 4)
    recv = RdmaNode(0, fabric, rx_credits=64, device=dev)
    senders = [RdmaNode(i + 1, fabric, fc_window=16, dcqcn=dcqcn, device=dev)
               for i in range(n_senders)]
    rng = np.random.default_rng(13)
    for s in senders:
        qpn, _, _ = s.init_rdma(message_bytes, recv)
        s.rdma_write(qpn, rng.integers(0, 256, message_bytes,
                                       dtype=np.uint8))
    return [recv] + senders


class _Copies:
    """Counts, while entered, the transfers between host and card that
    Python code asks for: ``Tensor.to`` and ``Tensor.cpu`` across the
    two, and the ``item``/``tolist`` reads of a CUDA tensor."""

    def __enter__(self):
        import torch
        self.h2d = self.d2h = 0
        T = torch.Tensor
        self._orig = {n: getattr(T, n) for n in ("to", "cpu", "item",
                                                  "tolist")}
        to, cpu, item, tolist = (self._orig[n] for n in
                                 ("to", "cpu", "item", "tolist"))

        def to_(t, *a, **k):
            out = to(t, *a, **k)
            self.h2d += (not t.is_cuda) and out.is_cuda
            self.d2h += t.is_cuda and not out.is_cuda
            return out

        def cpu_(t, *a, **k):
            self.d2h += t.is_cuda
            return cpu(t, *a, **k)

        def item_(t):
            self.d2h += t.is_cuda
            return item(t)

        def tolist_(t):
            self.d2h += t.is_cuda
            return tolist(t)
        T.to, T.cpu, T.item, T.tolist = to_, cpu_, item_, tolist_
        return self

    def __exit__(self, *exc):
        import torch
        for n, f in self._orig.items():
            setattr(torch.Tensor, n, f)


def _copy_census(dev) -> dict:
    """The host<->card transfers of ``run_network(epoch_mode="fused")``
    on the fig6 world, counted at the tensor API: per epoch one gather of
    every node's RX table and one blob copy down, one blob copy up and
    one RX-row copy up per receiving node, nothing else."""
    from repro_torch.core import fused
    from repro_torch.core.rdma import run_network
    from repro_torch.kernels import ops
    nodes = _fig6_world(dev)
    receivers = len({fl.rcv.node_id
                     for fl in fused.try_pack(nodes, 10, 8).flows})
    fused.STATS.reset()
    ops.reset_launches()
    with _Copies() as copies:
        run_network(nodes, epoch_mode="fused")
    e = fused.STATS.epochs
    out = {"epochs": e, "nodes": len(nodes), "receivers": receivers,
           "h2d": copies.h2d, "d2h": copies.d2h,
           "launches": ops.launches()["fused_epoch"]}
    print(f"[fused] copy census, fig6 world, {e} epoch(s): {copies.h2d} "
          f"host-to-card transfers (1 blob + {receivers} receiving nodes' "
          f"RX rows an epoch), {copies.d2h} card-to-host (1 blob + 1 "
          f"gather of {len(nodes)} nodes' RX tables an epoch), "
          f"{out['launches']} "
          f"fused_epoch launches")
    assert e >= 1 and out["launches"] == e
    assert copies.h2d == e * (1 + receivers), out
    assert copies.d2h == e * 2, out
    return out


def phase_fused_rows(dev) -> dict:
    """Phase 9b: the committed fused rows, each fused arm beside its tick
    arm, every epoch held against epoch_ref.  Returns each path's record
    (``_fused_path``)."""
    from repro_torch.core.netsim import FabricConfig, incast_scenario
    recs = {}
    # fig6: benchmarks/fig6_multiqp.py:fused_epoch_equivalence (4:1,
    # 32 KiB; BENCH_fig6_multipath.json holds no row for it)
    arms, walls = {}, {}
    for mode in ("tick", "fused"):
        def run(mode=mode):
            return incast_scenario(
                4, message_bytes=32768, fabric_cfg=FabricConfig(
                    port_bandwidth=4, port_delay=2, queue_capacity=24,
                    seed=7), epoch_mode=mode, device=dev)
        if mode == "fused":
            res, recs["fig6_fused"] = _fused_path("fig6_fused", run)
            walls[mode] = recs["fig6_fused"]["wall_s"]
        else:
            t0 = time.perf_counter()
            res = run()
            walls[mode] = time.perf_counter() - t0
        hot = res.fabric.port_stats[0]
        arms[mode] = {"ticks": res.ticks,
                      "accepted": res.receiver.stats.accepted,
                      "tail_dropped": hot.tail_dropped,
                      "max_queue": hot.max_depth,
                      "retransmissions": sum(s.stats.retransmissions
                                             for s in res.senders)}
        for i, d in enumerate(res.payloads):
            assert (res.receiver._qp_buffer[i + 1][1][:len(d)] == d).all()
    assert arms["tick"] == arms["fused"], arms
    assert recs["fig6_fused"]["launches"]["fused_epoch"] > 0
    print(f"[fused] fig6 fused_epoch_equivalence 4:1 32 KiB: fused == tick "
          f"{arms['fused']}; wall_s tick={walls['tick']:.2f} fused="
          f"{walls['fused']:.2f}")
    # fig10: the streamed_fused r4 row (16 ticks, overlap 0.75, 16 tiles)
    from repro_torch.core.ingest import (BalboaIngest, IngestConfig,
                                         make_dlrm_tile_decoder)
    rows = json.loads((ROOT / "BENCH_fig10_dlrm.json").read_text())["ingest"]
    n_pkts = rows["n_pkts"]

    def fig10():
        ing = BalboaIngest(
            IngestConfig(batch_bytes=n_pkts * MTU, n_storage_nodes=4,
                         link_bw_pkts_per_tick=1, tile_pkts=2,
                         epoch_mode="fused"),
            None, _dlrm_shard_fn(n_pkts),
            tile_to_batch=make_dlrm_tile_decoder(N_DENSE, N_SPARSE, MOD),
            device=dev)
        _, rep = ing.fetch_shard_streaming(0)
        return {"ticks": rep.ticks, "nbytes": rep.nbytes,
                "goodput": rep.goodput_bytes_per_tick,
                "overlap": rep.overlap_efficiency, "tiles": rep.tiles,
                "stripes": len(rep.stripes),
                "host_bytes": ing.host_payload_bytes}
    got, rec = _fused_path("fig10_fused", fig10)
    recs["fig10_fused"] = rec
    for key in ("streamed_fused", "streamed"):
        want = {k: rows[key]["4"][k] for k in got}
        assert got == want, (key, got, want)
    print(f"[fused] fig10 streamed_fused r4 on {dev}: {got} == "
          f"BENCH_fig10_dlrm.json's streamed_fused and streamed rows "
          f"(the tick arm, phase 6a); the reference's gate refuses every "
          f"world of this row ({rec['refusals']} refusals, "
          f"{rec['epochs']} epochs)")
    # fig11: the fused ring (66 ticks, busbw 1489.45)
    want = next(r for r in json.loads((ROOT / "BENCH_fig11_allreduce.json")
                                      .read_text())["allreduce"]
                if r["mode"] == "ring")
    xs = _allreduce_tensors(want["message_bytes"] // 4, want["world"])
    base = FabricConfig(port_bandwidth=4, port_delay=2, queue_capacity=48,
                        seed=7)
    got, recs["fig11_fused"] = _fused_path(
        "fig11_fused", lambda: run_allreduce(
            dev, xs, offload=False, fabric_cfg=base, epoch_mode="fused"))
    assert got["row"] == want, (got["row"], want)
    assert recs["fig11_fused"]["launches"]["fused_epoch"] > 0
    print(f"[fused] fig11 fused ring on {dev}: ticks={got['row']['ticks']} "
          f"busbw={got['row']['busbw_B_per_tick']} == "
          f"BENCH_fig11_allreduce.json's ring row (the tick arm, phase 7a), "
          f"bit-identical to the oracle; wall_s={got['wall_s']:.2f}")
    return recs


def phase_fused(dev, keep: dict):
    """Phase 9: the telemetry plane, the committed fused rows, and the
    full-width ingest and ring in fused epochs beside their tick arms.
    Returns the launch counts of the fused paths and the ``fused_epoch``
    kernel's record for the kernel line."""
    import torch
    clock0 = _sm_clock_mhz()
    print(f"[fused] SM clock before phase 9: {clock0} MHz")
    first = time_fused_epochs(dev)
    phase_telemetry(dev)
    recs = phase_fused_rows(dev)
    census = _copy_census(dev)
    model = keep["model"]

    def same_ingest(a, b, what):
        for i, (x, y) in enumerate(zip(a["shards"], b["shards"])):
            assert x["report"] == y["report"], f"{what} shard {i}: report"
            assert torch.equal(x["sparse"], y["sparse"]), f"{what} {i}"
            assert torch.equal(x["dense"].view(torch.int32),
                               y["dense"].view(torch.int32)), f"{what} {i}"
            torch.testing.assert_close(x["logits"], y["logits"],
                                       rtol=LOGIT_RTOL, atol=LOGIT_ATOL)
    # (c) 6b's ingest in fused epochs, against 6b's kernel arm
    fused, recs["ingest_fused"] = _fused_path(
        "ingest_fused (6b's window, 64)", lambda: run_ingest(
            dev, model, None, N_SHARDS, epoch_mode="fused"), limit=3)
    same_ingest(keep["ingest"], fused, "ingest_fused")
    # the same at a window of 16 packets a QP, whose worlds fit the
    # fused core's wire: tick arm, then fused arm
    t0 = time.perf_counter()
    tick16 = run_ingest(dev, model, None, N_SHARDS, fc_window=16)
    tick16_wall = time.perf_counter() - t0
    fused16, recs["ingest_fused_w16"] = _fused_path(
        "ingest_fused_w16", lambda: run_ingest(
            dev, model, None, N_SHARDS, epoch_mode="fused", fc_window=16),
        limit=3)
    same_ingest(tick16, fused16, "ingest_fused_w16")
    assert recs["ingest_fused_w16"]["launches"]["fused_epoch"] > 0
    rep = fused16["shards"][0]["report"]
    print(f"[fused] full-width ingest, {N_SHARDS} shards: fused == tick "
          f"(reports, landed words, logits) at window 64 (0 epochs: every "
          f"world overflows the wire's 1024 slots or holds a READ) and at "
          f"window 16 (shard 0 ticks={rep[0]} tiles={rep[1]}); wall_s "
          f"tick64={keep['ingest']['wall_s']:.2f} fused64="
          f"{fused['wall_s']:.2f} tick16={tick16_wall:.2f} fused16="
          f"{fused16['wall_s']:.2f}")
    # (c) 7b's ring in fused epochs, against 7b's kernel arm
    xs = _allreduce_tensors(ALLREDUCE_ELEMS)
    ring, recs["allreduce_ring_fused"] = _fused_path(
        "allreduce_ring_fused", lambda: run_allreduce(
            dev, xs, offload=False, epoch_mode="fused"), limit=3)
    tick = keep["allreduce_ring"]
    assert ring["row"] == tick["row"] and ring["reducer"] == tick["reducer"]
    assert recs["allreduce_ring_fused"]["launches"]["fused_epoch"] > 0
    print(f"[fused] full-width ring, 4 x {ALLREDUCE_ELEMS} f32: fused == "
          f"tick (row, reducer, both bit-identical to the oracle), ticks="
          f"{ring['row']['ticks']}; wall_s tick={tick['wall_s']:.2f} "
          f"fused={ring['wall_s']:.2f}")
    for name, r in first.items():
        print(f"[fused] fused_epoch on {name}'s first epoch ({r['steps']} "
              f"ticks, {4 * r['blob_words']} B blob, picked "
              f"{r['picked']}): ms " + ", ".join(
                  f"{v} {r[v]['ms']:.4f} ({r[v]['ms_per_tick']:.5f} a tick; "
                  f"call {r[v]['call_ms']:.4f})"
                  for v in ("wrapper", "shared", "global") if v in r)
              + f"; latency bound {r['bound_design_ms']:.6f} ms at "
              f"{r['sm_clock_mhz']} MHz; epoch_ref {r['plain_ms_cpu']:.2f} "
              f"ms (CPU)")
    clock1 = _sm_clock_mhz()
    clock = max(clock0, clock1)
    print(f"[fused] SM clock after phase 9: {clock1} MHz")
    for path, rec in recs.items():
        if rec["epochs"]:
            rec["bound_design_ms_per_epoch"] = _latency_bound_ms(
                rec["serial_events"], clock) / rec["epochs"]
            print(f"[fused] {path}: latency design bound "
                  f"{rec['bound_design_ms_per_epoch']:.6f} ms an epoch "
                  f"({rec['serial_events']} serial events in "
                  f"{rec['epochs']} epochs x {SMEM_ROUND_TRIP_CYCLES} "
                  f"cycles at {clock} MHz) against "
                  f"{rec['ms_per_epoch']:.6f} ms")
    counts = {path: rec["launches"] for path, rec in recs.items()}
    main = recs["allreduce_ring_fused"]
    ring = first["allreduce ring (7b)"]
    bound, by = _bound_ms(2 * 4 * ring["blob_words"])
    record = dict(
        function="make_epoch_fn (a jitted lax.while_loop, not a Pallas "
                 "kernel)",
        max_abs_err=0, ms=ring["wrapper"]["ms"],
        ms_per_tick=ring["wrapper"]["ms_per_tick"],
        ms_from=f"events behind a sleep, the ring's first epoch "
                f"({ring['steps']} ticks)",
        call_ms=ring["wrapper"]["call_ms"],
        plain_ms=ring["plain_ms_cpu"], plain_device="cpu",
        bound_ms=bound, bound_by=by, library_ms=None,
        bound_design_ms=ring["bound_design_ms"],
        bound_design_by=f"latency: serial events x "
                        f"{SMEM_ROUND_TRIP_CYCLES} cycles",
        first_epochs=first, sm_clock_mhz=[clock0, clock1],
        residency_by_path={p: r["residency"] for p, r in recs.items()},
        blob_bytes=4 * main["blob_words"], copy_census=census,
        paths={p: {k: v for k, v in r.items() if k != "launches"}
               for p, r in recs.items()})
    print(f"[fused] fused_epoch on allreduce_ring_fused's first epoch: "
          f"ms={record['ms']} ms/tick={record['ms_per_tick']} (device) "
          f"plain_ms (epoch_ref, CPU)={record['plain_ms']} bound_ms="
          f"{bound:.6f} ({by}: the {record['blob_bytes']} B blob read and "
          f"written once) bound_design_ms={record['bound_design_ms']:.6f} "
          f"(its serial events, a shared-memory round trip each)")
    return counts, record


# ---------------------------------------------------------------------------
# phase 10: data-parallel DLRM training over the allreduce
# ---------------------------------------------------------------------------

# the full DLRM's parameters (26 x 100,000 x 64 tables, bottom MLP
# 154,944, top MLP 344,577), the largest bucket the fused ring takes in
# one allreduce (try_pack's plan holds 512 rows a flow: 4 ranks x 512
# packets x 4 KiB), and the script's wall under which the full-width arm
# takes a second step
FULL_PARAMS = 26 * 100_000 * 64 + 154_944 + 344_577
DLRM_FIRST_LOSS_ATOL = 1e-5     # 10a's first loss, card vs CPU
FULL_BUCKET_ELEMS = 4 * 512 * 4096 // 4
SECOND_STEP_WALL_S = 300.0


class _ExchangeClock:
    """While entered, sums the host time of the fused ring's pieces
    (``try_pack``, ``_apply``, the folds' round trips) and the
    ``fused_epoch`` calls by CUDA events (the wrapper's host work
    included), and turns a refused or aborted fused epoch into an
    error: the full-width ring must not fall back to per-tick
    stepping."""

    def __enter__(self):
        import torch
        from repro_torch.core import collectives, fused
        from repro_torch.kernels import fused_epoch as fe
        self.s = {"try_pack": 0.0, "apply": 0.0, "fold": 0.0}
        self.events = []
        self._orig = [(fused, "try_pack"), (fused, "_apply"),
                      (collectives, "_fold_on"), (fe, "fused_epoch"),
                      (fused, "run_fused_epoch")]
        self._orig = [(m, n, getattr(m, n)) for m, n in self._orig]
        timed = {"try_pack": fused.try_pack, "apply": fused._apply,
                 "fold": collectives._fold_on}

        def clocked(key):
            fn = timed[key]

            def run(*a, **k):
                t0 = time.perf_counter()
                try:
                    return fn(*a, **k)
                finally:
                    self.s[key] += time.perf_counter() - t0
            return run
        epoch = fe.fused_epoch

        def epoch_timed(blob, skey):
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            ev[0].record()
            out = epoch(blob, skey)
            ev[1].record()
            self.events.append(ev)
            return out
        run_epoch = fused.run_fused_epoch

        def loud(nodes, *a, **k):
            res = run_epoch(nodes, *a, **k)
            if res is None:
                raise RuntimeError(
                    f"the full-width ring left the fused core "
                    f"({fused.STATS.snapshot()}): per-tick stepping would "
                    f"carry the rest")
            return res
        fused.try_pack, fused._apply = clocked("try_pack"), clocked("apply")
        collectives._fold_on = clocked("fold")
        fe.fused_epoch, fused.run_fused_epoch = epoch_timed, loud
        return self

    def epoch_ms(self) -> float:
        import torch
        torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in self.events)

    def __exit__(self, *exc):
        for m, n, f in self._orig:
            setattr(m, n, f)


def phase_dlrm_exchange(dev) -> dict:
    """Phase 10a: ``repro_torch.examples.allreduce_dlrm`` as the
    reference runs it (smoke DLRM, 4 workers x 64 records, 8 steps, the
    offload): the example asserts every step's sums bit-identical to
    ``allreduce_oracle``, the parameters bit-identical to the oracle
    fold and a falling loss.  One step of the same example on the CPU,
    from the same seeded weights, gives the card's first loss within
    ``DLRM_FIRST_LOSS_ATOL``."""
    import torch
    from repro_torch.examples import allreduce_dlrm as ex
    from repro_torch.kernels import ops
    ops.reset_launches()
    t0 = time.perf_counter()
    out = ex.main(device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launched = ops.launches()
    assert len(out["losses"]) == ex.STEPS
    assert out["losses"][-1] < out["losses"][0]
    # the same weights as a CPU run (drawn on a CPU generator): the first
    # step's loss agrees
    host = ex.main(device="cpu", steps=1)["losses"][0]
    first_err = abs(out["losses"][0] - host)
    print(f"[exchange] (a) first loss on the card {out['losses'][0]:.7f}, "
          f"on the CPU {host:.7f}: |diff| {first_err:.2e} (bound "
          f"{DLRM_FIRST_LOSS_ATOL})")
    assert first_err < DLRM_FIRST_LOSS_ATOL, (out["losses"][0], host)
    assert launched["reduce_fold"] > 0, "the exchange folded nothing on " \
        "the card"
    print(f"[exchange] (a) smoke DLRM, {ex.WORLD} workers x "
          f"{ex.RECORDS_PER_WORKER} records, {out['n_grad']} f32 a "
          f"gradient, {ex.STEPS} steps over the offload: loss per step "
          + ", ".join(f"{v:.4f}" for v in out["losses"])
          + f"; every sum bit-identical to the oracle, parameters "
          f"bit-identical to the oracle fold; fabric ticks={out['ticks']} "
          f"absorbed={out['absorbed']} wall_s={wall:.2f} (steps "
          f"{out['wall_s']:.2f}); launches {launched}")
    return {"dlrm_exchange": launched}


def phase_dlrm_full_width(dev, t_start: float) -> dict:
    """Phase 10b: the full ``config()`` DLRM (166,899,521 parameters) on
    the card, 4 workers x 64 records, lr 0.05: each worker's gradient
    raveled in the reference's order and copied to the host, exchanged
    by the fused ring in buckets of at most ``FULL_BUCKET_ELEMS``
    (``CollectiveGroup.allreduce_bucketed``, one group sized for the
    largest bucket), the joined sums held bit for bit against
    ``allreduce_oracle`` of the whole gradients for every rank, with no
    fused epoch refused or aborted; then the averaged update.  One step,
    and a second while the script's wall stays under
    ``SECOND_STEP_WALL_S``."""
    import torch
    from repro_torch.configs.dlrm import config
    from repro_torch.core import fused
    from repro_torch.core.collectives import allreduce_oracle, make_ring_group
    from repro_torch.examples import allreduce_dlrm as ex
    from repro_torch.kernels import ops
    from repro_torch.models.dlrm import DLRM, ravel_params
    cfg = config()
    model = DLRM(cfg, seed=0, device=dev)
    n = ravel_params(model).numel()
    assert n == FULL_PARAMS, n
    world = ex.WORLD
    chunk = -(-n // world)
    n_buckets = -(-chunk // (FULL_BUCKET_ELEMS // world))
    group = make_ring_group(world, FULL_BUCKET_ELEMS * 4 + world * 4,
                            offload=False, epoch_mode="fused", device=dev)
    batches = [ex.worker_batch(cfg, r, dev) for r in range(world)]
    fused.STATS.reset()
    ops.reset_launches()
    steps = []
    while True:
        t0 = time.perf_counter()
        flats, losses, d2h = [], [], 0.0
        for b in batches:
            model.zero_grad(set_to_none=True)
            loss, _ = model.loss(b)
            loss.backward()
            g = ravel_params(model, grad=True)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            flats.append(g.cpu().numpy())
            d2h += time.perf_counter() - t1
            losses.append(loss.item())
            del g
        model.zero_grad(set_to_none=True)
        t_grad = time.perf_counter() - t0
        epochs0 = fused.STATS.epochs
        t1 = time.perf_counter()
        with _ExchangeClock() as clock:
            summed = group.allreduce_bucketed(flats, FULL_BUCKET_ELEMS)
            epoch_ms = clock.epoch_ms()
        t_exchange = time.perf_counter() - t1
        t1 = time.perf_counter()
        want = allreduce_oracle(flats)
        for r in range(world):
            assert (summed[r].view(np.uint32) == want.view(np.uint32)).all(
            ), f"full width: rank {r} not bit-identical to the oracle"
        t_check = time.perf_counter() - t1
        ex.sgd_apply(model, summed[0], world)
        torch.cuda.synchronize()
        del want, flats
        st = fused.STATS.snapshot()
        assert st["refusals"] == 0 and st["aborts"] == 0, st
        rec = dict(loss=float(np.mean(losses)), epochs=st["epochs"] - epochs0,
                   epoch_call_ms=epoch_ms, try_pack_s=clock.s["try_pack"],
                   apply_s=clock.s["apply"], fold_s=clock.s["fold"],
                   grad_d2h_s=d2h, grad_s=t_grad, exchange_s=t_exchange,
                   check_s=t_check, wall_s=time.perf_counter() - t0)
        steps.append(rec)
        host = rec["try_pack_s"] + rec["apply_s"] + rec["fold_s"] + d2h
        print(f"[exchange] (b) full width, step {len(steps) - 1}: loss "
              f"{rec['loss']:.4f}; {n} f32 a worker in {n_buckets} buckets "
              f"of <= {FULL_BUCKET_ELEMS}: {rec['epochs']} fused epochs, "
              f"fused_epoch calls {epoch_ms / 1e3:.3f} s (CUDA events), "
              f"host {host:.2f} s (try_pack {rec['try_pack_s']:.2f}, _apply "
              f"{rec['apply_s']:.2f}, folds {rec['fold_s']:.2f}, gradient "
              f"D2H {d2h:.2f}); exchange {t_exchange:.2f} s, gradients "
              f"{t_grad:.2f} s, oracle check {t_check:.2f} s, step wall "
              f"{rec['wall_s']:.2f} s; every rank bit-identical to "
              f"allreduce_oracle, 0 refusals, 0 aborts")
        if len(steps) == 2 or (time.perf_counter() - t_start
                               + rec["wall_s"] > SECOND_STEP_WALL_S):
            break
    launched = ops.launches()
    assert launched["fused_epoch"] == fused.STATS.epochs > 0, launched
    assert launched["reduce_fold"] > 0, launched
    print(f"[exchange] (b) {len(steps)} step(s), {fused.STATS.epochs} "
          f"epochs ({fused.STATS.ticks} ticks), launches {launched}")
    return {"dlrm_exchange_full": launched}


# ---------------------------------------------------------------------------
# phase 11: the host-sync census on the card and on the CPU
# ---------------------------------------------------------------------------

def phase_census(dev) -> dict:
    """``repro_torch.analysis.census.run_census`` on the card, then on the
    CPU in this process, beside ``BENCH_sync_census.json``'s bar (the
    reference's counts of its own call sites); the ticks must agree,
    and every call site whose count differs between the two runs is
    listed."""
    from repro_torch.analysis.census import run_census
    bench = json.loads((ROOT / "BENCH_sync_census.json").read_text())
    bench = bench["census"]
    card = run_census(dev)["census"]
    host = run_census("cpu")["census"]
    print("[census] arm          ticks  d2h/tick card  cpu     ref    "
          "h2d/tick card  cpu     ref")
    for arm in bench:
        c, h, b = card[arm], host[arm], bench[arm]
        print(f"[census] {arm:12s} {c['ticks']:5d}  {c['d2h_per_tick']:13.4f}"
              f"  {h['d2h_per_tick']:6.4f}  {b['d2h_per_tick']:7.4f}"
              f"  {c['h2d_per_tick']:13.4f}  {h['h2d_per_tick']:6.4f}"
              f"  {b['h2d_per_tick']:7.4f}")
        assert c["ticks"] == h["ticks"] == b["ticks"], (arm, c, h, b)
        for kind in ("d2h", "h2d"):
            sites = sorted(set(c["sites"][kind]) | set(h["sites"][kind]))
            for s in sites:
                nc, nh = (c["sites"][kind].get(s, 0),
                          h["sites"][kind].get(s, 0))
                if nc != nh:
                    print(f"[census] {arm} {kind} differs at {s}: card "
                          f"{nc}, cpu {nh}")
    print(f"[census] ticks equal on card, CPU and BENCH_sync_census.json "
          f"in all {len(bench)} arms")
    return {"card": card, "cpu": host}


# ---------------------------------------------------------------------------
# phase 12: the LM model stack, served on the card
# ---------------------------------------------------------------------------

LM_BATCH, LM_PROMPT, LM_GEN = 2, 24, 8          # 12a, every smoke arch
LM_CARD_ATOL = 1e-4     # float32 logits, card vs CPU, TF32 off
FULL_ARCH = "gemma2-2b"
FULL_BATCH, FULL_PROMPT, FULL_GEN = 4, 32, 16   # the reference's defaults
DECODE_CACHE = FULL_PROMPT + FULL_GEN           # 12b's one measured step
FULL_PARAMS_LM = 2_614_341_888
DECODE_FORWARD_BOUND = 2e-3                     # tests/test_models.py:80
TRUNC_ATOL = 1e-3       # 2-layer full-width truncation, card vs CPU, f32


def _replay_logits(model, pre, tokens) -> list:
    """The logits of a served run, step by step: the prefill's, then one
    decode step's for each of ``tokens``' columns but the last, fed that
    column (the run's own greedy choices)."""
    import torch
    from repro_torch.launch.serve import ENC_LEN
    b, p = pre["tokens"].shape
    gen = tokens.shape[1]
    cache = model.init_cache(b, p + gen,
                             enc_len=ENC_LEN if model.cfg.is_encdec else 0)
    lg, cache = model.prefill(pre, cache)
    out = [lg]
    toks = tokens.to(model.device)
    for t in range(gen - 1):
        lg, cache = model.decode_step(cache, toks[:, t:t + 1], p + t)
        out.append(lg)
    return [x.float().cpu() for x in out]


def _device_busy(fn) -> dict:
    """One call of ``fn`` in a torch.profiler trace (CUDA activity): its
    kernels' count, the time the card was busy (the union of the kernel
    events' intervals, ms), the five kernels by summed device time, the
    call's wall (host clock to a synchronize, in the trace, ms) and what
    ``fn`` returned."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and e.time_range.elapsed_us() > 0)
    busy, end, by_name = 0, None, {}
    for t0, t1, name in spans:
        by_name[name] = by_name.get(name, 0) + (t1 - t0)
        if end is None or t0 >= end:
            busy += t1 - t0
            end = t1
        elif t1 > end:
            busy += t1 - end
            end = t1
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    return {"kernels": len(spans), "busy_ms": busy / 1e3,
            "top": [(name[:60], us / 1e3) for name, us in top],
            "wall_ms": wall * 1e3, "out": out}


def phase_lm_smoke(dev) -> dict:
    """Phase 12a: every smoke arch at float32 compute on the card and on
    the CPU from the same weights (drawn once, on the CPU) and prompts:
    ``serve_batch`` on the card, from the seed, gives the CPU's greedy
    tokens; the prefill's and every decode step's logits within
    ``LM_CARD_ATOL``.  Then ``repro_torch.examples.serve.main()`` on the
    card, at the configs' own bf16 compute."""
    import torch
    from repro_torch.configs import ALL_ARCHS, get_smoke_config
    from repro_torch.examples import serve as ex
    from repro_torch.launch.serve import generate, prefill_batch, serve_batch
    from repro_torch.models.model import Model
    t0 = time.perf_counter()
    worst = {}
    for arch in ALL_ARCHS:
        cfg = get_smoke_config(arch).replace(compute_dtype="float32")
        host = Model(cfg, device="cpu").init_params(0)
        card = Model(cfg, device=dev)
        card.load_state_dict(host.state_dict())
        pre_h = prefill_batch(cfg, LM_BATCH, LM_PROMPT, device="cpu")
        pre_c = prefill_batch(cfg, LM_BATCH, LM_PROMPT, device=dev)
        tok_h = generate(host, pre_h, LM_GEN)[0]
        tok_c, t_p, t_d = serve_batch(cfg, card, LM_BATCH, LM_PROMPT, LM_GEN,
                                      device=dev)
        assert tok_c.device.type == dev.type
        assert torch.equal(tok_c.cpu(), tok_h), \
            f"{arch}: greedy tokens differ, card {tok_c.tolist()} cpu " \
            f"{tok_h.tolist()}"
        errs = [float((a - b).abs().max()) for a, b in zip(
            _replay_logits(card, pre_c, tok_h),
            _replay_logits(host, pre_h, tok_h))]
        worst[arch] = max(errs)
        print(f"[lm] (a) {arch:18s} f32 batch {LM_BATCH} x prompt "
              f"{LM_PROMPT} + {LM_GEN} tokens: tokens equal to the CPU's "
              f"{tok_h[0].tolist()}; logits max abs err prefill "
              f"{errs[0]:.2e}, decode {max(errs[1:]):.2e}; card prefill "
              f"{t_p * 1e3:.1f} ms, decode {t_d * 1e3:.1f} ms")
        assert worst[arch] < LM_CARD_ATOL, (arch, errs)
    t_a = time.perf_counter() - t0
    t1 = time.perf_counter()
    out = ex.main(device=dev)
    for arch, rec in out.items():
        assert rec["tokens"].shape == (4, 16), arch
    t_ex = time.perf_counter() - t1
    print(f"[lm] (a) ten archs in {t_a:.1f} s (worst logits err "
          f"{max(worst.values()):.2e} < {LM_CARD_ATOL}); "
          f"repro_torch.examples.serve.main() on the card (bf16) in "
          f"{t_ex:.1f} s")
    return {"worst_logits_err": worst, "wall_s": t_a + t_ex}


def phase_lm_full_width(dev, smi: str) -> dict:
    """Phase 12b: gemma2-2b's full ``config()`` (26 layers, d_model
    2304, vocab 256,000; 2,614,341,888 float32 parameters) on the card.
    Its weights are drawn on a CUDA generator (seed 0) to save the
    host's time; the serving loop is ``serve_batch``'s (``generate``) at
    the reference's defaults: batch 4, prompt 32, 16 new tokens, bf16
    compute.  Then, at float32 compute on the same weights: decode after
    a 32-token prefill equals the 33-token forward within
    ``DECODE_FORWARD_BOUND``; and a 2-layer truncation (the card model's
    embedding, first block and final norm) gives the same logits on the
    card and on the CPU within ``TRUNC_ATOL``."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import generate, prefill_batch
    from repro_torch.models.model import Model
    from repro_torch.train.step import make_decode_step
    cfg = get_config(FULL_ARCH)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    model = Model(cfg, device=dev)
    model.init_params(generator=torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize(dev)
    t_init = time.perf_counter() - t0
    n = sum(p.numel() for p in model.parameters())
    assert n == FULL_PARAMS_LM, n
    pre = prefill_batch(cfg, FULL_BATCH, FULL_PROMPT, device=dev)
    generate(model, pre, 2)                     # warm-up: first launches
    tokens, t_p, t_d = generate(model, pre, FULL_GEN)
    logits = _replay_logits(model, pre, tokens)
    assert all(bool(torch.isfinite(x).all()) for x in logits), \
        "full width: non-finite logits"
    assert logits[0].shape == (FULL_BATCH, 1, cfg.vocab)
    peak = torch.cuda.max_memory_allocated(dev)
    n_dec = FULL_BATCH * (FULL_GEN - 1)
    # one decode step in a trace: how busy the card is in a step's wall
    cache = model.init_cache(FULL_BATCH, FULL_PROMPT + 1)
    _, cache = model.prefill(pre, cache)
    busy = _device_busy(lambda: model.decode_step(
        cache, tokens[:, :1], FULL_PROMPT))
    step_ms = t_d * 1e3 / (FULL_GEN - 1)
    weight_bytes = sum(p.numel() * p.element_size()
                       for p in model.parameters())
    del cache
    # one decode step's peak, the serving loop's last (a cache of prompt
    # + new tokens), for phase 14c's walk of the same step
    decode = make_decode_step(model)
    cache = model.init_cache(FULL_BATCH, DECODE_CACHE)
    _, cache = model.prefill(pre, cache)
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    decode(cache, tokens[:, :1], DECODE_CACHE - 1)
    torch.cuda.synchronize(dev)
    decode_peak = torch.cuda.max_memory_allocated(dev)
    del cache
    print(f"[lm] (b) {FULL_ARCH} full width on {smi}: {n:,} params "
          f"(f32), init {t_init:.2f} s (CUDA generator); batch "
          f"{FULL_BATCH} x prompt {FULL_PROMPT} + {FULL_GEN} tokens, bf16: "
          f"prefill {t_p * 1e3:.2f} ms, decode {t_d * 1e3:.2f} ms for "
          f"{FULL_GEN - 1} steps ({t_d * 1e3 / (FULL_GEN - 1):.2f} ms a "
          f"step, {n_dec / t_d:.1f} tok/s); logits finite; "
          f"max_memory_allocated {peak / 2**30:.2f} GiB; sample "
          f"{tokens[0].tolist()}")
    print(f"[lm] (b) one bf16 decode step traced: {busy['kernels']} "
          f"kernels, the card busy {busy['busy_ms']:.2f} ms of the "
          f"{step_ms:.2f} ms step ({100 * busy['busy_ms'] / step_ms:.1f} %"
          f"); reading the {weight_bytes:,} B of weights once takes "
          f"{weight_bytes / HBM_BYTES_PER_S * 1e3:.2f} ms at 3.35 TB/s; "
          f"largest kernels (ms): " + ", ".join(
              f"{name} {ms:.3f}" for name, ms in busy["top"]))
    print(f"[lm] (b) one bf16 decode step, batch {FULL_BATCH}, cache "
          f"{DECODE_CACHE}: max_memory_allocated {decode_peak:,} B")
    rec = {"params": n, "init_s": t_init, "prefill_ms": t_p * 1e3,
           "decode_ms": t_d * 1e3, "decode_tok_s": n_dec / t_d,
           "max_memory_allocated": peak, "device": smi,
           "decode_step_peak": decode_peak,
           "decode_step_busy_ms": busy["busy_ms"],
           "decode_step_kernels": busy["kernels"]}

    # (1) f32: decode after a 32-token prefill == the 33-token forward
    model.cfg = cfg.replace(compute_dtype="float32")   # same weights
    gen = torch.Generator().manual_seed(7)
    toks = torch.randint(0, cfg.vocab, (FULL_BATCH, FULL_PROMPT + 1),
                         generator=gen, dtype=torch.int32).to(dev)
    with torch.no_grad():
        full = model.forward({"tokens": toks}, train=False)[0]
    cache = model.init_cache(FULL_BATCH, FULL_PROMPT + 8)
    _, cache = model.prefill({"tokens": toks[:, :FULL_PROMPT]}, cache)
    lg, _ = model.decode_step(cache, toks[:, FULL_PROMPT:], FULL_PROMPT)
    err = float((lg[:, 0] - full[:, FULL_PROMPT]).abs().max())
    print(f"[lm] (b) f32, {cfg.n_layers} layers: decode of token 33 after a 32-token "
          f"prefill vs the 33-token forward, max abs err {err:.3e} "
          f"(bound {DECODE_FORWARD_BOUND})")
    assert err < DECODE_FORWARD_BOUND, err
    rec["decode_vs_forward_err"] = err
    del full, cache, lg

    # (2) a 2-layer truncation of the card model, card vs CPU
    cfg2 = cfg.replace(n_layers=2, compute_dtype="float32")
    sd = model.state_dict()
    sub = {k: v for k, v in sd.items()
           if not k.startswith("decoder.") or k.startswith("decoder.blocks.0.")}
    card2 = Model(cfg2, device=dev)
    card2.load_state_dict(sub)
    del model, sd
    host2 = Model(cfg2, device="cpu")
    host2.load_state_dict({k: v.cpu() for k, v in sub.items()})
    del sub
    batch = {"tokens": pre["tokens"]}
    with torch.no_grad():
        lc = card2.forward(batch, train=False)[0].cpu()
        lh = host2.forward({"tokens": pre["tokens"].cpu()}, train=False)[0]
    err2 = float((lc - lh).abs().max())
    print(f"[lm] (b) f32, 2-layer truncation (embedding, block 0, final "
          f"norm of the card model): card vs CPU logits {tuple(lc.shape)} "
          f"max abs err {err2:.3e} (bound {TRUNC_ATOL}; logits up to "
          f"{float(lh.abs().max()):.2f})")
    assert err2 < TRUNC_ATOL, err2
    rec["truncation_err"] = err2
    return rec



# ---------------------------------------------------------------------------
# phase 13: LM training on the card
# ---------------------------------------------------------------------------

TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 2, 1024, 3    # 13b, full width
TRAIN_LR = 1e-4
TRUNC_BATCH, TRUNC_SEQ = 2, 64                      # 13b's truncation
# the truncation's float32 step, card vs CPU (TF32 off): the loss within
# TRAIN_TRUNC_LOSS_ATOL; AdamW's first update is about lr * sign(g), and
# a gradient within float order of 0 may take the other sign, so each
# new parameter within TRAIN_TRUNC_ELEM_LR x lr, each leaf's error norm
# within TRAIN_TRUNC_NORM_RTOL of its update's norm, and the slots within
# TRAIN_TRUNC_SLOT_RTOL of their leaf's largest magnitude
TRAIN_TRUNC_LOSS_ATOL = 1e-4
TRAIN_TRUNC_ELEM_LR = 2.5
TRAIN_TRUNC_NORM_RTOL = 2e-2
TRAIN_TRUNC_SLOT_RTOL = 1e-3


def phase_train_smoke(dev) -> dict:
    """Phase 13a: ``repro_torch.examples.quickstart.main`` on the card
    (its checkpoints in a temp directory): the loss falls.  Then the
    smoke Trainer (granite-3-2b) crashes at step 6 and resumes from its
    step-4 checkpoint on the card."""
    import tempfile

    import torch
    from repro_torch.common.config import TrainConfig
    from repro_torch.configs import get_smoke_config
    from repro_torch.examples import quickstart
    from repro_torch.models.model import Model
    from repro_torch.train.loop import Trainer, lm_batch_iterator
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        res = quickstart.main(device=dev, checkpoint_dir=f"{d}/quickstart")
        t_qs = time.perf_counter() - t0
        assert res.steps_run == 120 and res.resumed_from is None
        assert np.isfinite(res.losses).all()
        assert res.final_loss < res.losses[0], res.losses
        print(f"[train] (a) quickstart on the card: {res.steps_run} steps, "
              f"loss {res.losses[0]:.4f} -> {res.final_loss:.4f}, wall "
              f"{t_qs:.1f} s ({t_qs / res.steps_run * 1e3:.1f} ms a step "
              f"with its checkpoints)")
        cfg = get_smoke_config("granite-3-2b")
        tc = TrainConfig(steps=10, checkpoint_every=4, learning_rate=1e-3,
                         checkpoint_dir=f"{d}/crash", log_every=100)
        m = Model(cfg, device=dev)
        try:
            Trainer(m, tc).run(lm_batch_iterator(cfg, 4, 32), crash_at=6)
            raise AssertionError("the injected failure did not raise")
        except RuntimeError as e:
            assert "injected failure at step 6" in str(e), e
        t1 = time.perf_counter()
        again = Trainer(m, tc).run(lm_batch_iterator(cfg, 4, 32))
        t_res = time.perf_counter() - t1
        assert again.resumed_from == 4 and again.steps_run == 6, again
        assert np.isfinite(again.losses).all()
        assert next(iter(m.parameters())).device.type == "cuda"
    print(f"[train] (a) crash at step 6, resumed from step 4 on the card: "
          f"steps 4..9 losses {[round(x, 4) for x in again.losses]}, "
          f"wall {t_res:.2f} s")
    return {"quickstart_losses": (res.losses[0], res.final_loss),
            "quickstart_s": t_qs, "resume_s": t_res}


def _train_step_on(model, batch, lr):
    """One float32 AdamW step of ``model`` from a zero state: (loss, the
    model's new parameters by name, the slots) on the host."""
    import torch
    from repro_torch.common.config import TrainConfig
    from repro_torch.models import params as P
    from repro_torch.train.step import make_train_step
    step, opt = make_train_step(model, TrainConfig(
        steps=1, learning_rate=lr, warmup_steps=0))
    state = P.init(opt.state_spec(model.param_spec()), torch.Generator(),
                   "float32", model.device)
    state, met = step(state, batch, 0)
    return (float(met["loss"]),
            {k: v.detach().cpu() for k, v in model.state_dict().items()},
            {f"{k}.{n}": t.cpu() for k, sl in state["slots"].items()
             for n, t in sl.items()})


def phase_train_full_width(dev, smi: str) -> dict:
    """Phase 13b: gemma2-2b's full ``config()`` trained on the card —
    ``make_train_step`` (the Trainer's step) on one batch of
    ``TRAIN_BATCH`` x ``TRAIN_SEQ`` tokens (``lm_shard``), ``TRAIN_STEPS``
    steps at lr ``TRAIN_LR``, no warmup, no checkpoint; weights on a CUDA
    generator (seed 0).  A finite loss that falls step to step; each
    step's ms, tokens/s and ``max_memory_allocated``; one more step
    traced in its two halves for the card's busy share.  Then a 2-layer
    truncation (the trained model's embedding, block 0 and final norm)
    at float32: one step on the card and on the CPU from the same
    weights and batch."""
    import torch
    from repro_torch.common.config import TrainConfig
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import lm_shard
    from repro_torch.models import params as P
    from repro_torch.models.model import Model
    from repro_torch.train.step import make_train_step
    cfg = get_config(FULL_ARCH)
    assert (cfg.param_dtype, cfg.compute_dtype, cfg.optimizer, cfg.remat) \
        == ("float32", "bfloat16", "adamw", True), cfg
    torch.cuda.reset_peak_memory_stats(dev)
    model = Model(cfg, device=dev)
    model.init_params(generator=torch.Generator(device=dev).manual_seed(0))
    step, opt = make_train_step(model, TrainConfig(
        steps=TRAIN_STEPS, learning_rate=TRAIN_LR, warmup_steps=0))
    state = P.init(opt.state_spec(model.param_spec()), torch.Generator(),
                   "float32", dev)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in lm_shard(
        0, TRAIN_BATCH, TRAIN_SEQ, cfg.vocab, seed=0).items()}
    n_tok = TRAIN_BATCH * TRAIN_SEQ
    weight_bytes = sum(p.numel() * p.element_size()
                       for p in model.parameters())
    print(f"[train] (b) {FULL_ARCH} full width on {smi}: "
          f"{sum(p.numel() for p in model.parameters()):,} f32 params "
          f"({weight_bytes:,} B), AdamW state {2 * weight_bytes:,} B; "
          f"batch {TRAIN_BATCH} x {TRAIN_SEQ}, bf16 compute, remat on, "
          f"lr {TRAIN_LR}")
    losses, recs = [], []
    for i in range(TRAIN_STEPS):
        torch.cuda.reset_peak_memory_stats(dev)
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        state, met = step(state, batch, i)
        loss = float(met["loss"])
        torch.cuda.synchronize(dev)
        dt = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated(dev)
        losses.append(loss)
        recs.append({"ms": dt * 1e3, "tokens_s": n_tok / dt,
                     "max_memory_allocated": peak, "loss": loss,
                     "grad_norm": float(met["grad_norm"])})
        print(f"[train] (b) step {i}: loss {loss:.6f}, grad_norm "
              f"{recs[-1]['grad_norm']:.4f}, {dt * 1e3:.1f} ms, "
              f"{n_tok / dt:,.0f} tokens/s, max_memory_allocated "
              f"{peak / 2**30:.2f} GiB ({peak:,} B)")
    assert np.isfinite(losses).all(), losses
    assert all(b < a for a, b in zip(losses, losses[1:])), \
        f"full width: the loss did not fall step to step: {losses}"
    # one more step, in its halves, each in a trace
    fb = _device_busy(lambda: step.forward_backward(batch))
    up = _device_busy(lambda: step.apply_update(state, fb["out"],
                                                TRAIN_STEPS))
    state = up["out"][0]
    for name, b in (("forward+backward", fb), ("optimizer", up)):
        print(f"[train] (b) traced step, {name}: {b['kernels']} kernels, "
              f"the card busy {b['busy_ms']:.2f} ms of {b['wall_ms']:.2f} "
              f"ms ({100 * b['busy_ms'] / b['wall_ms']:.1f} %); largest "
              f"kernels (ms): " + ", ".join(
                  f"{k} {ms:.3f}" for k, ms in b["top"]))
    busy = {"fwd_bwd": {k: fb[k] for k in ("kernels", "busy_ms", "wall_ms")},
            "optimizer": {k: up[k] for k in ("kernels", "busy_ms",
                                              "wall_ms")}}

    # a 2-layer truncation of the trained model at float32, card vs CPU
    cfg2 = cfg.replace(n_layers=2, compute_dtype="float32")
    sub = {k: v.cpu() for k, v in model.state_dict().items()
           if not k.startswith("decoder.")
           or k.startswith("decoder.blocks.0.")}
    del model, state, step, opt, batch, met, fb, up
    torch.cuda.empty_cache()
    tb = {k: torch.from_numpy(v) for k, v in lm_shard(
        1, TRUNC_BATCH, TRUNC_SEQ, cfg.vocab, seed=0).items()}
    runs = {}
    for name, where in (("card", dev), ("cpu", torch.device("cpu"))):
        m2 = Model(cfg2, device=where)
        m2.load_state_dict(sub)
        t0 = time.perf_counter()
        runs[name] = _train_step_on(
            m2, {k: v.to(where) for k, v in tb.items()}, TRAIN_LR)
        runs[name + "_s"] = time.perf_counter() - t0
        del m2
    (lc, pc, sc), (lh, ph, sh) = runs["card"], runs["cpu"]
    loss_err = abs(lc - lh)
    elem = {k: float((pc[k] - ph[k]).abs().max()) / TRAIN_LR for k in ph}
    norm = {}
    for k in ph:
        moved = float((ph[k] - sub[k]).norm())
        norm[k] = float((pc[k] - ph[k]).norm()) / max(moved, 1e-30)
    slot = {k: float((sc[k] - sh[k]).abs().max())
            / max(float(sh[k].abs().max()), 1e-30) for k in sh}
    we, wn, ws = (max(d, key=d.get) for d in (elem, norm, slot))
    print(f"[train] (b) f32, 2-layer truncation, one AdamW step of batch "
          f"{TRUNC_BATCH} x {TRUNC_SEQ} (card {runs['card_s']:.2f} s, CPU "
          f"{runs['cpu_s']:.2f} s): loss card {lc:.6f} CPU {lh:.6f} (err "
          f"{loss_err:.2e}, bound {TRAIN_TRUNC_LOSS_ATOL}); new params worst "
          f"{elem[we]:.3f} x lr ({we}; bound {TRAIN_TRUNC_ELEM_LR}), worst "
          f"error norm over update norm {norm[wn]:.2e} ({wn}; bound "
          f"{TRAIN_TRUNC_NORM_RTOL}); slots worst rel {slot[ws]:.2e} ({ws};"
          f" bound {TRAIN_TRUNC_SLOT_RTOL})")
    assert loss_err < TRAIN_TRUNC_LOSS_ATOL, loss_err
    assert elem[we] < TRAIN_TRUNC_ELEM_LR, (we, elem[we])
    assert norm[wn] < TRAIN_TRUNC_NORM_RTOL, (wn, norm[wn])
    assert slot[ws] < TRAIN_TRUNC_SLOT_RTOL, (ws, slot[ws])
    return {"losses": losses, "steps": recs, "busy": busy, "device": smi,
            "truncation": {"loss_err": loss_err, "elem_lr": elem[we],
                           "norm_rel": norm[wn], "slot_rel": slot[ws]}}



# ---------------------------------------------------------------------------
# phase 14: the mesh layer
# ---------------------------------------------------------------------------

# the reference's compiled memory analysis of gemma2-2b x train_4k on its
# 16x16 mesh (Auto axes; tests/test_torch_mesh_dryrun.py holds the port
# to it on the CPU)
DRYRUN_ARG_BYTES = 384_748_552
DRYRUN_FALLBACKS = ("kv_heads=4 !-> ('model',) (indivisible)",
                    "heads=8 !-> ('model',) (indivisible)")
# ... and one SPMD partition of that cell in the reference's HLO (its
# hlo_analysis; the dot FLOPs with while bodies times their trip count),
# which the port's DTensor walk is held to: alias bytes exactly, dot
# FLOPs within DRYRUN_DOT_RTOL, collective traffic within a factor
# DRYRUN_COLL_FACTOR (the reference's CPU compile carries its dots'
# results, and so their collectives, in float32; the port's are bf16),
# and the elements each kind of collective moves within
# DRYRUN_ELEMENTS_RTOL, a kind the reference lacks under
# DRYRUN_EXTRA_SHARE of the port's elements
DRYRUN_REF = {"alias_bytes": 384_224_260, "output_bytes": 384_224_904,
              "temp_bytes": 86_495_514_968,
              "dot_flops": 445_203_425_001_472,
              "flops": 449_907_023_205_441, "bytes": 14_411_385_345_458,
              "coll_traffic": 126_633_775_156,
              "coll_elements": {"all-reduce(g=16)": 16_206_147_864,
                                "all-gather(g=16)": 981_041_152,
                                "all-to-all(g=16)": 301_989_888,
                                "collective-permute(g=256)": 69_074_944}}
DRYRUN_DOT_RTOL = 0.10
DRYRUN_COLL_FACTOR = 2.0
DRYRUN_ELEMENTS_RTOL = 0.01
DRYRUN_EXTRA_SHARE = 1e-3
# a train or prefill cell's temp bytes (its working memory beyond
# arguments and outputs: eager's buffers against XLA's) at most this
# factor of the reference's, where the reference's is committed
DRYRUN_TEMP_FACTOR = 2.5
# ... and of granite-3-2b x train_4k, whose 32 query heads over 8 KV
# heads GSPMD splits over "model" cut into 8 x 2 (tests/_dryrun_ref.py
# on the CPU; the port walks that cell on a mesh so cut and is held to
# it as to DRYRUN_REF, each kind including the all-gathers over the 8
# and the all-reduces over the 2, and with no op run replicated)
DRYRUN_GQA_ARCH = "granite-3-2b"
DRYRUN_GQA_REF = {"argument_bytes": 251_032_072, "alias_bytes": 250_507_780,
                  "output_bytes": 250_508_112,
                  "dot_flops": 154_345_605_693_440,
                  "coll_traffic": 256_339_838_192.5,
                  "coll_elements": {"all-reduce(g=16)": 32_377_047_823,
                                    "all-gather(g=16)": 696_260_608,
                                    "all-gather(g=8)": 2_684_354_560,
                                    "all-reduce(g=2)": 335_544_320,
                                    "collective-permute(g=256)": 40_896_000}}
DRYRUN_GQA_FALLBACKS = ("kv_heads=8 !-> ('model',) (indivisible)",
                        "vocab=49155 !-> ('model',) (indivisible)")
# ... and of deepseek-v3-671b x decode_32k, whose MoE takes the
# reference's flat (decode) branch, partitioned as GSPMD partitions it
# (tests/_dryrun_ref.py on the CPU): its all-to-alls around the
# concatenation of the tokens and the zero row, the collective-permutes
# of the bucket gather and of the combined rows, held as DRYRUN_GQA_REF
# is, its dot FLOPs within DRYRUN_MOE_DOT_RTOL
DRYRUN_MOE_ARCH, DRYRUN_MOE_SHAPE = "deepseek-v3-671b", "decode_32k"
DRYRUN_MOE_REF = {"argument_bytes": 27_486_920_740,
                  "alias_bytes": 18_421_383_168,
                  "output_bytes": 18_421_383_272,
                  "dot_flops": 391_744_585_728,
                  "coll_traffic": 1_767_069_888,
                  "coll_elements": {"all-reduce(g=16)": 223_774_720,
                                    "all-to-all(g=16)": 7_074_816,
                                    "all-gather(g=16)": 1_960_192,
                                    "collective-permute(g=256)": 13_719_552}}
DRYRUN_MOE_FALLBACKS = "no sharding fallbacks"
DRYRUN_MOE_DOT_RTOL = 0.01
# ... and of gemma2-27b x long_500k, a decode step over a 524,288-token
# cache whose sequence is split over "model" while its 32 query heads
# split there too: the queries moved to the free "data" and gathered
# there for the scores, the value product run split over "data" with a
# block of partial sums reduced over "model" and moved back, the new
# key and value gathered for the cache's write (tests/_dryrun_ref.py on
# the CPU), held as DRYRUN_MOE_REF is
DRYRUN_LONG_ARCH, DRYRUN_LONG_SHAPE = "gemma2-27b", "long_500k"
DRYRUN_LONG_REF = {"argument_bytes": 13_035_267_080,
                   "alias_bytes": 6_225_288_192,
                   "output_bytes": 6_225_288_252,
                   "dot_flops": 10_014_425_088,
                   "coll_traffic": 4_831_928,
                   "coll_elements": {"all-reduce(g=16)": 443_264,
                                     "all-gather(g=16)": 376_864,
                                     "collective-permute(g=256)": 23_552}}
# ... and of three cells torch 2.11 (the card's) walked apart from torch
# 2.13 before the port partitioned them itself (tests/_dryrun_ref.py on
# the CPU), each held as DRYRUN_MOE_REF is: xlstm-125m x train_4k (the
# xLSTM blocks' split residual, chunks kept split by permutes, q/k/v
# reduced by the heads' cut, the sLSTM's split state), gemma2-27b x
# train_4k (attention's batched einsums over a batch split over "data"
# and heads over "model", which DTensor 2.11's flattening view
# refuses) and deepseek-v3-671b x prefill_32k (MLA's einsums likewise,
# and the cache's pad, which DTensor 2.11 fails to redistribute)
DRYRUN_XLSTM_ARCH, DRYRUN_XLSTM_SHAPE = "xlstm-125m", "train_4k"
DRYRUN_XLSTM_REF = {"argument_bytes": 79_590_088,
                    "alias_bytes": 36_091_588,
                    "output_bytes": 38_777_640,
                    "dot_flops": 4_664_837_799_936,
                    "coll_traffic": 84_079_599_654,
                    "coll_elements": {"all-gather(g=16)": 4_742_197_248,
                                      "collective-permute(g=256)":
                                      1_466_211_072,
                                      "all-reduce(g=16)": 3_989_478_744,
                                      "all-reduce(g=4)": 3_509_061_123,
                                      "all-gather(g=4)": 2_648_702_976,
                                      "all-to-all(g=16)": 402_653_184}}
DRYRUN_GEMMA_ARCH, DRYRUN_GEMMA_SHAPE = "gemma2-27b", "train_4k"
DRYRUN_GEMMA_REF = {"argument_bytes": 1_286_985_736,
                    "alias_bytes": 1_286_461_444,
                    "output_bytes": 1_286_462_088,
                    "dot_flops": 933_064_465_186_816,
                    "coll_traffic": 970_286_551_024,
                    "coll_elements": {"collective-permute(g=256)": 65_536,
                                      "all-gather(g=16)": 3_330_605_056,
                                      "all-reduce(g=16)": 127_404_212_768,
                                      "all-to-all(g=16)": 603_979_776}}
DRYRUN_MLA_ARCH, DRYRUN_MLA_SHAPE = "deepseek-v3-671b", "prefill_32k"
DRYRUN_MLA_REF = {"argument_bytes": 9_065_799_680,
                  "alias_bytes": 0,
                  "output_bytes": 4_605_378_184,
                  "temp_bytes": 161_954_726_840,
                  "dot_flops": 1_131_543_725_539_328,
                  "coll_traffic": 4_578_670_018_560,
                  "coll_elements": {"all-reduce(g=16)": 330_242_719_744,
                                    "all-gather(g=16)": 15_569_256_448,
                                    "all-to-all(g=16)": 544_923_975_680}}
# ... and of gemma2-2b x train_4k on the 2x16x16 mesh ("pod", "data",
# "model"; the batch over "pod" x "data"), held as DRYRUN_MOE_REF is,
# with DRYRUN_FALLBACKS
DRYRUN_POD_REF = {"argument_bytes": 384_486_408,
                  "alias_bytes": 384_224_260,
                  "output_bytes": 384_224_904,
                  "temp_bytes": 43_402_752_280,
                  "dot_flops": 222_601_712_500_736,
                  "coll_traffic": 65_399_569_524.5,
                  "coll_elements": {"all-gather(g=16)": 1_092_354_048,
                                    "collective-permute(g=512)": 73_617_408,
                                    "all-reduce(g=32)": 60_109_058,
                                    "all-reduce(g=16)": 8_067_710_998,
                                    "all-reduce(g=2)": 8_773_632}}
# ... and of whisper-base x train_4k on the 2x16x16 mesh (each norm's
# scale's and bias's gradient all-reduced once over "pod" x "data" in
# the backward) and of gemma2-27b x long_500k there (each layer's
# queries regrouped over "model", moved to "pod" x "data" and
# all-reduced over the 32), held as DRYRUN_MOE_REF is
DRYRUN_POD_WHISPER_REF = {"argument_bytes": 69_553_544,
                          "alias_bytes": 35_736_964,
                          "output_bytes": 35_737_872,
                          "temp_bytes": 27_559_601_440,
                          "dot_flops": 27_529_517_727_744,
                          "coll_traffic": 3_423_829_804,
                          "coll_elements": {
                              "collective-permute(g=512)": 10_177_664,
                              "all-gather(g=16)": 84_226_560,
                              "all-reduce(g=32)": 4_539_458,
                              "all-reduce(g=16)": 404_226_071,
                              "all-reduce(g=2)": 98_304}}
DRYRUN_POD_WHISPER_FALLBACKS = ("kv_heads=8 !-> ('model',) (indivisible)",
                                "heads=8 !-> ('model',) (indivisible)",
                                "vocab=51865 !-> ('model',) (indivisible)")
DRYRUN_POD_LONG_REF = {"argument_bytes": 13_035_267_080,
                       "alias_bytes": 6_225_288_192,
                       "output_bytes": 6_225_288_252,
                       "dot_flops": 10_014_425_088,
                       "coll_traffic": 5_679_800,
                       "coll_elements": {"all-reduce(g=16)": 443_264,
                                         "all-gather(g=16)": 188_448,
                                         "collective-permute(g=512)": 47_104,
                                         "all-reduce(g=32)": 188_416}}
# ... and of xlstm-125m's long-context decode and training step on the
# 2x16x16 mesh: the decode's up projections contracted, and the
# unembedding's input and the sLSTM state gathered, over the 32 of
# "pod" x "data"; the step's lookup gradient all-reduced over the 32 at
# once in the backward, each up projection's weight gradient over
# "data", then "pod", and the sLSTM gates' gradients gathered whole
# over "model" (tests/_dryrun_ref.py --multi-pod on the CPU), each held
# as DRYRUN_MOE_REF is
DRYRUN_POD_XLSTM_ARCH = "xlstm-125m"
DRYRUN_POD_XLSTM_LONG_REF = {"argument_bytes": 61_319_716,
                             "alias_bytes": 3_456,
                             "output_bytes": 903_852,
                             "dot_flops": 8_338_176,
                             "coll_traffic": 212_803.5,
                             "coll_elements": {
                                 "all-reduce(g=16)": 15_193,
                                 "collective-permute(g=512)": 16_854,
                                 "all-gather(g=32)": 1_920,
                                 "all-reduce(g=32)": 3_072,
                                 "all-reduce(g=4)": 12,
                                 "all-gather(g=16)": 32}}
DRYRUN_POD_XLSTM_TRAIN_REF = {"argument_bytes": 79_327_944,
                              "alias_bytes": 36_091_588,
                              "output_bytes": 38_777_640,
                              "temp_bytes": 2_201_532_440,
                              "dot_flops": 2_332_418_899_968,
                              "coll_traffic": 47_709_123_957.5,
                              "coll_elements": {
                                  "all-gather(g=16)": 2_980_589_568,
                                  "collective-permute(g=512)": 733_256_448,
                                  "all-reduce(g=32)": 911_050_046,
                                  "all-reduce(g=16)": 1_541_969_946,
                                  "all-reduce(g=4)": 1_754_530_563,
                                  "all-gather(g=4)": 1_324_351_488,
                                  "all-reduce(g=2)": 344_448,
                                  "all-to-all(g=16)": 125_829_120}}
# ... and of deepseek-v3-671b's decode and prefill on the 2x16x16 mesh,
# the MoE on a batch split over "pod" x "data": the decode's scores and
# expert ids gathered over the 32 at once, its tokens joined with the
# zero row by all-to-alls over the 32, gathered into the buckets by an
# all-reduce over "pod" x "model" and combined on blocks over "pod" x
# "model"; the prefill's rows taken into the chunk loop's layout by a
# collective-permute and an all-gather over "pod", and laid out as the
# batch again by a collective-permute (tests/_dryrun_ref.py --multi-pod
# on the CPU), each held as DRYRUN_MOE_REF is
DRYRUN_POD_MOE_ARCH = "deepseek-v3-671b"
DRYRUN_POD_MOE_DECODE_REF = {"argument_bytes": 18_276_229_140,
                             "alias_bytes": 9_210_691_584,
                             "output_bytes": 9_210_691_672,
                             "dot_flops": 236_741_591_040,
                             "coll_traffic": 1_719_744_096,
                             "coll_elements": {
                                 "all-reduce(g=16)": 112_035_840,
                                 "all-to-all(g=32)": 3_748_864,
                                 "all-gather(g=32)": 1_959_936,
                                 "all-reduce(g=32)": 106_549_248,
                                 "collective-permute(g=512)": 7_899_136,
                                 "all-gather(g=16)": 128}}
DRYRUN_POD_MOE_PREFILL_REF = {"argument_bytes": 9_065_668_608,
                              "alias_bytes": 0,
                              "output_bytes": 2_302_689_128,
                              "temp_bytes": 89_972_606_024,
                              "dot_flops": 677_372_292_988_928,
                              "coll_traffic": 4_579_988_471_808,
                              "coll_elements": {
                                  "all-reduce(g=16)": 301_352_353_792,
                                  "collective-permute(g=512)":
                                  40_875_950_080,
                                  "all-gather(g=2)": 27_246_198_784,
                                  "all-gather(g=16)": 15_569_256_448,
                                  "all-to-all(g=16)": 544_923_975_680}}
DRYRUN_POD_MOE_PREFILL_FALLBACKS = (
    "batch=16 !-> ('pod', 'data') (indivisible)",)
# ... and of recurrentgemma-9b's prefill there: its attention mask and
# rotary angles built from positions split like the rows they meet, the
# rank's one row of 32 (tests/_dryrun_ref.py --multi-pod on the CPU),
# held as DRYRUN_MOE_REF is, its temp within ``temp_factor`` of the
# reference's (9.7444 x while the mask carried the global batch)
DRYRUN_POD_RG_PREFILL_REF = {"argument_bytes": 2_446_052_352,
                             "alias_bytes": 66_560,
                             "output_bytes": 28_410_208,
                             "temp_bytes": 10_693_705_720,
                             "temp_factor": 1.5,
                             "dot_flops": 48_928_398_508_032,
                             "coll_traffic": 129_855_651_840,
                             "coll_elements": {
                                 "all-reduce(g=16)": 17_314_086_912}}
DRYRUN_POD_RG_PREFILL_FALLBACKS = (
    "kv_heads=1 !-> ('model',) (indivisible)",)
# ... and of its training step there: the router contracted over "pod" x
# "model", the chunk loop's output gradient taken back whole into the
# chunks, the MoE input's and the shared expert's input gradients made
# in the chunk loop's layout, and XLA's involuntary full
# rematerialization of the MoE norm's input and gradient for its
# scale's gradient (tests/_dryrun_ref.py --multi-pod on the CPU), held
# as DRYRUN_MOE_REF is, with the prefill's fallback
DRYRUN_POD_MOE_TRAIN_REF = {"argument_bytes": 5_967_500_752,
                            "alias_bytes": 5_967_238_604,
                            "output_bytes": 5_967_240_184,
                            "temp_bytes": 212_071_255_608,
                            "dot_flops": 1_478_137_154_109_440,
                            "coll_traffic": 19_393_400_675_352,
                            "coll_elements": {
                                "all-gather(g=16)": 470_988_324_864,
                                "collective-permute(g=512)":
                                163_804_713_984,
                                "all-reduce(g=32)": 2_338_979_844,
                                "all-reduce(g=16)": 1_195_751_823_086,
                                "all-gather(g=2)": 82_715_475_968,
                                "all-to-all(g=16)": 1_634_771_927_040,
                                "all-gather(g=32)": 436_045_611_008,
                                "all-reduce(g=2)": 51_853_312}}
MESH_ATOL = 1e-5        # ep_sm vs no mesh: forward (abs), grads (rel)
MESH_TRAIN_ATOL = 1e-5  # launch.train's losses, mesh vs no mesh


def start_dryrun(out: Path, arch: str = "gemma2-2b",
                 shape: str = "train_4k",
                 multi_pod: bool = False) -> subprocess.Popen:
    """Phase 14a's dry run of ``arch`` x ``shape`` (``multi_pod``: on the
    2x16x16 mesh), started early in a process of its own."""
    env = dict(os.environ, PYTHONPATH=str(SRC))
    return subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         arch, "--shape", shape, "--json", str(out)]
        + (["--multi-pod"] if multi_pod else []),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
        cwd=ROOT)


MEM_WALK_RTOL = 0.05   # 14c: the walk's peak_bytes vs max_memory_allocated

_MEMORY_WALKS = r"""
import json
import sys
import torch
from torch.distributed.device_mesh import DeviceMesh
from repro_torch.common.config import ShapeConfig
from repro_torch.configs import get_config
from repro_torch.launch.dryrun import walk_cell
from repro_torch.launch.mesh import init_dry_run_world
out, arch, seq, batch, override, cache, dec_batch = sys.argv[1:]
init_dry_run_world(1)
mesh = DeviceMesh("cpu", torch.arange(1).reshape(1, 1),
                  mesh_dim_names=("data", "model"))
walks = {}
for name, shape, opt in (
        ("train", ShapeConfig("phase13b", seq_len=int(seq),
                              global_batch=int(batch), kind="train"),
         json.loads(override)),
        ("decode", ShapeConfig("phase12b", seq_len=int(cache),
                               global_batch=int(dec_batch), kind="decode"),
         None)):
    by_tree, cost, memory = walk_cell(get_config(arch), shape, mesh, opt)
    walks[name] = {"peak_bytes": cost.peak_bytes,
                   "argument_bytes": sum(by_tree.values()), **memory}
with open(out, "w") as f:
    json.dump(walks, f)
"""


def start_memory_walks(out: Path) -> subprocess.Popen:
    """Phase 14c's walks, on a mesh of one device (a ``fake`` world of
    one: a process of its own), of 13b's train step (gemma2-2b, batch
    ``TRAIN_BATCH`` x ``TRAIN_SEQ``, 13b's TrainConfig) and of 12b's one
    measured decode step (batch ``FULL_BATCH``, a cache of
    ``DECODE_CACHE``), started early; JSON into ``out``."""
    env = dict(os.environ, PYTHONPATH=str(SRC))
    override = {"tc_steps": TRAIN_STEPS, "tc_learning_rate": TRAIN_LR,
                "tc_warmup_steps": 0}
    return subprocess.Popen(
        [sys.executable, "-c", _MEMORY_WALKS, str(out), FULL_ARCH,
         str(TRAIN_SEQ), str(TRAIN_BATCH), json.dumps(override),
         str(DECODE_CACHE), str(FULL_BATCH)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
        cwd=ROOT)


def _memory_walks(proc: subprocess.Popen, path: Path) -> dict:
    """What a ``start_memory_walks`` process wrote."""
    try:
        _, err = proc.communicate(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, err[-3000:]
    return json.loads(path.read_text())


def _moe_grads(cfg, p0, x0, mesh):
    """y and the gradients of sum(sin(y)) w.r.t. x, w1, w2, w3 of the
    port's moe_ffn (float32) under ``mesh`` (None: no mesh), and the
    collectives the forward called."""
    import torch
    from torch.distributed.tensor.debug import CommDebugMode
    from repro_torch.models import moe
    from repro_torch.parallel import sharding as sh
    p = {k: (v.clone().requires_grad_(True) if torch.is_tensor(v) else
             {kk: vv.clone() for kk, vv in v.items()}) for k, v in p0.items()}
    x = x0.clone().requires_grad_(True)
    ctx = (sh.activate(mesh, sh.make_rules("train"), "moe")
           if mesh is not None else contextlib.nullcontext())
    with ctx, CommDebugMode() as comm:
        y = moe.moe_ffn(cfg, p, x, torch.float32)[0]
    torch.sin(y).sum().backward()
    torch.cuda.synchronize()
    counts = {str(k).rsplit(".", 1)[-1]: v
              for k, v in comm.get_comm_counts().items()}
    return y.detach(), {"x": x.grad, "w1": p["w1"].grad, "w2": p["w2"].grad,
                        "w3": p["w3"].grad}, counts


def _dryrun_cell(proc: subprocess.Popen, path: Path) -> dict:
    """The one cell a ``start_dryrun`` process wrote."""
    try:
        out, err = proc.communicate(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, err[-3000:]
    cell = json.loads(path.read_text())[0]
    assert cell["status"] == "ok", cell
    return cell


def _check_against(cell: dict, ref: dict, dot_rtol: float) -> tuple:
    """A 14a cell against its reference partition (DRYRUN_GQA_REF,
    DRYRUN_MOE_REF): argument and alias bytes exact, output within 1 KiB,
    dot FLOPs within ``dot_rtol``, traffic within DRYRUN_COLL_FACTOR,
    each kind's elements within DRYRUN_ELEMENTS_RTOL, the port's own
    kinds under DRYRUN_EXTRA_SHARE, no op run replicated on this torch.
    Returns (dot, traffic, kinds, extra) as ratios to the reference."""
    mem = cell["memory"]
    assert mem["argument_bytes"] == ref["argument_bytes"], cell
    assert mem["alias_bytes"] == ref["alias_bytes"], cell
    assert 0 <= ref["output_bytes"] - mem["output_bytes"] <= 1024, cell
    dot = cell["dot_flops_per_device"] / ref["dot_flops"]
    coll = cell["coll_traffic_per_device"] / ref["coll_traffic"]
    assert abs(dot - 1) <= dot_rtol, (dot, cell)
    assert 1 / DRYRUN_COLL_FACTOR <= coll <= DRYRUN_COLL_FACTOR, (coll, cell)
    ge, we = cell["coll_elements"], ref["coll_elements"]
    kinds = {k: ge.get(k, 0) / n for k, n in we.items()}
    assert all(abs(r - 1) <= DRYRUN_ELEMENTS_RTOL for r in kinds.values()), \
        (kinds, ge)
    extra = sum(v for k, v in ge.items() if k not in we)
    assert extra <= DRYRUN_EXTRA_SHARE * sum(ge.values()), ge
    assert cell["replicated_ops"] == {}, cell["replicated_ops"]
    _check_temp(cell, ref)
    return dot, coll, kinds, extra


def _check_temp(cell: dict, ref: dict) -> None:
    """A train or prefill cell's temp bytes within DRYRUN_TEMP_FACTOR of
    the reference's, where ``ref`` has them, or within ``ref``'s own,
    tighter, ``temp_factor``."""
    if "temp_bytes" in ref and cell["shape"].startswith(("train",
                                                         "prefill")):
        temp = cell["memory"]["temp_bytes"]
        factor = ref.get("temp_factor", DRYRUN_TEMP_FACTOR)
        assert temp <= factor * ref["temp_bytes"], (temp, ref)


def _print_against(label: str, cell: dict, ref: dict, checked: tuple):
    dot, coll, kinds, extra = checked
    mem = cell["memory"]
    print(f"[mesh] (a) dry run {label}: ok in {cell['step_s']} s walk; "
          f"argument bytes {mem['argument_bytes']:,}, alias "
          f"{mem['alias_bytes']:,} (the reference's), output "
          f"{mem['output_bytes']:,} (reference {ref['output_bytes']:,}); dot "
          f"FLOPs {cell['dot_flops_per_device']:.4e} ({dot:.4f} x the "
          f"reference partition's), collective traffic {coll:.4f} x, "
          f"elements by kind x the reference's "
          f"{ {k: round(r, 4) for k, r in kinds.items()} }, port only "
          f"{extra:.0f}; replicated ops {cell['replicated_ops']}"
          + (f"; temp bytes {mem['temp_bytes']:,} (reference "
             f"{ref['temp_bytes']:,}: "
             f"{mem['temp_bytes'] / ref['temp_bytes']:.4f} x, bound "
             f"{ref.get('temp_factor', DRYRUN_TEMP_FACTOR)} x)"
             if "temp_bytes" in ref else ""))


def check_dryrun_gqa(proc: subprocess.Popen, path: Path) -> dict:
    """Phase 14a's GQA cell against DRYRUN_GQA_REF: the same checks as
    the gemma2-2b cell's, and no op run replicated on this torch."""
    cell = _dryrun_cell(proc, path)
    for line in DRYRUN_GQA_FALLBACKS:
        assert f"[{DRYRUN_GQA_ARCH}/train_4k] {line}" \
            in cell["sharding_fallbacks"], cell["sharding_fallbacks"]
    checked = _check_against(cell, DRYRUN_GQA_REF, DRYRUN_DOT_RTOL)
    _print_against(f"{DRYRUN_GQA_ARCH} x train_4k on the 16x16 mesh, "
                   "\"model\" cut into 8 x 2 for its KV heads", cell,
                   DRYRUN_GQA_REF, checked)
    return cell


def check_dryrun_exact(proc: subprocess.Popen, path: Path, ref: dict,
                       label: str, fallbacks: tuple = ()) -> dict:
    """A phase 14a cell against its reference partition (DRYRUN_MOE_REF,
    DRYRUN_LONG_REF): the GQA cell's checks, its dot FLOPs within
    DRYRUN_MOE_DOT_RTOL; no sharding fallbacks, or ``fallbacks``."""
    cell = _dryrun_cell(proc, path)
    if fallbacks:
        for line in fallbacks:
            assert f"[{cell['arch']}/{cell['shape']}] {line}" \
                in cell["sharding_fallbacks"], cell["sharding_fallbacks"]
    else:
        assert cell["sharding_fallbacks"] == DRYRUN_MOE_FALLBACKS, cell
    checked = _check_against(cell, ref, DRYRUN_MOE_DOT_RTOL)
    _print_against(label, cell, ref, checked)
    return cell


def phase_mesh(dev, smi: str, dryrun: subprocess.Popen, dry_json: Path,
               peak_13b: int, walks: tuple, decode_peak: int, gqa: tuple,
               moe_cell: tuple, long_cell: tuple, more: tuple = ()) -> dict:
    """Phase 14: the mesh layer; (a) the dry run started by
    ``start_dryrun``, (b) a one-rank NCCL mesh on the card, (c) the dry
    run's argument bytes against phase 13b's peak memory, and the walks
    ``start_memory_walks`` started (``walks``: (process, json)): their
    ``peak_bytes`` against 13b's and against 12b's decode step's
    (``decode_peak``) ``max_memory_allocated``."""
    import tempfile

    import torch
    import torch.distributed as dist
    from repro_torch.common.config import ShapeConfig, TrainConfig
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.launch import train as tlaunch
    from repro_torch.launch.dryrun import argument_bytes
    from repro_torch.launch.mesh import (HBM_BW, NVLINK_BW, PEAK_FLOPS_BF16,
                                         make_host_mesh)
    from repro_torch.models import moe
    from repro_torch.models import params as P
    from repro_torch.models.model import Model
    from repro_torch.train.loop import Trainer, lm_batch_iterator
    t0 = time.perf_counter()
    # (a) the dry run
    cell = _dryrun_cell(dryrun, dry_json)
    assert cell["memory"]["argument_bytes"] == DRYRUN_ARG_BYTES, cell
    for line in DRYRUN_FALLBACKS:
        assert f"[gemma2-2b/train_4k] {line}" in cell["sharding_fallbacks"]
    assert cell["memory"]["alias_bytes"] == DRYRUN_REF["alias_bytes"], cell
    dot = cell["dot_flops_per_device"] / DRYRUN_REF["dot_flops"]
    coll = cell["coll_traffic_per_device"] / DRYRUN_REF["coll_traffic"]
    assert abs(dot - 1) <= DRYRUN_DOT_RTOL, (dot, cell)
    assert 1 / DRYRUN_COLL_FACTOR <= coll <= DRYRUN_COLL_FACTOR, (coll, cell)
    ge, we = cell["coll_elements"], DRYRUN_REF["coll_elements"]
    kinds = {k: ge.get(k, 0) / n for k, n in we.items()}
    assert all(abs(r - 1) <= DRYRUN_ELEMENTS_RTOL for r in kinds.values()), \
        (kinds, ge)
    extra = sum(v for k, v in ge.items() if k not in we)
    assert extra <= DRYRUN_EXTRA_SHARE * sum(ge.values()), ge
    _check_temp(cell, DRYRUN_REF)
    t = cell["terms"]
    assert t["collective_s"] is not None and t["collective_s"] > 0, t
    print(f"[mesh] (a) dry run gemma2-2b x train_4k on the 16x16 mesh (one "
          f"rank's share of the step as DTensors on a fake world of 512 "
          f"ranks, on the host): ok in {cell['step_s']} s walk; argument "
          f"bytes per device {DRYRUN_ARG_BYTES:,} and alias bytes "
          f"{cell['memory']['alias_bytes']:,} (the reference's); output "
          f"bytes {cell['memory']['output_bytes']:,} (reference "
          f"{DRYRUN_REF['output_bytes']:,}); fallbacks "
          f"{list(DRYRUN_FALLBACKS)}; per device: dot FLOPs "
          f"{cell['dot_flops_per_device']:.4e} ({dot:.4f} x the reference "
          f"partition's), FLOPs {cell['flops_per_device']:.4e} (ref "
          f"{DRYRUN_REF['flops']:.4e}), bytes {cell['bytes_per_device']:.4e}"
          f" (eager, unfused; ref {DRYRUN_REF['bytes']:.4e} fused), "
          f"collective traffic {cell['coll_traffic_per_device']:.4e} B "
          f"({coll:.4f} x the reference's) {cell['coll_breakdown']}, "
          f"elements by kind x the reference's "
          f"{ {k: round(r, 4) for k, r in kinds.items()} }; temp bytes "
          f"{cell['memory']['temp_bytes']:,} (reference "
          f"{DRYRUN_REF['temp_bytes']:,}: "
          f"{cell['memory']['temp_bytes'] / DRYRUN_REF['temp_bytes']:.4f} x, "
          f"bound {DRYRUN_TEMP_FACTOR} x); "
          f"roofline terms from the H100 data sheet: compute "
          f"{t['compute_s'] * 1e3:.2f} ms ({PEAK_FLOPS_BF16:.3g} FLOP/s "
          f"bf16), memory {t['memory_s'] * 1e3:.2f} ms ({HBM_BW:.3g} B/s), "
          f"collective {t['collective_s'] * 1e3:.2f} ms ({NVLINK_BW:.3g} "
          f"B/s) -> {cell['bottleneck']}; replicated ops "
          f"{cell['replicated_ops']}")
    gqa_cell = check_dryrun_gqa(*gqa)
    moe_dry = check_dryrun_exact(
        *moe_cell, DRYRUN_MOE_REF, f"{DRYRUN_MOE_ARCH} x {DRYRUN_MOE_SHAPE} "
        "on the 16x16 mesh, the MoE's flat branch")
    long_dry = check_dryrun_exact(
        *long_cell, DRYRUN_LONG_REF, f"{DRYRUN_LONG_ARCH} x "
        f"{DRYRUN_LONG_SHAPE} on the 16x16 mesh, the queries' heads and "
        "the cache's sequence both over \"model\"")
    assert long_dry["coll_elements"]["collective-permute(g=256)"] > 0
    for proc, path, ref, label, fallbacks in more:
        check_dryrun_exact(proc, path, ref, label, fallbacks)

    # (b) a one-rank NCCL world on the card
    mesh = make_host_mesh()
    assert dist.get_backend() == "nccl" and tuple(mesh.shape) == (1, 1)
    cfg = get_smoke_config("deepseek-v3-671b").replace(
        compute_dtype="float32", expert_sharding="ep_sm")
    gen = torch.Generator().manual_seed(0)
    p0 = P.init(moe.moe_spec(cfg), gen, "float32", dev)
    x0 = (0.1 * torch.randn((4, 4096, cfg.d_model), generator=gen)).to(dev)
    t1 = time.perf_counter()
    y0, g0, c0 = _moe_grads(cfg, p0, x0, None)
    t_plain = time.perf_counter() - t1
    t1 = time.perf_counter()
    y1, g1, c1 = _moe_grads(cfg, p0, x0, mesh)
    t_sm = time.perf_counter() - t1
    fwd = float((y1 - y0).abs().max())
    rel = {k: float((g1[k] - g0[k]).abs().max() / g0[k].abs().max())
           for k in g0}
    assert not c0 and c1 == {"all_to_all_single": 2, "all_reduce": 1,
                             "all_gather_into_tensor": 1}, (c0, c1)
    print(f"[mesh] (b) NCCL world of one, mesh {tuple(mesh.shape)} "
          f"{mesh.mesh_dim_names}: ep_sm MoE (deepseek-v3 smoke, f32, "
          f"x {tuple(x0.shape)}) vs the no-mesh path on the card: forward "
          f"max abs err {fwd:.3e}, grads rel " + ", ".join(
              f"{k} {v:.3e}" for k, v in rel.items())
          + f" (bound {MESH_ATOL}); collectives in the forward {c1}; "
          f"fwd+bwd wall {t_sm * 1e3:.1f} ms (no mesh {t_plain * 1e3:.1f})")
    assert fwd < MESH_ATOL and max(rel.values()) < MESH_ATOL, (fwd, rel)

    runs = {}

    class Recording(Trainer):
        def run(self, *a, **k):
            runs["mesh"] = super().run(*a, **k)
            return runs["mesh"]

    with tempfile.TemporaryDirectory() as d:
        argv = ["--arch", "granite-3-2b", "--smoke", "--steps", "20"]
        real, tlaunch.Trainer = tlaunch.Trainer, Recording
        try:
            assert tlaunch.main(argv + ["--ckpt-dir", f"{d}/mesh"]) == 0
        finally:
            tlaunch.Trainer = real
        assert runs["mesh"].__class__.__name__ == "TrainResult"
        cfg2 = get_smoke_config("granite-3-2b")
        tc = TrainConfig(steps=20, learning_rate=1e-3,
                         checkpoint_dir=f"{d}/plain", checkpoint_every=50)
        runs["plain"] = Trainer(Model(cfg2, device=dev), tc).run(
            lm_batch_iterator(cfg2, 8, 128))
    lm, lp = np.array(runs["mesh"].losses), np.array(runs["plain"].losses)
    err = float(np.abs(lm - lp).max())
    print(f"[mesh] (b) repro_torch.launch.train --smoke --steps 20 on the "
          f"mesh: loss {lm[0]:.4f} -> {lm[-1]:.4f} in "
          f"{runs['mesh'].wall_s:.1f} s; the same Trainer without a mesh "
          f"{lp[0]:.4f} -> {lp[-1]:.4f}; max abs err over 20 steps "
          f"{err:.2e} (bound {MESH_TRAIN_ATOL})")
    assert len(lm) == len(lp) == 20 and err < MESH_TRAIN_ATOL, (lm, lp)

    # (c) the dry run's argument bytes at phase 13b's batch, one-card mesh
    shape = ShapeConfig("phase13b", seq_len=TRAIN_SEQ,
                        global_batch=TRAIN_BATCH, kind="train")
    by_tree = argument_bytes(get_config(FULL_ARCH), shape, mesh)
    arg = sum(by_tree.values())
    print(f"[mesh] (c) {FULL_ARCH} at {TRAIN_BATCH} x {TRAIN_SEQ}, AdamW, "
          f"one-card mesh: dry-run argument bytes {arg:,} ({by_tree}) vs "
          f"phase 13b's max_memory_allocated {peak_13b:,} on {smi} "
          f"({arg / peak_13b:.3f} of it)")
    assert arg <= peak_13b, (arg, peak_13b)
    mem = _memory_walks(*walks)
    train, decode = mem["train"], mem["decode"]
    r_train = train["peak_bytes"] / peak_13b
    r_decode = decode["peak_bytes"] / decode_peak
    print(f"[mesh] (c) the dry run's walk on a mesh of one device, "
          f"{FULL_ARCH}: the train step at {TRAIN_BATCH} x {TRAIN_SEQ} "
          f"peak_bytes {train['peak_bytes']:,} (arguments "
          f"{train['argument_bytes']:,}, temp {train['temp_bytes']:,}) vs "
          f"phase 13b's max_memory_allocated {peak_13b:,}: {r_train:.4f}; "
          f"the decode step at batch {FULL_BATCH}, cache {DECODE_CACHE} "
          f"peak_bytes {decode['peak_bytes']:,} (temp "
          f"{decode['temp_bytes']:,}) vs its max_memory_allocated "
          f"{decode_peak:,}: {r_decode:.4f} (bound {MEM_WALK_RTOL}); {smi}")
    assert abs(r_train - 1) <= MEM_WALK_RTOL, (train, peak_13b)
    assert abs(r_decode - 1) <= MEM_WALK_RTOL, (decode, decode_peak)
    dist.destroy_process_group()
    wall = time.perf_counter() - t0
    print(f"[mesh] phase 14 wall_s={wall:.1f}")
    return {"dryrun": cell["terms"], "dryrun_gqa": gqa_cell["terms"],
            "dryrun_moe": moe_dry["terms"], "dryrun_long": long_dry["terms"],
            "ep_sm_fwd_err": fwd,
            "ep_sm_grad_rel": rel, "train_loss_err": err,
            "arg_bytes_13b": arg, "peak_13b": peak_13b,
            "walk_peak_13b": train["peak_bytes"], "walk_ratio_13b": r_train,
            "walk_peak_decode": decode["peak_bytes"],
            "decode_peak": decode_peak, "walk_ratio_decode": r_decode,
            "wall_s": wall}


# ---------------------------------------------------------------------------
# phase 15: DPI training, the sharded landing zone, the elastic restore
# ---------------------------------------------------------------------------

DPI_TRAIN_STEPS = 200   # examples/secure_flow.py's training
DPI_TRAIN_RTOL = 1e-5   # card vs CPU float weights, of each leaf's max |w|
DPI_ACC_BAR = 0.85      # the reference's tests/test_kernels.py bar


def phase_dpi_training(dev) -> dict:
    """Phase 15a: ``train_dpi_params`` on the card against the CPU from
    the same CPU-generator weights (float error, ternary entries that
    differ, walls), the accuracy of the card's weights scored by the DPI
    kernel, then ``repro_torch.examples.secure_flow.main()`` on the card,
    which trains the same weights and serves the flows with them.
    Returns the launch counts of that run (path ``secure_flow_trained``)."""
    import torch
    from repro_torch.data.dpi_dataset import make_dataset
    from repro_torch.examples import secure_flow
    from repro_torch.kernels import dpi_mlp, ops
    x, y = make_dataset(2048, seed=0)
    floats, tern, walls = {}, {}, {}
    for name, d in (("card", dev), ("cpu", torch.device("cpu"))):
        p0 = dpi_mlp.init_dpi_params(0, d)
        floats[name] = {k: v.cpu().numpy() for k, v in
                        dpi_mlp.train_float_dpi_params(
                            p0, x, y, DPI_TRAIN_STEPS, device=d).items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tern[name] = dpi_mlp.train_dpi_params(x, y, DPI_TRAIN_STEPS,
                                              device=d)
        torch.cuda.synchronize()
        walls[name] = time.perf_counter() - t0
        want = dpi_mlp.ternarize(floats[name])
        assert all(tern[name][k].tobytes() == want[k].tobytes()
                   for k in want), f"train_dpi_params on {d} is not " \
            "ternarize of its float loop"
    card, cpu = floats["card"], floats["cpu"]
    errs = {k: float(np.abs(card[k] - cpu[k]).max() / np.abs(cpu[k]).max())
            for k in card}
    flips = []
    for k in ("w1", "w2", "w3"):
        thr = 0.7 * np.abs(cpu[k]).mean()
        for idx in zip(*np.nonzero(tern["card"][k] != tern["cpu"][k])):
            flips.append((k, idx, float(abs(abs(cpu[k][idx]) - thr))))
    print(f"[dpi-train] (a) train_dpi_params(make_dataset(2048, seed=0), "
          f"steps={DPI_TRAIN_STEPS}) on the card vs the CPU: worst float "
          f"error before ternarization, of each leaf's max |w|: "
          + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
          + f" (bound {DPI_TRAIN_RTOL}); ternary entries that differ "
          f"{len(flips)} of {sum(card[k].size for k in ('w1', 'w2', 'w3'))}"
          f" {flips}; wall card {walls['card'] * 1e3:.1f} ms, CPU "
          f"{walls['cpu'] * 1e3:.1f} ms")
    assert max(errs.values()) < DPI_TRAIN_RTOL, errs
    assert all(dist < DPI_TRAIN_RTOL * float(np.abs(cpu[k]).max())
               for k, _, dist in flips), flips
    xt, yt = make_dataset(512, seed=2)
    params = dpi_mlp.dpi_params_from_numpy(tern["card"], dev)
    before = ops.launches()["dpi_mlp"]
    scores = ops.dpi_scores(torch.from_numpy(xt.reshape(len(xt), 64))
                            .to(dev), params)[:, 0].cpu().numpy()
    assert ops.launches()["dpi_mlp"] == before + 1, "dpi_scores not launched"
    acc = float(((scores > 0) == (yt > 0.5)).mean())
    print(f"[dpi-train] (a) accuracy of the card's ternary weights on "
          f"make_dataset(512, seed=2), scored by the dpi_mlp kernel: "
          f"{acc:.4f} (bar {DPI_ACC_BAR})")
    assert acc > DPI_ACC_BAR, acc

    got = {}
    real = secure_flow.train_dpi_params

    def recording(*a, **k):
        got["params"] = real(*a, **k)
        return got["params"]

    secure_flow.train_dpi_params = recording
    t0 = time.perf_counter()
    ops.reset_launches()
    try:
        res = secure_flow.main(dev)
    finally:
        secure_flow.train_dpi_params = real
    on_path = ops.launches()
    wall = time.perf_counter() - t0
    assert res["device"] == str(dev), res
    assert all(got["params"][k].tobytes() == tern["card"][k].tobytes()
               for k in tern["card"]), "secure_flow trained other weights"
    assert res["flagged"]["malicious"] > 0, res
    print(f"[dpi-train] (a) repro_torch.examples.secure_flow.main({dev}) on the "
          f"card trains the same weights and serves the flows: delivered "
          f"bytes equal, dpi_flagged {res['flagged']}, {res['pcap_packets']}"
          f" packets captured, wall {wall:.2f} s; kernel launches {on_path}")
    assert on_path["dpi_mlp"] > 0, "dpi_mlp not launched on secure_flow"
    return {"secure_flow_trained": on_path}


def _stacked_tree(model) -> dict:
    """The model's parameters as the reference's tree (a stacked
    subtree's layers stacked along a leading axis), on its device."""
    import torch
    from repro_torch.models import params as P
    with torch.no_grad():
        return P.nest({path: (torch.stack(v) if isinstance(v, list)
                              else v.detach())
                       for path, v in P.leaf_groups(model).items()})


def _gemma_like():
    """gemma2-2b's full parameter tree as ``meta`` stand-ins (the
    restore's ``like``), and its spec tree."""
    from repro_torch.configs import get_config
    from repro_torch.models import params as P
    from repro_torch.models.model import param_spec
    cfg = get_config(FULL_ARCH)
    assert cfg.param_dtype == "float32", cfg
    pspec = param_spec(cfg)
    return {"params": P.shapes(pspec, cfg.param_dtype)}, pspec


def _gemma_full(dev) -> dict:
    """gemma2-2b's full ``config()`` parameters (float32, drawn on a CUDA
    generator seeded 0: the weights phase 13b starts from) as the
    reference's tree on the card."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.model import Model
    model = Model(get_config(FULL_ARCH), device=dev)
    model.init_params(generator=torch.Generator(device=dev).manual_seed(0))
    return _stacked_tree(model)


def _train_shardings(like, pspec, mesh) -> dict:
    from repro_torch.models import params as P
    from repro_torch.parallel import sharding as sh
    sh.clear_fallback_log()
    return {"params": sh.tree_shardings(like["params"], P.axes(pspec), mesh,
                                        sh.make_rules("train"), FULL_ARCH)}


def phase_placement(dev, smi: str) -> dict:
    """Phase 15b-c on an NCCL world of one (as 14b builds it): (b) phase
    6b's first shard streamed into a landing zone sharded ("data", None)
    on the mesh of one against the unsharded zone; (c) gemma2-2b's full
    parameters written once and restored by the train rules on that
    mesh, every leaf bit-equal.  Returns the launch counts of the
    sharded fetch (path ``ingest_sharded``)."""
    import shutil

    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor
    from repro_torch.checkpoint.checkpoint import Checkpointer
    from repro_torch.core.ingest import BalboaIngest, make_dlrm_tile_decoder
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.params import tree_items
    from repro_torch.parallel.sharding import (NamedSharding, PartitionSpec,
                                               fallback_summary)
    mesh = make_host_mesh()
    assert dist.get_backend() == "nccl" and tuple(mesh.shape) == (1, 1)
    rows = NamedSharding(mesh, PartitionSpec("data", None))

    def fetch(shardings):
        ing = BalboaIngest(
            _ingest_cfg(), None, _dlrm_shard_fn(SHARD_PKTS),
            decode_fn=_poisoned, shardings=shardings, device=dev,
            tile_to_batch=make_dlrm_tile_decoder(N_DENSE, N_SPARSE, MOD))
        t0 = time.perf_counter()
        batch, rep = ing.fetch_shard_streaming(0)
        torch.cuda.synchronize()
        return ing, batch, rep, time.perf_counter() - t0

    _, whole, wrep, wall_whole = fetch(None)
    ops.reset_launches()
    ing, got, rep, wall = fetch({"dense": rows, "sparse": rows})
    on_path = ops.launches()
    assert rep.events == wrep.events and rep.ticks == wrep.ticks
    for k in ("dense", "sparse"):
        assert isinstance(got[k], DTensor) and got[k].to_local().is_cuda, k
        full = got[k].full_tensor()
        assert full.shape == whole[k].shape and torch.equal(
            full.view(torch.int32), whole[k].view(torch.int32)), k
    assert ing.host_payload_bytes == 0
    print(f"[placement] (b) phase 6b's shard 0 ({SHARD_PKTS} packets, "
          f"{RPP * SHARD_PKTS} records) into a zone sharded ('data', None) "
          f"on the NCCL mesh of one {tuple(mesh.shape)}: full_tensor() "
          f"bit-equal to the unsharded zone (dense and sparse), the same "
          f"{rep.ticks} ticks and events; tiles decoded {ing.tiles_decoded}"
          f" / landed {rep.tiles}, skipped {ing.tiles_skipped}; wall "
          f"{wall:.2f} s (unsharded {wall_whole:.2f}); kernel launches "
          f"{on_path}")
    assert on_path["preproc"] > 0, "preproc not launched on ingest_sharded"

    # (c) the elastic restore at full width
    like, pspec = _gemma_like()
    tree = _gemma_full(dev)
    state = {"params": tree}
    n_bytes = sum(t.numel() * t.element_size() for _, t in tree_items(state))
    assert n_bytes == FULL_PARAMS_LM * 4, n_bytes
    with tempfile.TemporaryDirectory() as d:
        free = shutil.disk_usage(d).free
        ck = Checkpointer(d)
        t0 = time.perf_counter()
        ck.save(0, state, blocking=True)
        t_save = time.perf_counter() - t0
        npz = Path(d, "step_00000000", "arrays.npz")
        shd = _train_shardings(like, pspec, mesh)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step, back = ck.restore(like, shardings=shd)
        torch.cuda.synchronize()
        t_restore = time.perf_counter() - t0
        file_bytes = npz.stat().st_size
    assert step == 0
    n = 0
    for (path, a), (_, b) in zip(tree_items(back), tree_items(state)):
        assert isinstance(a, DTensor) and a.to_local().is_cuda, path
        assert torch.equal(a.to_local().view(torch.int32),
                           b.view(torch.int32)), path
        n += 1
    print(f"[placement] (c) {FULL_ARCH} full config(): {n} leaves, "
          f"{FULL_PARAMS_LM:,} f32 ({n_bytes:,} B) written once "
          f"(arrays.npz {file_bytes:,} B, {free / 1e9:.1f} GB free before) "
          f"in {t_save:.2f} s and restored by the train rules on the mesh "
          f"of one in {t_restore:.2f} s: every leaf a DTensor on the card, "
          f"bit-equal; {fallback_summary().splitlines()[0]} on {smi}")
    del tree, state, back
    torch.cuda.empty_cache()
    dist.destroy_process_group()
    return {"ingest_sharded": on_path}


def _file_block(arr: np.ndarray, spec, sizes: dict, coord: dict):
    """The block of a stored array at a mesh coordinate, cut by plain
    index arithmetic (each dimension's axes major first), apart from
    ``NamedSharding.block_bounds``."""
    from repro_torch.parallel.sharding import entry_axes
    idx = []
    for d, n in enumerate(arr.shape):
        k, m = 0, 1
        for a in entry_axes(spec[d] if d < len(spec) else None):
            k, m = k * sizes[a] + coord[a], m * sizes[a]
        idx.append(slice(k * (n // m), (k + 1) * (n // m)))
    return arr[tuple(idx)]


def _blocks_match_file(got, shd, mesh, npz: Path):
    """Whether every leaf's local block equals the file's slice at this
    rank's coordinate, and the bytes resident on this card."""
    from repro_torch.models.params import tree_items
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
    ok, resident = True, 0
    with np.load(npz) as data:
        for i, ((_, a), (_, s)) in enumerate(zip(tree_items(got),
                                                 tree_items(shd))):
            want = _file_block(data[f"leaf_{i}"], s.spec, sizes, coord)
            local = a.to_local().cpu().numpy()
            ok &= want.shape == local.shape and np.array_equal(
                want.view(np.uint32), local.view(np.uint32))
            resident += local.nbytes
    return ok, resident


def _mesh_placement(rank: int, world: int, data: int, model: int, dev,
                    tmp: str) -> dict:
    """``--mesh``'s placement part, on one rank: phase 6b's first shard
    landed over "data" of a (world, 1) mesh against rank 0's unsharded
    zone; gemma2-2b's full parameters written once by rank 0, restored
    by the train rules on (data, model) and (world, 1) meshes against
    the file's slices; and a save from the first mesh's DTensors."""
    import torch
    import torch.distributed as dist
    from repro_torch.checkpoint.checkpoint import Checkpointer
    from repro_torch.core.ingest import BalboaIngest, make_dlrm_tile_decoder
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.parallel.sharding import (FALLBACK_LOG, NamedSharding,
                                               PartitionSpec)
    rec = {}
    # the sharded landing zone
    mesh = make_host_mesh(data=world)
    rows = NamedSharding(mesh, PartitionSpec("data", None))

    def ingest(shardings):
        return BalboaIngest(
            _ingest_cfg(), None, _dlrm_shard_fn(SHARD_PKTS),
            decode_fn=_poisoned, shardings=shardings, device=dev,
            tile_to_batch=make_dlrm_tile_decoder(N_DENSE, N_SPARSE, MOD))
    whole = {"dense": torch.empty((SHARD_PKTS * RPP, N_DENSE),
                                  dtype=torch.float32, device=dev),
             "sparse": torch.empty((SHARD_PKTS * RPP, N_SPARSE),
                                   dtype=torch.int32, device=dev)}
    if rank == 0:
        got, _ = ingest(None).fetch_shard_streaming(0)
        for k in whole:
            whole[k].copy_(got[k])
    for k in ("dense", "sparse"):
        dist.broadcast(whole[k], src=0)
    ing = ingest({"dense": rows, "sparse": rows})
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got, rep = ing.fetch_shard_streaming(0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    equal = True
    for k in whole:
        (start, n), _ = rows.block_bounds(whole[k].shape)
        want = whole[k][start:start + n]
        equal &= torch.equal(got[k].to_local().view(torch.int32),
                             want.view(torch.int32))
        equal &= torch.equal(got[k].full_tensor().view(torch.int32),
                             whole[k].view(torch.int32))
    rec["landing"] = {"equal": bool(equal), "decoded": ing.tiles_decoded,
                      "skipped": ing.tiles_skipped, "landed": rep.tiles,
                      "wall_s": wall}
    del got, whole

    # the elastic restore at full width
    full = Path(tmp, "ckpt_full")
    like, pspec = _gemma_like()
    if rank == 0:
        tree = _gemma_full(dev)
        t0 = time.perf_counter()
        Checkpointer(str(full)).save(0, {"params": tree}, blocking=True)
        rec["save_s"] = time.perf_counter() - t0
        del tree
        torch.cuda.empty_cache()
    dist.barrier()
    npz = full / "step_00000000" / "arrays.npz"
    rec["restore"] = {}
    keep = None
    for shape in dict.fromkeys(((data, model), (world, 1))):
        m = make_host_mesh(*shape)
        shd = _train_shardings(like, pspec, m)
        fallbacks = sorted({f"{name}={dim} !-> {cand}"
                            for _, name, dim, cand, _ in FALLBACK_LOG})
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, back = Checkpointer(str(full)).restore(like, shardings=shd)
        torch.cuda.synchronize()
        t_restore = time.perf_counter() - t0
        ok, resident = _blocks_match_file(back["params"], shd["params"], m,
                                          npz)
        rec["restore"]["x".join(map(str, shape))] = {
            "coordinate": m.get_coordinate(), "equal": bool(ok),
            "resident_bytes": resident, "wall_s": t_restore,
            "fallbacks": fallbacks}
        if keep is None:
            keep = back
        else:
            del back
    # a save from the first mesh's DTensors: every rank gathers, the rank
    # at (0, 0) writes
    t0 = time.perf_counter()
    Checkpointer(str(Path(tmp, "ckpt_dt"))).save(0, keep, blocking=True)
    rec["dtensor_save_s"] = time.perf_counter() - t0
    del keep
    dist.barrier()
    if rank == 0:
        same = True
        with np.load(npz) as a, np.load(Path(
                tmp, "ckpt_dt", "step_00000000", "arrays.npz")) as b:
            same &= a.files == b.files
            for f in a.files:
                x, y = a[f], b[f]
                same &= (x.dtype == y.dtype and x.shape == y.shape
                         and np.array_equal(x.view(np.uint8),
                                            y.view(np.uint8)))
            rec["n_leaves"] = len(a.files)
        rec["dtensor_save_identical"] = bool(same)
    return rec


def _mesh_rank(rank: int, world: int, data: int, model: int, tmp: str):
    """One rank of ``--mesh``: its card, the NCCL world, its results as
    JSON under ``tmp``."""
    sys.path.insert(0, str(SRC))
    import torch
    import torch.distributed as dist
    from repro_torch.common.config import TrainConfig
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import moe
    from repro_torch.models import params as P
    from repro_torch.models.model import Model
    from repro_torch.train.loop import Trainer, lm_batch_iterator
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", rank)
    torch.cuda.set_device(dev)
    dist.init_process_group("nccl", init_method=f"file://{tmp}/store",
                            rank=rank, world_size=world, device_id=dev)
    try:
        mesh = make_host_mesh(data, model)
        cfg = get_smoke_config("deepseek-v3-671b").replace(
            compute_dtype="float32", expert_sharding="ep_sm")
        gen = torch.Generator().manual_seed(0)
        p0 = P.init(moe.moe_spec(cfg), gen, "float32", dev)
        x0 = (0.1 * torch.randn((4, 4096, cfg.d_model), generator=gen)
              ).to(dev)
        walls, res = {"plain": [], "mesh": []}, {}
        for _ in range(3):                    # the first warms up
            for name, m in (("plain", None), ("mesh", mesh)):
                t0 = time.perf_counter()
                res[name] = _moe_grads(cfg, p0, x0, m)
                walls[name].append((time.perf_counter() - t0) * 1e3)
        (y0, g0, _), (y1, g1, c1) = res["plain"], res["mesh"]
        rec = {"rank": rank, "coordinate": mesh.get_coordinate(),
               "fwd_err": float((y1 - y0).abs().max()),
               "grad_rel": {k: float((g1[k] - g0[k]).abs().max()
                                     / g0[k].abs().max()) for k in g0},
               "collectives": c1,
               "ms": {k: statistics.median(v) for k, v in walls.items()}}
        tcfg = get_smoke_config("granite-3-2b").replace(
            compute_dtype="float32")
        runs = {}
        for name, m in (("mesh", make_host_mesh(data=world)), ("plain", None)):
            if name == "plain" and rank:
                break
            tc = TrainConfig(steps=8, learning_rate=1e-3, log_every=100,
                             checkpoint_every=100,
                             checkpoint_dir=f"{tmp}/ckpt_{name}{rank}")
            runs[name] = Trainer(Model(tcfg, device=dev), tc, mesh=m).run(
                lm_batch_iterator(tcfg, 8, 128)).losses
        rec["losses"] = runs
        rec["placement"] = _mesh_placement(rank, world, data, model, dev,
                                           tmp)
        Path(tmp, f"rank{rank}.json").write_text(json.dumps(rec))
    finally:
        dist.destroy_process_group()


def report_mesh_placement(ranks: list, data: int, model: int, smi: str):
    """Print and check ``--mesh``'s placement results of every rank."""
    world = data * model
    whole = FULL_PARAMS_LM * 4
    for r in ranks:
        land = r["placement"]["landing"]
        print(f"[mesh] rank {r['rank']}: phase 6b's shard 0 landed over "
              f"'data' of ({world}, 1): tiles decoded {land['decoded']} / "
              f"landed {land['landed']} (skipped {land['skipped']}), block "
              f"bit-equal to rank 0's unsharded rows and full_tensor() to "
              f"its zone: {land['equal']}; wall {land['wall_s']:.2f} s")
        assert land["equal"], r["placement"]
        assert land["decoded"] + land["skipped"] == land["landed"] \
            and 0 < land["decoded"] < land["landed"], land
        for name, res in r["placement"]["restore"].items():
            print(f"[mesh] rank {r['rank']}: {FULL_ARCH} full restored by "
                  f"the train rules on {name} at {res['coordinate']}: "
                  f"blocks bit-equal to the file's slices: {res['equal']}; "
                  f"resident {res['resident_bytes']:,} B of the whole "
                  f"{whole:,} ({res['resident_bytes'] / whole:.3f}); "
                  f"restore {res['wall_s']:.2f} s; fallbacks "
                  f"{res['fallbacks']}")
            assert res["equal"], res
            assert res["resident_bytes"] < whole or world == 1, res
    p0 = ranks[0]["placement"]
    print(f"[mesh] {FULL_ARCH} full config(), {p0['n_leaves']} leaves: "
          f"rank 0 wrote {whole:,} B once in {p0['save_s']:.2f} s; the save "
          f"from the ({data}, {model}) DTensors (gathered on every rank, "
          f"written at (0, 0)) took {p0['dtensor_save_s']:.2f} s and is "
          f"byte-identical, leaf by leaf: {p0['dtensor_save_identical']} "
          f"on {smi}")
    assert p0["dtensor_save_identical"], p0


def mesh_main(data: int, model: int) -> int:
    """``python3 chip_smoke.py --mesh DATA MODEL`` (see the docstring)."""
    import torch
    import torch.multiprocessing as mp
    world = data * model
    if not torch.cuda.is_available() or torch.cuda.device_count() < world:
        print(f"chip_smoke.py --mesh: needs {world} CUDA devices",
              file=sys.stderr)
        return 2
    smi = phase_device()
    with tempfile.TemporaryDirectory() as tmp:
        mp.start_processes(_mesh_rank, args=(world, data, model, tmp),
                           nprocs=world, start_method="spawn")
        ranks = [json.loads(Path(tmp, f"rank{r}.json").read_text())
                 for r in range(world)]
    for r in ranks:
        print(f"[mesh] rank {r['rank']} at {r['coordinate']} of "
              f"{data} x {model}: ep_sm fwd err {r['fwd_err']:.3e}, grads "
              f"rel " + ", ".join(f"{k} {v:.3e}"
                                  for k, v in r["grad_rel"].items())
              + f"; {r['collectives']}; fwd+bwd {r['ms']['mesh']:.1f} ms "
              f"(no mesh {r['ms']['plain']:.1f})")
        assert r["fwd_err"] < MESH_ATOL, r
        assert max(r["grad_rel"].values()) < MESH_ATOL, r
        assert r["collectives"] == {"all_to_all_single": 2, "all_reduce": 1,
                                    "all_gather_into_tensor": 1}, r
    lm = np.array(ranks[0]["losses"]["mesh"])
    lp = np.array(ranks[0]["losses"]["plain"])
    for r in ranks:
        assert r["losses"]["mesh"] == ranks[0]["losses"]["mesh"], r
    err = float(np.abs(lm - lp).max())
    print(f"[mesh] Trainer data-parallel over {world} cards, granite-3-2b "
          f"smoke f32, 8 steps of 8 x 128: losses {lm.round(6).tolist()}; "
          f"one process on one card: max abs err {err:.2e} (bound "
          f"{MESH_TRAIN_ATOL}) on {smi}")
    assert err < MESH_TRAIN_ATOL, (lm, lp)
    report_mesh_placement(ranks, data, model, smi)
    print(json.dumps({"device": smi, "mesh": [data, model], "ranks": ranks}))
    return 0


def launch_sizes_main(src: Path) -> int:
    """``python3 chip_smoke.py --launch-sizes [SRC]``: build the kernels of
    the ``repro_torch`` under SRC (default this checkout's ``src``) and
    print, as one JSON line, the card, its SM clock before and after,
    the SASS summary of its fold, preprocessing, CRC and fused epoch
    kernels, ``time_launch_sizes`` at the paths' launch sizes and
    ``time_fused_epochs`` on the phase-9 worlds' first epochs.  Two trees are compared on one card by running this in turns,
    parent, change, change, parent, in one call, the parent unpacked (git
    archive) under the ignored ``build/``."""
    import torch
    if not (src / "repro_torch").is_dir() or not torch.cuda.is_available():
        print(f"chip_smoke.py: no CUDA device or no repro_torch under {src}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
    import repro_torch
    from repro_torch.kernels import _build
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = phase_device()
    sass = _sass_of_paths(_build.build_all())
    dev = torch.device("cuda")
    clock0 = _sm_clock_mhz()
    times = time_launch_sizes(dev)
    times["fused_epoch"] = time_fused_epochs(dev)
    clock1 = _sm_clock_mhz()
    print(f"[launch-sizes] SM clock before {clock0} MHz, after {clock1} MHz",
          file=sys.stderr)
    print(json.dumps({"src": str(src), "repro_torch": repro_torch.__file__,
                      "device": smi, "sm_clock_mhz": [clock0, clock1],
                      "sass": sass, "ms": times}))
    return 0


def main() -> int:
    if sys.argv[1:2] == ["--mesh"]:
        return mesh_main(int(sys.argv[2]), int(sys.argv[3]))
    if sys.argv[1:2] == ["--launch-sizes"]:
        return launch_sizes_main(Path(sys.argv[2]) if sys.argv[2:] else SRC)
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
    ptxas, sass = phase_build()
    params = load_dpi_params_seed0()
    kern = phase_kernels(dev, params)

    data = _traffic()
    # ---- each path with the kernels, counters from 0 around each --------
    ops.reset_launches()
    with _SizesPerLaunch() as sizes:
        main_k = run_main_path(dev, params, data, impl=None)
    on_main = ops.launches()
    shapes = {"main": sizes.shapes()}
    assert len(sizes.beats) == on_main["dpi_mlp"]
    assert len(sizes.aes) == on_main["aes_ecb"]
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
    kern["crc32"]["service_call_ms"] = _crc_service_ms(
        torch.from_numpy(main_k["ciphertext"].reshape(-1, MTU)).to(dev))
    print(f"[chain] CrcService call_ms="
          f"{kern['crc32']['service_call_ms']:.4f} (the ICRC tap's whole "
          f"call on the chain's batch, CUDA events)")
    print(f"[main] kernel launches on the main path: {on_main}; dpi_mlp "
          f"beats per launch: median {statistics.median(sizes.beats)}, "
          f"all {sizes.beats}; aes_ecb (blocks, decrypt) per launch: "
          f"{sizes.aes}")
    kern["dpi_mlp"]["main_beats_per_launch"] = statistics.median(
        sizes.beats)
    by_size = time_launch_sizes(dev, sizes.aes, sizes.beats)
    for name, times in by_size.items():
        kern[name]["ms_by_launch_size"] = times
        print(f"[main] {name} kernel_ms by launch size: " + ", ".join(
            f"{k}: {v:.4f}" if isinstance(v, float) else f"{k}: {v}"
            for k, v in times.items()))
    print(f"[chain] kernel launches on the ICRC chain: {on_chain}")
    for name in ("aes_ecb", "dpi_mlp"):
        assert on_main[name] > 0, f"kernel {name} was not launched on the " \
            "main path"
    for name in ("aes_ecb", "crc32", "dpi_mlp"):
        assert on_chain[name] > 0, f"kernel {name} was not launched on " \
            "the ICRC chain"

    phase_incast(dev)
    counts = {"main": on_main, "icrc_chain": on_chain}
    keep = {}
    counts.update(phase_ingest(dev, shapes, keep))
    counts.update(phase_allreduce(dev, shapes, keep))
    counts.update(phase_secure_ingest(dev, params, shapes))
    fused_counts, kern["fused_epoch"] = phase_fused(dev, keep)
    counts.update(fused_counts)
    keep.clear()
    counts.update(phase_dlrm_exchange(dev))
    counts.update(phase_dlrm_full_width(dev, t_start))
    phase_census(dev)
    # phase 14a's dry run works on the host: start it now, read it later
    tmp = tempfile.TemporaryDirectory()
    dry_json = Path(tmp.name) / "dryrun.json"
    dryrun = start_dryrun(dry_json)
    atexit.register(lambda: dryrun.poll() is None and dryrun.kill())
    gqa_json = Path(tmp.name) / "dryrun_gqa.json"
    dryrun_gqa = start_dryrun(gqa_json, DRYRUN_GQA_ARCH)
    atexit.register(lambda: dryrun_gqa.poll() is None and dryrun_gqa.kill())
    moe_json = Path(tmp.name) / "dryrun_moe.json"
    dryrun_moe = start_dryrun(moe_json, DRYRUN_MOE_ARCH, DRYRUN_MOE_SHAPE)
    atexit.register(lambda: dryrun_moe.poll() is None and dryrun_moe.kill())
    long_json = Path(tmp.name) / "dryrun_long.json"
    dryrun_long = start_dryrun(long_json, DRYRUN_LONG_ARCH, DRYRUN_LONG_SHAPE)
    atexit.register(lambda: dryrun_long.poll() is None
                    and dryrun_long.kill())
    more = []
    for name, arch, shape, ref, label, pod, fallbacks in (
            ("pod", "gemma2-2b", "train_4k", DRYRUN_POD_REF,
             "the batch over \"pod\" x \"data\"", True, DRYRUN_FALLBACKS),
            ("pod_whisper", "whisper-base", "train_4k",
             DRYRUN_POD_WHISPER_REF, "each norm's gradient reduced once",
             True, DRYRUN_POD_WHISPER_FALLBACKS),
            ("pod_long", "gemma2-27b", "long_500k", DRYRUN_POD_LONG_REF,
             "the queries gathered by way of \"pod\" x \"data\"", True,
             ()),
            ("pod_moe_decode", DRYRUN_POD_MOE_ARCH, "decode_32k",
             DRYRUN_POD_MOE_DECODE_REF,
             "the flat MoE over \"pod\" x \"data\" at once", True, ()),
            ("pod_moe_prefill", DRYRUN_POD_MOE_ARCH, "prefill_32k",
             DRYRUN_POD_MOE_PREFILL_REF,
             "the chunked MoE's rows as the reference's scan reads them",
             True, DRYRUN_POD_MOE_PREFILL_FALLBACKS),
            ("pod_rg_prefill", "recurrentgemma-9b", "prefill_32k",
             DRYRUN_POD_RG_PREFILL_REF,
             "the attention mask on the rank's own rows", True,
             DRYRUN_POD_RG_PREFILL_FALLBACKS),
            ("pod_moe_train", DRYRUN_POD_MOE_ARCH, "train_4k",
             DRYRUN_POD_MOE_TRAIN_REF,
             "the router over \"pod\" x \"model\", the MoE input's "
             "gradient in the chunk loop's layout, XLA's full "
             "rematerialization for its norm", True,
             DRYRUN_POD_MOE_PREFILL_FALLBACKS),
            ("pod_xlstm_long", DRYRUN_POD_XLSTM_ARCH, "long_500k",
             DRYRUN_POD_XLSTM_LONG_REF,
             "the up projections and the sLSTM state over \"pod\" x "
             "\"data\"", True, ()),
            ("pod_xlstm_train", DRYRUN_POD_XLSTM_ARCH, "train_4k",
             DRYRUN_POD_XLSTM_TRAIN_REF,
             "the lookup's gradient reduced once, the gates' gathered",
             True, ()),
            ("xlstm", DRYRUN_XLSTM_ARCH, DRYRUN_XLSTM_SHAPE,
             DRYRUN_XLSTM_REF, "the xLSTM blocks' partition", False, ()),
            ("gemma", DRYRUN_GEMMA_ARCH, DRYRUN_GEMMA_SHAPE,
             DRYRUN_GEMMA_REF, "attention's einsums on their blocks", False,
             ()),
            ("mla", DRYRUN_MLA_ARCH, DRYRUN_MLA_SHAPE, DRYRUN_MLA_REF,
             "MLA's einsums on their blocks, the cache's pad", False, ())):
        path = Path(tmp.name) / f"dryrun_{name}.json"
        proc = start_dryrun(path, arch, shape, pod)
        atexit.register(lambda p=proc: p.poll() is None and p.kill())
        mesh = "2x16x16" if pod else "16x16"
        more.append((proc, path, ref,
                     f"{arch} x {shape} on the {mesh} mesh, {label}",
                     fallbacks))
    mem_json = Path(tmp.name) / "memory_walks.json"
    mem_walks = start_memory_walks(mem_json)
    atexit.register(lambda: mem_walks.poll() is None and mem_walks.kill())
    t12 = time.perf_counter()
    phase_lm_smoke(dev)
    lm_full = phase_lm_full_width(dev, smi)
    print(f"[lm] phase 12 wall_s={time.perf_counter() - t12:.1f}")
    t13 = time.perf_counter()
    phase_train_smoke(dev)
    full = phase_train_full_width(dev, smi)
    print(f"[train] phase 13 wall_s={time.perf_counter() - t13:.1f}")
    phase_mesh(dev, smi, dryrun, dry_json,
               max(r["max_memory_allocated"] for r in full["steps"]),
               (mem_walks, mem_json), lm_full["decode_step_peak"],
               (dryrun_gqa, gqa_json), (dryrun_moe, moe_json),
               (dryrun_long, long_json), tuple(more))
    t15 = time.perf_counter()
    counts.update(phase_dpi_training(dev))
    counts.update(phase_placement(dev, smi))
    print(f"[placement] phase 15 wall_s={time.perf_counter() - t15:.1f}")

    # name -> (source, TPU kernel it replaces, the path it is counted on)
    sources = {"aes_ecb": ("src/repro_torch/csrc/aes_ecb.cu",
                           "src/repro/kernels/aes_ecb.py:69", "main"),
               "crc32": ("src/repro_torch/csrc/crc32.cu",
                         "src/repro/kernels/crc32.py:58", "icrc_chain"),
               "dpi_mlp": ("src/repro_torch/csrc/dpi_mlp.cu",
                           "src/repro/kernels/dpi_mlp.py:48", "main"),
               "preproc": ("src/repro_torch/csrc/preproc.cu",
                           "src/repro/kernels/preproc.py:39", "ingest"),
               "reduce_fold": ("src/repro_torch/csrc/reduce.cu",
                               "src/repro/kernels/reduce.py:55",
                               "allreduce_offload"),
               "fused_decrypt_dpi": ("src/repro_torch/csrc/fused_chain.cu",
                                     "src/repro/kernels/fused_chain.py:66",
                                     "secure_ingest"),
               # make_epoch_fn: a jitted lax.while_loop, not a Pallas kernel
               "fused_epoch": ("src/repro_torch/csrc/fused_epoch.cu",
                               "src/repro/core/fused.py:714",
                               "allreduce_ring_fused")}
    print(f"[done] {smi}; total wall_s={time.perf_counter() - t_start:.1f}")
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "path": path, "launches": counts[path][name],
         "launches_by_path": {p: c[name] for p, c in counts.items()},
         **({"shapes_by_path": {p: sh[name] for p, sh in shapes.items()
                                if sh[name]}}
            if name in ("reduce_fold", "preproc") else {}),
         **kern[name], "ptxas": ptxas[Path(src).stem],
         **({"sass": sass[Path(src).stem]} if Path(src).stem in sass
            else {})}
        for name, (src, rep, path) in sources.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
