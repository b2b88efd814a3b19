"""The fused epoch core's device program: a whole epoch of network ticks
over one packed int32 "blob" (``repro_torch.core.fused``).

The blob holds the simulated world — fabric wire and egress rings,
RED/ECN state, the nodes' retransmission slots, ACK-clocked flow-control
ledgers and the receivers' RX header-FSM rows — at offsets fixed by the
shape key (``ShapeKey`` -> ``layout_for``).  One epoch runs the oracle's
tick (``rdma.step_network``) in its exact event order until an abort,
a watermark hit, ``idle_done`` quiescent ticks or ``max_ticks``.

``fused_epoch_cuda`` launches the hand-written Hopper kernel in
``csrc/fused_epoch.cu``: one warp runs the epoch, lane 0 making the
oracle's ordered events and all 32 lanes each scan, over the blob copied
into shared memory (see the source note), and writes it back in place,
as the reference donates its input.  A blob whose words and scratch
exceed the block's opt-in shared memory runs the same body on the blob
in device memory: ``residency`` picks the instantiation by size alone.
``epoch_ref`` is the plain version: plain Python over the CPU blob, a
line-for-line transcription of the reference's ``make_epoch_fn``
(``repro/core/fused.py:714``) that loops over live entries only (the
due wire slots, the popped ring entries, the batch's packets, the rows
in a mask) where the reference masks a fixed bound; int32 and uint32
wraparound are emulated wherever the reference's arithmetic wraps.
``fused_epoch`` dispatches on the blob's device.

``fused_epoch_cuda.launches`` counts the kernel launches of this process,
and ``fused_epoch_cuda.last_residency`` names the instantiation the last
one ran.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import chaos
from repro_torch.core import packet as pk
from repro_torch.kernels import _build

MASK = pk.PSN_MASK
SPAN = MASK + 1
HALF = MASK // 2
NEG = -(10 ** 9)             # "never happened" holdoff sentinel (rdma.py)
MAX_RETRIES = 16             # retransmit.RetransmissionBuffer.MAX_RETRIES
NAK_HOLDOFF = 8              # rdma.RdmaNode.NAK_HOLDOFF
CNP_HOLDOFF = 8              # rdma.RdmaNode.CNP_HOLDOFF
SR_WINDOW = 24               # pipeline.SR_WINDOW
M32 = 0xFFFFFFFF
MAX_G = 128                  # delivery groups the kernel's parameters hold

_PAYLOAD_OPS = frozenset(pk.PAYLOAD_OPS)
_RETH_OPS = frozenset(pk.RETH_OPS)
_LAST_OPS = frozenset((pk.WRITE_LAST, pk.WRITE_ONLY,
                       pk.READ_RESP_LAST, pk.READ_RESP_ONLY))


# ---------------------------------------------------------------------------
# Blob layout (the kernel's interface)
# ---------------------------------------------------------------------------

class _Layout:
    """Name -> (offset, shape, size) map over one flat int32 vector; a
    pure function of the shape key."""

    def __init__(self, spec):
        self.index: Dict[str, Tuple[int, Tuple[int, ...], int]] = {}
        off = 0
        for name, shape in spec:
            n = 1
            for s in shape:
                n *= s
            self.index[name] = (off, tuple(shape), n)
            off += n
        self.size = off

    def pack(self, vals: Dict[str, object]) -> np.ndarray:
        vec = np.zeros(self.size, np.int32)
        for name, (off, shape, n) in self.index.items():
            v = vals.get(name)
            if v is None:
                continue
            a = np.asarray(v, np.int64).reshape(-1)
            if a.size != n:
                raise ValueError(f"{name}: got {a.size} values, want {n}")
            vec[off:off + n] = a.astype(np.int32)
        return vec

    def get(self, vec_np: np.ndarray, name: str):
        off, shape, n = self.index[name]
        v = vec_np[off:off + n]
        return v.reshape(shape) if shape else int(v[0])

    def views(self, vec_np: np.ndarray) -> Dict[str, np.ndarray]:
        """Writable views of every field (scalars as shape (1,))."""
        return {name: vec_np[off:off + n].reshape(shape or (1,))
                for name, (off, shape, n) in self.index.items()}


@dataclasses.dataclass(frozen=True)
class ShapeKey:
    """Everything that decides the blob's layout and the epoch's static
    parameters (the reference compiles one epoch function per key; the
    kernel takes them as launch parameters)."""
    mode: str                 # "star" | "p2p"
    N: int                    # nodes
    P: int                    # star ports (0 for p2p)
    L: int                    # directed links (0 for star)
    G: int                    # delivery groups (= P or L)
    F: int                    # directed flows
    PC: int                   # plan rows per flow (bucketed)
    CC: int                   # pending chunks per flow (bucketed)
    WCAP: int                 # wire slots (bucketed)
    RCAP: int                 # egress ring depth (= queue_capacity)
    DEL: Tuple[int, ...]      # per-group delivery budget (static)
    LDST: Tuple[int, ...]     # per-link destination node (p2p)
    loss_on: bool
    ecn_on: bool
    jit_on: bool
    reo_on: bool
    wm_on: bool


_GLOBALS = ("now", "steps", "idle", "abort", "acc_ctr", "wm_hit",
            "max_ticks", "idle_done")
_FLOWS = ("f_snd", "f_sq", "f_rcv", "f_rq", "f_sr", "f_window", "f_gap_lag",
          "f_timeout", "f_base", "f_plan_len", "f_nchunks", "f_cursor",
          "f_next", "f_budget", "f_out", "f_tpassed_d", "f_last_nak",
          "f_last_nak_w", "f_last_gap", "f_last_gap_w", "f_last_cnp",
          "f_last_cnp_w", "f_wm", "f_wm_armed", "f_wm_thresh", "f_maxcred",
          "f_lastgid")
_PLAN = ("p_op", "p_plen", "p_vaddr", "p_dlen", "p_ackreq", "p_rkey",
         "p_held", "p_retr", "p_dl", "p_acc", "p_aseq", "p_aaddr")
RX_NAMES = ("rx_epsn", "rx_msn", "rx_bytes", "rx_cur", "rx_cred",
            "rx_rkey", "rx_rxbit", "rx_srf", "rx_acc", "rx_dup",
            "rx_ooo", "rx_cdrop", "rx_ecn")
_NODES = ("n_tx", "n_rx", "n_retx", "n_sacked", "n_cnptx", "n_cnprx")
_WIRE = ("w_valid", "w_arr", "w_seq", "w_dst", "w_flow", "w_pidx",
         "w_kind", "w_ap", "w_sack")
_STAR_SCALARS = ("seq", "injected_d", "cseed", "loss_t", "kmin", "kmax",
                 "csend", "cpop")
_PORTS = ("pt_enq", "pt_del", "pt_tdrop", "pt_wdrop", "pt_ecn", "pt_maxd",
          "r_head", "r_len")
_RING = ("r_flow", "r_pidx", "r_kind", "r_ap", "r_sack")
_LINKS = ("l_seed", "l_loss_t", "l_reorder_t", "l_jitter", "l_lat", "l_seq",
          "l_sent_d", "l_drop_d", "l_cidx")

# every field the kernel may address, in the order of its ``Field`` enum
# (csrc/fused_epoch.cu); a field the shape key's mode lacks gets offset -1
FIELDS = (_GLOBALS + _FLOWS + _PLAN + ("c_np",) + RX_NAMES + _NODES + _WIRE
          + ("t_order", "cnp_ord") + _STAR_SCALARS + ("delay", "red_t")
          + _PORTS + _RING + _LINKS + ("f_ldata", "f_lctrl"))


def layout_for(skey: ShapeKey) -> _Layout:
    """The blob layout of a shape key (the reference's ``_layout_for``,
    field for field and in its order)."""
    N, P, L, G, F, PC, CC = (skey.N, skey.P, skey.L, skey.G, skey.F,
                             skey.PC, skey.CC)
    WCAP, RCAP = skey.WCAP, skey.RCAP
    spec = [(n, ()) for n in _GLOBALS]
    spec += [(n, (F,)) for n in _FLOWS]
    spec += [(n, (F, PC)) for n in _PLAN] + [("c_np", (F, CC))]
    spec += [(n, (F,)) for n in RX_NAMES]
    spec += [(n, (N,)) for n in _NODES]
    spec += [(n, (WCAP,)) for n in _WIRE]
    spec += [("t_order", (F,)), ("cnp_ord", (G, F))]
    if skey.mode == "star":
        spec += [(n, ()) for n in _STAR_SCALARS]
        spec += [("delay", (P,)), ("red_t", (RCAP + 1,))]
        spec += [(n, (P,)) for n in _PORTS]
        spec += [(n, (P, RCAP)) for n in _RING]
    else:
        spec += [(n, (L,)) for n in _LINKS]
        spec += [("f_ldata", (F,)), ("f_lctrl", (F,))]
    return _Layout(spec)


@functools.lru_cache(maxsize=None)
def cached_layout(skey: ShapeKey) -> _Layout:
    return layout_for(skey)


# ---------------------------------------------------------------------------
# Kernel launch
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("fused_epoch")
    lib.fused_epoch_launch.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                       ctypes.c_int, ctypes.c_int,
                                       ctypes.c_void_p]
    lib.fused_epoch_launch.restype = ctypes.c_int
    lib.fused_epoch_smem_optin.argtypes = []
    lib.fused_epoch_smem_optin.restype = ctypes.c_int
    return lib


def batch_cap(skey: ShapeKey) -> int:
    """The most packets one delivery batch can hold (its scratch rows)."""
    return max([d for d in skey.DEL if d > 0] or [1])


@functools.lru_cache(maxsize=None)
def params(skey: ShapeKey) -> np.ndarray:
    """The kernel's launch parameters as int32 words: the sizes and
    switches, the largest batch, the blob size, every field's offset
    (``FIELDS`` order, -1 where absent), then ``DEL`` and ``LDST``
    padded to ``MAX_G``.  Read by ``fused_epoch_launch``."""
    lay = cached_layout(skey)
    if skey.G > MAX_G:
        raise ValueError(f"{skey.G} delivery groups > the kernel's {MAX_G}")
    head = [int(skey.mode == "star"), skey.N, skey.P, skey.L, skey.G,
            skey.F, skey.PC, skey.CC, skey.WCAP, skey.RCAP,
            int(skey.loss_on), int(skey.ecn_on), int(skey.jit_on),
            int(skey.reo_on), int(skey.wm_on), batch_cap(skey), lay.size]
    offs = [lay.index[n][0] if n in lay.index else -1 for n in FIELDS]
    dl = list(skey.DEL) + [0] * (MAX_G - len(skey.DEL))
    ld = list(skey.LDST) + [0] * (MAX_G - len(skey.LDST))
    return np.asarray(head + offs + dl + ld, np.int32)


RESIDENCIES = ("shared", "global")


def smem_words(skey: ShapeKey, resident: bool) -> int:
    """Words of dynamic shared memory an epoch's launch takes
    (``csrc/fused_epoch.cu:smem_words``): the blob, rounded up to 16
    bytes, when it is resident; then the scratch (3 rows of wire slots,
    10 rows of the largest batch, a word a flow)."""
    size = cached_layout(skey).size
    blob = (size + 3) // 4 * 4 if resident else 0
    return blob + 3 * skey.WCAP + 10 * batch_cap(skey) + skey.F


def residency(skey: ShapeKey, limit_bytes: int) -> str:
    """The kernel instantiation for a shape key, by size alone:
    ``"shared"`` where the blob and the scratch fit the block's opt-in
    shared memory (``limit_bytes``), else ``"global"``."""
    return "shared" if 4 * smem_words(skey, True) <= limit_bytes \
        else "global"


@functools.lru_cache(maxsize=None)
def smem_limit(device: torch.device) -> int:
    """The dynamic shared memory a block of ``device`` may opt into, in
    bytes (the card's ``cudaDevAttrMaxSharedMemoryPerBlockOptin``)."""
    with torch.cuda.device(device):
        limit = _lib().fused_epoch_smem_optin()
    if limit < 0:
        raise RuntimeError(f"no shared-memory limit for {device}")
    return limit


def _check(blob: torch.Tensor, skey: ShapeKey) -> None:
    if blob.dtype != torch.int32 or blob.dim() != 1 \
            or not blob.is_contiguous():
        raise ValueError(f"blob must be a contiguous 1-D int32 tensor, got "
                         f"{tuple(blob.shape)} {blob.dtype}")
    size = cached_layout(skey).size
    if blob.numel() != size:
        raise ValueError(f"blob holds {blob.numel()} words; the shape key's "
                         f"layout has {size}")


def fused_epoch_cuda(blob: torch.Tensor, skey: ShapeKey) -> torch.Tensor:
    """Run one epoch on the card, in place on ``blob`` (returned), in the
    instantiation ``residency`` picks for the shape key."""
    if not blob.is_cuda:
        raise ValueError("fused_epoch_cuda needs a CUDA tensor")
    _check(blob, skey)
    return _launch(blob, skey, residency(skey, smem_limit(blob.device)))


def launch_epoch(blob: torch.Tensor, skey: ShapeKey,
                 where: str) -> torch.Tensor:
    """One epoch on the card in the instantiation ``where`` names
    (``"shared"``: the blob copied into shared memory; ``"global"``: the
    blob where it lies), in place on ``blob`` (returned).  Raises for a
    resident blob over the card's limit."""
    if not blob.is_cuda:
        raise ValueError("launch_epoch needs a CUDA tensor")
    if where not in RESIDENCIES:
        raise ValueError(f"unknown residency {where!r}; choose from "
                         f"{RESIDENCIES}")
    _check(blob, skey)
    need = 4 * smem_words(skey, True)
    if where == "shared" and need > smem_limit(blob.device):
        raise ValueError(f"a {need}-byte blob and scratch exceed the "
                         f"block's shared memory")
    return _launch(blob, skey, where)


def _launch(blob: torch.Tensor, skey: ShapeKey, where: str) -> torch.Tensor:
    prm = params(skey)
    lib = _lib()
    with torch.cuda.device(blob.device):
        stream = torch.cuda.current_stream(blob.device).cuda_stream
        err = lib.fused_epoch_launch(
            blob.data_ptr(), prm.ctypes.data_as(ctypes.c_void_p),
            int(prm.size), int(where == "shared"), stream)
        fused_epoch_cuda.launches += 1
        fused_epoch_cuda.last_residency = where
    _build.check(lib, err, "fused_epoch")
    return blob


fused_epoch_cuda.launches = 0
fused_epoch_cuda.last_residency = None


def fused_epoch(blob: torch.Tensor, skey: ShapeKey) -> torch.Tensor:
    """One epoch, in place: the kernel for a CUDA blob, ``epoch_ref`` for
    a CPU blob."""
    if blob.is_cuda:
        return fused_epoch_cuda(blob, skey)
    return epoch_ref(blob, skey)


# ---------------------------------------------------------------------------
# The plain version
# ---------------------------------------------------------------------------

def w32(x: int) -> int:
    """Wrap a Python int to int32, as the reference's int32 lanes do."""
    return ((int(x) + (1 << 31)) & M32) - (1 << 31)


def _hash(seed: int, tag: int, tick: int, idx: int) -> int:
    """``chaos.hash32`` on uint32 lanes (seed, tick and rank as their
    int32 bits), the reference's in-graph ``_hash``."""
    return chaos.hash32(seed & M32, tag, tick & M32, idx & M32)


def rx_decide(st, op, psn, plen, vaddr, dma_len, ack_req, ecn, rkey):
    """One packet through the RX header FSM (the port's
    ``pipeline._rx_decide`` on scalars, valid lane).  ``st`` is the
    13-int QP row in ``RX_NAMES`` order; returns the new row and
    ``(accept, rkey_err, ecn_echo, dma_addr, send_ack, send_nak,
    ack_psn, sack)``."""
    epsn, msn, nbytes, cur, cred, trk, rxbit, srf = st[:8]
    is_payload = op in _PAYLOAD_OPS
    has_reth = op in _RETH_OPS
    is_last = op in _LAST_OPS
    sr = srf > 0
    in_seq = psn == epsn
    behind = (psn - epsn) % SPAN > HALF
    has_credit = cred > 0
    # go-back-N
    rkey_ok_g = not has_reth or trk == 0 or rkey == trk
    accept_g = is_payload and in_seq and has_credit and rkey_ok_g
    dropped_g = is_payload and in_seq and not has_credit and rkey_ok_g
    rkey_err_g = is_payload and in_seq and not rkey_ok_g
    start_addr = vaddr if has_reth else cur
    new_epsn_g = (epsn + 1) & MASK if accept_g else epsn
    # selective repeat
    d = (psn - epsn) % SPAN
    in_win = not behind and d < SR_WINDOW
    bit = (1 << min(d, SR_WINDOW - 1)) if in_win else 0
    already = (rxbit & bit) != 0
    fresh = in_win and not already
    rkey_ok_s = trk == 0 or rkey == trk
    accept_s = is_payload and fresh and has_credit and rkey_ok_s
    dropped_s = is_payload and fresh and not has_credit and rkey_ok_s
    rkey_err_s = is_payload and fresh and not rkey_ok_s
    dup_s = (behind or already) and is_payload
    ooo_s = not behind and not in_win and is_payload
    bm = rxbit | (bit if accept_s else 0)
    inv = ~bm
    adv = bin(((inv & -inv) - 1) & M32).count("1")
    new_epsn_s = (epsn + adv) & MASK
    new_rxbit_s = w32((bm & M32) >> adv) if adv < 32 else 0
    # merge
    if sr:
        accept, dup, ooo = accept_s, dup_s, ooo_s
        dropped, rkey_err, dma_addr = dropped_s, rkey_err_s, vaddr
        new_epsn, new_rxbit = new_epsn_s, new_rxbit_s
    else:
        accept, dup = accept_g, behind and is_payload
        ooo = not in_seq and not behind and is_payload
        dropped, rkey_err, dma_addr = dropped_g, rkey_err_g, start_addr
        new_epsn, new_rxbit = new_epsn_g, rxbit
    dma_addr = w32(dma_addr)
    if accept:
        new_cur = w32(dma_addr + plen)
        new_bytes = w32(dma_len - plen) if (has_reth or sr) \
            else w32(nbytes - plen)
        new_msn = w32(msn + 1) if is_last else msn
        new_cred = w32(cred - 1)
    else:
        new_cur, new_bytes, new_msn, new_cred = cur, nbytes, msn, cred
    ecn_echo = ecn > 0 and is_payload
    new = [new_epsn, new_msn, new_bytes, new_cur, new_cred, trk, new_rxbit,
           srf, w32(st[8] + accept), w32(st[9] + dup), w32(st[10] + ooo),
           w32(st[11] + dropped), w32(st[12] + ecn_echo)]
    ack_psn = psn if (not sr and accept) else (new_epsn - 1) & MASK
    send_ack = (accept and (is_last or ack_req > 0
                            or (sr and (d > 0 or adv > 1)))) or dup
    sack = new_rxbit_s if sr else 0
    return new, (accept, rkey_err, ecn_echo, dma_addr, send_ack, ooo,
                 ack_psn, sack)


class _Epoch:
    """The reference's epoch over numpy views of the blob, in its event
    order.  Reads go through ``int()``; every store of a sum is wrapped
    to int32."""

    def __init__(self, vec: np.ndarray, skey: ShapeKey):
        self.k = skey
        self.c = cached_layout(skey).views(vec)
        self.star = skey.mode == "star"

    # ---- globals ------------------------------------------------------
    def g(self, name: str) -> int:
        return int(self.c[name][0])

    def s(self, name: str, v: int) -> None:
        self.c[name][0] = w32(v)

    def add(self, name: str, i, n: int = 1) -> None:
        a = self.c[name]
        a[i] = w32(int(a[i]) + n)

    # ---- wire / ring --------------------------------------------------
    def wire_push(self, arr, loc, seqv, f, kind, pidx, ap, sack):
        c = self.c
        free = np.flatnonzero(c["w_valid"] == 0)
        slot = int(free[0]) if free.size else 0
        self.s("abort", self.g("abort") | int(c["w_valid"][slot]))
        for name, v in (("w_valid", 1), ("w_arr", arr), ("w_seq", seqv),
                        ("w_dst", loc), ("w_flow", f), ("w_pidx", pidx),
                        ("w_kind", kind), ("w_ap", ap), ("w_sack", sack)):
            c[name][slot] = w32(v)

    def ring_enq(self, dst, f, kind, pidx, ap, sack):
        c, rcap = self.c, self.k.RCAP
        depth = int(c["r_len"][dst])
        if depth >= rcap:
            self.add("pt_tdrop", dst)
            return
        slot = (int(c["r_head"][dst]) + depth) % rcap
        for name, v in (("r_flow", f), ("r_pidx", pidx), ("r_kind", kind),
                        ("r_ap", ap), ("r_sack", sack)):
            c[name][dst, slot] = v
        self.add("r_len", dst)
        self.add("pt_enq", dst)
        c["pt_maxd"][dst] = max(int(c["pt_maxd"][dst]), depth + 1)

    # ---- transmit -----------------------------------------------------
    def send(self, src, f, kind, pidx, ap, sack):
        c, k, now = self.c, self.k, self.g("now")
        self.add("n_tx", src)
        if self.star:
            dst = int(c["f_rcv"][f] if kind == 0 else c["f_snd"][f])
            self.s("injected_d", self.g("injected_d") + 1)
            if k.loss_on:
                h = _hash(self.g("cseed"), chaos.TAG_LOSS, now,
                          self.g("csend"))
                lost = h < (self.g("loss_t") & M32)
                self.s("csend", self.g("csend") + 1)
                if lost:
                    self.add("pt_wdrop", dst)
                    return
            seqv = w32(self.g("seq") + 1)
            self.s("seq", seqv)
            self.wire_push(now + int(c["delay"][src]), dst, seqv, f, kind,
                           pidx, ap, sack)
            return
        link = int(c["f_ldata"][f] if kind == 0 else c["f_lctrl"][f])
        self.add("l_sent_d", link)
        rank = int(c["l_cidx"][link])
        self.add("l_cidx", link)
        seed = int(c["l_seed"][link])
        if k.loss_on and _hash(seed, chaos.TAG_LOSS, now, rank) \
                < (int(c["l_loss_t"][link]) & M32):
            self.add("l_drop_d", link)
            return
        delay = int(c["l_lat"][link])
        if k.jit_on:
            delay += _hash(seed, chaos.TAG_JITTER, now, rank) % (
                (int(c["l_jitter"][link]) + 1) & M32)
        if k.reo_on and _hash(seed, chaos.TAG_REORDER, now, rank) \
                < (int(c["l_reorder_t"][link]) & M32):
            delay += 1 + _hash(seed, chaos.TAG_RDELAY, now, rank) % 7
        seqv = w32(int(c["l_seq"][link]) + 1)
        c["l_seq"][link] = seqv
        self.wire_push(now + w32(delay), link, seqv, f, kind, pidx, ap, sack)

    def send_data(self, f, row):
        self.send(int(self.c["f_snd"][f]), f, 0, row, 0, 0)

    def send_ctrl(self, f, kind, ap, sack):
        self.send(int(self.c["f_rcv"][f]), f, kind, 0, ap, sack)

    def bump_send(self, f, row):
        c = self.c
        r = w32(int(c["p_retr"][f, row]) + 1)
        c["p_retr"][f, row] = r
        if r > MAX_RETRIES:
            self.s("abort", 1)
            return
        tmo = int(c["f_timeout"][f])
        c["p_dl"][f, row] = w32(self.g("now") + w32(tmo * (1 << min(r, 4))))
        self.add("n_retx", int(c["f_snd"][f]))
        self.send_data(f, row)

    # ---- control-plane handlers ---------------------------------------
    def psn_rows(self, f) -> np.ndarray:
        return (int(self.c["f_base"][f])
                + np.arange(self.k.PC, dtype=np.int64)) & MASK

    def on_ack(self, f, ap, sack):
        c, k, now = self.c, self.k, self.g("now")
        psn_row = self.psn_rows(f)
        held = c["p_held"][f] > 0
        rel1 = held & (((ap - psn_row) & MASK) <= HALF)
        n1 = int(rel1.sum())
        held1 = held & ~rel1
        usack = sack & M32
        off2 = (psn_row - ap - 1) & MASK
        inb = (off2 >= 1) & (off2 <= 31)
        bitv = (usack >> np.where(inb, off2, 0)) & 1
        rel2 = held1 & inb & (bitv > 0) & (sack != 0)
        n2 = int(rel2.sum())
        held2 = held1 & ~rel2
        c["p_held"][f] = held2
        if n1 or n2:
            c["p_retr"][f][held2] = 0
        self.add("n_sacked", int(c["f_snd"][f]), n2)
        # SACK-driven gap resend: the row mask is taken once, then bumped
        if sack != 0 and not w32(now - int(c["f_last_gap"][f])) < NAK_HOLDOFF:
            bl = usack.bit_length()
            hi = (ap + bl) & MASK
            offg = (psn_row - ap) & MASK
            lag = (hi - psn_row) & MASK
            gmask = (held2 & (offg > 0) & (offg <= HALF) & (lag <= HALF)
                     & (lag >= int(c["f_gap_lag"][f])))
            rows = np.flatnonzero(gmask)
            if rows.size:
                c["f_last_gap"][f] = now
                c["f_last_gap_w"][f] = 1
            for row in rows:
                self.bump_send(f, int(row))
        # ACK-clocked flow control: release, drain, dispatch
        rel = max(n1 + n2, 1)
        out0 = max(0, int(c["f_out"][f]) - rel)
        bud = min(int(c["f_window"][f]), int(c["f_budget"][f]) + rel)
        cur0, nch = int(c["f_cursor"][f]), int(c["f_nchunks"][f])
        taken = tot = 0
        for kk in range(k.CC):
            if cur0 + kk >= nch:
                break
            need = int(c["c_np"][f, min(cur0 + kk, k.CC - 1)])
            if need > bud:
                break
            bud -= need
            taken += 1
            tot += need
        nxt0 = int(c["f_next"][f])
        self.add("f_cursor", f, taken)
        self.add("f_next", f, tot)
        c["f_out"][f] = w32(out0 + tot)
        c["f_budget"][f] = bud
        self.add("f_tpassed_d", f, taken)
        for kk in range(min(tot, k.PC)):
            row = nxt0 + kk
            c["p_held"][f, row] = 1
            c["p_retr"][f, row] = 0
            c["p_dl"][f, row] = w32(now + int(c["f_timeout"][f]))
            self.send_data(f, row)

    def on_nak(self, f, ap):
        c, now = self.c, self.g("now")
        if w32(now - int(c["f_last_nak"][f])) < NAK_HOLDOFF:
            return
        c["f_last_nak"][f] = now
        c["f_last_nak_w"][f] = 1
        expected = (ap + 1) & MASK
        mask = (c["p_held"][f] > 0) & (
            ((self.psn_rows(f) - expected) & MASK) <= HALF)
        for row in np.flatnonzero(mask):
            self.bump_send(f, int(row))

    # ---- one delivered batch through one node -------------------------
    def process_batch(self, g, dst, batch):
        """``batch``: the delivered packets in order, each ``(flow, pidx,
        kind, ack_psn, sack, ecn)``."""
        c, k = self.c, self.k
        self.add("n_rx", dst, len(batch))
        for f, _p, kind, ap, sack, _e in batch:            # pass A
            if kind == 1:
                self.on_ack(f, ap, sack)
            elif kind == 2:
                self.on_nak(f, ap)
            elif kind == 3:
                self.add("n_cnprx", int(c["f_snd"][f]))
        data = [(i, b) for i, b in enumerate(batch) if b[2] == 0]
        if data:                                             # credit reset
            mine = c["f_rcv"] == dst
            c["rx_cred"][mine] = c["f_maxcred"][mine]
        ecn_f: Dict[int, int] = {}
        resp = []
        rx = [c[n] for n in RX_NAMES]
        for _i, (f, pidx, _k, _a, _s, ecn) in data:          # pass E
            st = [int(col[f]) for col in rx]
            psn = (int(c["f_base"][f]) + pidx) & MASK
            new, out = rx_decide(
                st, int(c["p_op"][f, pidx]), psn, int(c["p_plen"][f, pidx]),
                int(c["p_vaddr"][f, pidx]), int(c["p_dlen"][f, pidx]),
                int(c["p_ackreq"][f, pidx]), ecn, int(c["p_rkey"][f, pidx]))
            for col, v in zip(rx, new):
                col[f] = v
            accept, rkey_err, ecn_echo, dma_a, send_ack, send_nak, ack_psn, \
                sk = out
            self.s("abort", self.g("abort") | int(rkey_err))
            ecn_f[f] = ecn_f.get(f, 0) + int(ecn_echo)
            if accept:
                aseq = self.g("acc_ctr")
                self.s("acc_ctr", aseq + 1)
                c["p_acc"][f, pidx] = 1
                c["p_aseq"][f, pidx] = aseq
                c["p_aaddr"][f, pidx] = dma_a
                if int(c["rx_srf"][f]) <= 0:
                    c["f_wm"][f] = max(int(c["f_wm"][f]),
                                       w32(dma_a + int(c["p_plen"][f, pidx])))
            resp.append((f, send_ack, send_nak, ack_psn, sk))
        if k.ecn_on:                                         # CNPs
            now = self.g("now")
            for fidx in c["cnp_ord"][g]:
                f = int(fidx)
                if f < 0 or ecn_f.get(f, 0) <= 0:
                    continue
                if w32(now - int(c["f_last_cnp"][f])) < CNP_HOLDOFF:
                    continue
                c["f_last_cnp"][f] = now
                c["f_last_cnp_w"][f] = 1
                self.add("n_cnptx", dst)
                self.send_ctrl(f, 3, 0, 0)
        for f, send_ack, send_nak, ack_psn, sk in resp:      # pass D
            if send_ack:
                self.send_ctrl(f, 1, ack_psn, sk)
            if send_nak:
                self.send_ctrl(f, 2, ack_psn, 0)

    # ---- one network tick ---------------------------------------------
    def due(self, link: Optional[int] = None):
        """Due wire slots in pop order: (arrival, seq), then slot."""
        c, now = self.c, self.g("now")
        m = (c["w_valid"] > 0) & (c["w_arr"] <= now)
        if link is not None:
            m &= c["w_dst"] == link
        slots = np.flatnonzero(m)
        return sorted(slots.tolist(), key=lambda s: (int(c["w_arr"][s]),
                                                     int(c["w_seq"][s]), s))

    def tick(self):
        c, k = self.c, self.k
        self.s("now", self.g("now") + 1)
        if self.star:
            if k.loss_on or k.ecn_on:
                self.s("csend", 0)
                self.s("cpop", 0)
            for s in self.due():                             # wire -> rings
                c["w_valid"][s] = 0
                self.ring_enq(int(c["w_dst"][s]), int(c["w_flow"][s]),
                              int(c["w_kind"][s]), int(c["w_pidx"][s]),
                              int(c["w_ap"][s]), int(c["w_sack"][s]))
            for port in range(k.P):                          # drain ports
                B = k.DEL[port]
                if B == 0:
                    continue
                len0, head0 = int(c["r_len"][port]), int(c["r_head"][port])
                n_pop = min(B, len0)
                batch = []
                for j in range(n_pop):
                    slot = (head0 + j) % k.RCAP
                    mark = 0
                    if k.ecn_on:
                        depth = len0 - j
                        rank = self.g("cpop")
                        self.s("cpop", rank + 1)
                        h = _hash(self.g("cseed"), chaos.TAG_RED,
                                  self.g("now"), rank)
                        mark = int(depth >= self.g("kmax") or (
                            depth > self.g("kmin")
                            and h < (int(c["red_t"][depth]) & M32)))
                        self.add("pt_ecn", port, mark)
                    batch.append((int(c["r_flow"][port, slot]),
                                  int(c["r_pidx"][port, slot]),
                                  int(c["r_kind"][port, slot]),
                                  int(c["r_ap"][port, slot]),
                                  int(c["r_sack"][port, slot]), mark))
                c["r_head"][port] = (head0 + n_pop) % k.RCAP
                self.add("r_len", port, -n_pop)
                self.add("pt_del", port, n_pop)
                self.process_batch(port, port, batch)
        else:
            if k.loss_on or k.jit_on or k.reo_on:
                c["l_cidx"][:] = 0
            for li in range(k.L):                            # link order
                batch = []
                for s in self.due(li)[:k.DEL[li]]:
                    c["w_valid"][s] = 0
                    batch.append((int(c["w_flow"][s]), int(c["w_pidx"][s]),
                                  int(c["w_kind"][s]), int(c["w_ap"][s]),
                                  int(c["w_sack"][s]), 0))
                self.process_batch(li, k.LDST[li], batch)
        now = self.g("now")                                  # timers
        for f in c["t_order"]:
            f = int(f)
            rows = np.flatnonzero((c["p_held"][f] > 0) & (now >= c["p_dl"][f]))
            for row in rows:
                self.bump_send(f, int(row))
        pending = (c["w_valid"].any() or c["p_held"].any()
                   or (c["f_cursor"] < c["f_nchunks"]).any()
                   or (self.star and (c["r_len"] > 0).any()))
        self.s("idle", 0 if pending else self.g("idle") + 1)
        self.s("steps", self.g("steps") + 1)
        if k.wm_on:
            self.s("wm_hit", int(((c["f_wm_armed"] > 0)
                                  & (c["f_wm"] >= c["f_wm_thresh"])).any()))

    def run(self):
        while (self.g("abort") == 0 and self.g("wm_hit") == 0
               and self.g("idle") < self.g("idle_done")
               and self.g("steps") < self.g("max_ticks")):
            self.tick()


def epoch_ref(blob: torch.Tensor, skey: ShapeKey) -> torch.Tensor:
    """The plain version: one epoch in plain Python over a CPU blob, in
    place (returned)."""
    if blob.is_cuda:
        raise ValueError("epoch_ref runs on a CPU blob")
    _check(blob, skey)
    _Epoch(blob.numpy(), skey).run()
    return blob
