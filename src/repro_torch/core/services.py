"""Service chain (paper §5): protocol enhancements attached to the
datapath, on PyTorch tensors.

Two placements, exactly as Fig. 1:
  * OnPathService     — transforms the payload stream in-line (①, e.g.
                        AES); its latency adds, its throughput must hold
                        line rate.
  * ParallelPathService — observes a multiplexed copy and feeds a
                        decision back to the pipeline (②, e.g. ML-DPI);
                        its latency must hide behind the packet pipeline.

Payload batches are (N, MTU) uint8 tensors.  Each service is backed by a
hand-written CUDA kernel and its plain PyTorch version
(``repro_torch.kernels.ops``): a batch on the card goes to the kernel, a
batch on the CPU to the plain version.  ``impl="ref"`` asks for the
plain version by name, so the two can be compared on the card.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels import ops
from repro_torch.kernels.dpi_mlp import dpi_params_from_numpy
from repro_torch.kernels.ref import as_int32


class OnPathService:
    """Payload transformer: (N, MTU) uint8 -> (N, MTU) uint8."""
    name = "identity"

    def __call__(self, payload: torch.Tensor, plen: torch.Tensor
                 ) -> torch.Tensor:
        return payload


class ParallelPathService:
    """Payload inspector: (N, MTU) uint8 -> (N,) int32 flags."""
    name = "null-inspect"

    def __call__(self, payload: torch.Tensor, plen: torch.Tensor
                 ) -> torch.Tensor:
        return torch.zeros(payload.shape[0], dtype=torch.int32,
                           device=payload.device)


@dataclasses.dataclass
class AesService(OnPathService):
    """AES-128-ECB on the payload stream (paper §5.1.1).  Keys are
    exchanged out-of-band at QP setup; ECB blocks are independent, so the
    stream pipelines with zero throughput cost."""
    key: np.ndarray = None            # (16,) uint8
    decrypt: bool = False
    impl: Optional[str] = None        # None: by device; "ref": plain
    device: DeviceLike = None         # default: the card
    name: str = "aes-ecb"

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self._round_keys = torch.as_tensor(
            ops.expand_key(np.asarray(self.key, np.uint8))).to(self.device)

    def __call__(self, payload: torch.Tensor, plen: torch.Tensor
                 ) -> torch.Tensor:
        n, mtu = payload.shape
        blocks = payload.reshape(n * (mtu // 16), 16)
        out = ops.aes_ecb(blocks, self._round_keys, decrypt=self.decrypt,
                          impl=self.impl)
        return out.reshape(n, mtu)


@dataclasses.dataclass
class DpiService(ParallelPathService):
    """ML-based deep packet inspection (paper §5.1.2): a ternary
    fully-connected net scores every 64-byte beat; per-packet flags are
    the aggregated decision, fed back into the host-directed command.
    ``params`` may be the reference's numpy arrays or the port's
    tensors (``dpi_params_from_numpy``)."""
    params: Dict = None               # ternary MLP weights
    # decision margin over the max beat score (benign max <~0.7,
    # embedded executables >~1.8)
    threshold: float = 1.0
    impl: Optional[str] = None
    device: DeviceLike = None
    name: str = "ml-dpi"

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self.params = dpi_params_from_numpy(
            {k: (v.cpu().numpy() if isinstance(v, torch.Tensor) else v)
             for k, v in self.params.items()}, self.device)

    def __call__(self, payload: torch.Tensor, plen: torch.Tensor
                 ) -> torch.Tensor:
        scores = ops.dpi_scores(payload, self.params, impl=self.impl)
        beats = payload.shape[1] // 64
        beat_valid = (torch.arange(beats, device=payload.device)[None, :]
                      * 64) < plen[:, None]
        agg = torch.amax(torch.where(beat_valid, scores,
                                     torch.full_like(scores, -np.inf)),
                         dim=1)
        return (agg > self.threshold).to(torch.int32)


@dataclasses.dataclass
class PreprocService(OnPathService):
    """DLRM preprocessing offload (paper §8.1): Neg2Zero -> Log on dense
    features, Modulus on sparse features, at line rate on the stream.
    Payload layout: int32 little-endian, ``n_dense`` dense then
    ``n_sparse`` sparse columns per record, as many whole records per
    packet as fit; the words past the last whole record pass through
    untouched.  The kernel reads the records in place, through the
    packets' row stride."""
    n_dense: int = 13
    n_sparse: int = 26
    modulus: int = 100_000
    impl: Optional[str] = None
    device: DeviceLike = None
    name: str = "dlrm-preproc"

    def __post_init__(self):
        self.device = resolve_device(self.device)

    def __call__(self, payload: torch.Tensor, plen: torch.Tensor
                 ) -> torch.Tensor:
        n, mtu = payload.shape
        rec_words = self.n_dense + self.n_sparse
        n_rec = (mtu // 4) // rec_words
        x = payload.contiguous().view(torch.int32)          # (N, MTU/4)
        out = ops.preproc(x[:, :n_rec * rec_words], self.n_dense,
                          self.modulus, rec_w=rec_words, impl=self.impl)
        words = torch.cat([out.reshape(n, n_rec * rec_words),
                           x[:, n_rec * rec_words:]], dim=1)
        return words.view(torch.uint8)


@dataclasses.dataclass
class CrcService(ParallelPathService):
    """ICRC check (paper §4.5) as a parallel-path inspector.

    Like the reference (``repro.core.services.CrcService``), it returns
    the raw CRC32 of each payload wrapped to int32, not a mismatch flag
    as its name suggests: ``ServiceChain`` ORs that value into the flag
    word, so nearly every packet it inspects comes out flagged.  Kept bit
    for bit, because the port is held against the reference."""
    impl: Optional[str] = None
    device: DeviceLike = None
    name: str = "icrc"

    def __post_init__(self):
        self.device = resolve_device(self.device)

    def __call__(self, payload: torch.Tensor, plen: torch.Tensor
                 ) -> torch.Tensor:
        return ops.crc32_int32(payload, plen, impl=self.impl)


class ServiceChain:
    """Composable datapath: on-path services apply in order; parallel-path
    services run on a multiplexed copy and merge decision flags into the
    host-directed command.

    Placement matters (paper Fig. 1): ``parallel`` inspectors tap the
    stream as it arrives (before on-path transforms — e.g. ICRC over the
    wire bytes); ``parallel_after`` inspectors tap it after the on-path
    services (e.g. DPI over the *decrypted* payload of an encrypted
    flow)."""

    MAX_INSPECTORS = 32          # decision flags pack into one 32-bit word

    def __init__(self, on_path: Sequence[OnPathService] = (),
                 parallel: Sequence[ParallelPathService] = (),
                 parallel_after: Sequence[ParallelPathService] = ()):
        self.on_path = list(on_path)
        self.parallel = list(parallel)
        self.parallel_after = list(parallel_after)
        inspectors = self.parallel + self.parallel_after
        if len(inspectors) > self.MAX_INSPECTORS:
            raise ValueError(
                f"{len(inspectors)} parallel-path inspectors; the "
                f"host-directed command carries at most "
                f"{self.MAX_INSPECTORS} decision flag bits")
        # explicit flag-bit layout: bit i belongs to inspectors[i]
        # (pre-transform taps first, then post-transform taps), exposed
        # by *name* so consumers never depend on insertion order
        self._par_bits = list(range(len(self.parallel)))
        self._par_after_bits = list(range(len(self.parallel),
                                          len(inspectors)))
        self.flag_bits: Dict[str, int] = {}
        for bit, svc in enumerate(inspectors):
            name = svc.name
            if name in self.flag_bits:       # duplicate service names
                name = f"{name}@{bit}"
            self.flag_bits[name] = bit

    def process(self, payload: torch.Tensor, plen: torch.Tensor):
        """(N, MTU) uint8, (N,) lengths -> (payload out, (N,) int32 flags)."""
        flags = torch.zeros(payload.shape[0], dtype=torch.int32,
                            device=payload.device)
        for svc, bit in zip(self.parallel, self._par_bits):
            flags = flags | as_int32(svc(payload, plen).to(torch.int64)
                                     << bit)
        out = payload
        for svc in self.on_path:
            out = svc(out, plen)
        for svc, bit in zip(self.parallel_after, self._par_after_bits):
            flags = flags | as_int32(svc(out, plen).to(torch.int64) << bit)
        return out, flags

    def describe(self) -> str:
        on = " -> ".join(s.name for s in self.on_path) or "(none)"
        par = ", ".join(s.name for s in self.parallel + self.parallel_after) \
            or "(none)"
        return f"on-path: {on}; parallel-path: {par}"
