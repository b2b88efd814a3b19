"""The port's two other paper examples as entry points, on the CPU.

* ``repro_torch.examples.secure_flow.main`` with the reference
  example's asserts (``examples/secure_flow.py``); the run itself is
  held against the reference example in ``test_torch_slice.py``.
* ``repro_torch.examples.dlrm_ingest.main`` against
  ``examples/dlrm_ingest.py`` run in-process through ``repro`` from the
  same initial weights (the reference's ``init_params(key(0))``, which
  the example makes): every shard's goodput and overlap equal, each
  shard's loss and the trained parameters after 30 shards x 5 SGD steps
  within the DLRM's rtol = 1e-5, atol = 1e-6 (float32 products summed
  in another order); the worst errors are printed.
"""
import importlib.util
import struct
from pathlib import Path

import jax
import numpy as np
import torch
from jax.flatten_util import ravel_pytree

from repro_torch.examples import dlrm_ingest, secure_flow

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
RTOL, ATOL = 1e-5, 1e-6


def test_secure_flow_example(tmp_path):
    pcap = tmp_path / "flow.pcap"
    out = secure_flow.main(device="cpu", pcap=str(pcap))
    # DPI flags the malicious flow and none of the benign one
    assert out["flagged"]["malicious"] > 0
    assert out["flagged"]["benign"] == 0
    data = pcap.read_bytes()
    assert out["pcap_packets"] > 0
    magic, = struct.unpack("<I", data[:4])
    assert magic == 0xA1B2C3D4                  # a little-endian PCAP


class _JaxRecordingJit:
    """Stands in for the ``jax`` module in the reference example: its
    ``jax.jit`` functions record every call's outputs."""

    def __init__(self):
        self.outputs = []

    def __getattr__(self, name):
        return getattr(jax, name)

    def jit(self, fn):
        jitted = jax.jit(fn)

        def run(*a):
            out = jitted(*a)
            self.outputs.append(out)
            return out
        return run


def _reference_dlrm_ingest(monkeypatch):
    """``examples/dlrm_ingest.py``'s main, run in-process; returns its
    initial parameter tree, the loss of each shard's last step, each
    shard's report and the trained parameter tree."""
    spec = importlib.util.spec_from_file_location(
        "reference_dlrm_ingest", ROOT / "examples" / "dlrm_ingest.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    rec = {"init": [], "reports": []}
    fake_jax = _JaxRecordingJit()

    class Model(mod.DLRM):
        def init_params(self, key):
            rec["init"].append(super().init_params(key))
            return rec["init"][-1]

    class Ingest(mod.BalboaIngest):
        def stream_batches(self, *a, **k):
            for batch, rep in super().stream_batches(*a, **k):
                rec["reports"].append(rep)
                yield batch, rep

    monkeypatch.setattr(mod, "jax", fake_jax)
    monkeypatch.setattr(mod, "DLRM", Model)
    monkeypatch.setattr(mod, "BalboaIngest", Ingest)
    mod.main()
    steps = fake_jax.outputs
    per_shard = len(steps) // len(rec["reports"])
    return {"init": rec["init"][0],
            "losses": [float(out[1]) for out in steps[per_shard - 1::
                                                        per_shard]],
            "reports": rec["reports"], "trained": steps[-1][0],
            "per_shard": per_shard}


def test_dlrm_ingest_example(monkeypatch):
    ref = _reference_dlrm_ingest(monkeypatch)
    assert ref["per_shard"] == dlrm_ingest.STEPS_PER_SHARD
    out = dlrm_ingest.main(device="cpu",
                           params=jax.tree.map(np.asarray, ref["init"]))
    # the reference example's own asserts
    assert len(out["losses"]) == dlrm_ingest.N_SHARDS
    assert out["losses"][-1] < out["losses"][0]
    assert out["host_payload_bytes"] == 0
    assert min(out["goodputs"]) > 0 and 0 < min(out["overlaps"]) <= 1
    # and the reference example's run
    assert out["goodputs"] == [r.goodput_bytes_per_tick
                               for r in ref["reports"]]
    assert out["overlaps"] == [r.overlap_efficiency for r in ref["reports"]]
    np.testing.assert_allclose(out["losses"], ref["losses"], rtol=RTOL,
                               atol=ATOL)
    want = np.asarray(ravel_pytree(ref["trained"])[0])
    assert out["flat"].shape == want.shape
    np.testing.assert_allclose(out["flat"], want, rtol=RTOL, atol=ATOL)
    print(f"worst |loss port - loss reference| over "
          f"{len(out['losses'])} shards: "
          f"{np.max(np.abs(np.subtract(out['losses'], ref['losses']))):.3e}; "
          f"worst |params port - params reference|: "
          f"{float(np.max(np.abs(out['flat'] - want))):.3e}")
