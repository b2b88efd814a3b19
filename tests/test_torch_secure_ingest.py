"""Encrypted streaming ingest that trains the DLRM, through both
packages, on the CPU.

The storage replicas hold each shard AES-128-ECB encrypted at rest.
Every tile the trainer acknowledges goes through the fused decrypt+DPI
pass, then the DLRM tile decoder (Neg2Zero -> Log, Modulus) on the
plaintext; the landed batch trains the DLRM for 5 SGD steps at lr 0.05,
as ``examples/dlrm_ingest.py`` trains it.  The JAX side runs its fused
kernel's tile entry (``fused_decrypt_dpi_tile``) in interpret mode.

Tolerances, each stated where it is used, with the worst error printed:
ciphertexts, reports, events and sparse ids equal; dense words within 1
ulp (``log1p`` differs by 1 ulp between torch and XLA on the CPU); DPI
scores within 1e-5 and the flagged count (score > 1.0, ``DpiService``'s
threshold) equal; losses and parameters after training within
rtol = 1e-5, atol = 1e-6 (15 float32 SGD steps with sums taken in
another order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import dlrm as jcfg
from repro.core import ingest as jing
from repro.kernels import ops as jops
from repro.kernels.fused_chain import fused_decrypt_dpi_tile as jtile
from repro.models.dlrm import DLRM as JDLRM
from repro_torch.configs import dlrm as tcfg
from repro_torch.core import ingest as ting
from repro_torch.data import load_dpi_params_seed0
from repro_torch.data import synthetic as syn
from repro_torch.kernels import ops
from repro_torch.kernels.dpi_mlp import dpi_params_from_numpy
from repro_torch.kernels.fused_chain import fused_decrypt_dpi_tile
from repro_torch.models.dlrm import DLRM, dlrm_params_from_numpy

torch.set_num_threads(1)

MTU = 4096
N_PKTS = 8                      # packets per shard
N_SHARDS = 3
LR, STEPS = 0.05, 5             # examples/dlrm_ingest.py
DPI_TOL = 1e-5
DPI_THRESHOLD = 1.0
TRAIN_RTOL, TRAIN_ATOL = 1e-5, 1e-6
GRAD_RTOL, GRAD_ATOL = 1e-5, 1e-7
KEY = np.random.default_rng(13).integers(0, 256, 16, dtype=np.uint8)


def _records(cfg, i):
    rpp = (MTU // 4) // (cfg.n_dense + cfg.n_sparse)
    return syn.dlrm_shard(i, rpp * N_PKTS, cfg.n_dense, cfg.n_sparse)


def _torch_sgd(model, batch):
    """One step as the reference example takes it: loss, gradient,
    ``p - lr * g``."""
    model.zero_grad(set_to_none=True)
    loss, _ = model.loss(batch)
    loss.backward()
    with torch.no_grad():
        for p in model.parameters():
            p -= LR * p.grad
    return float(loss.detach())


def _ingest_kw():
    return dict(batch_bytes=N_PKTS * MTU, n_storage_nodes=2, qps_per_node=2,
                tile_pkts=2, link_bw_pkts_per_tick=1)


def test_secure_ingest_trains_like_the_reference():
    cfg = jcfg.smoke_config()
    rk = ops.expand_key(KEY)
    plain = [syn.encode_dlrm_packets(_records(cfg, i))
             for i in range(N_SHARDS)]
    # the shards at rest, encrypted once by each package
    tct = [ops.aes_ecb(torch.from_numpy(p.reshape(-1, 16).copy()), rk)
           .numpy().reshape(-1) for p in plain]
    jct = [np.asarray(jops.aes_ecb(jnp.asarray(p.reshape(-1, 16)), rk,
                                   impl="ref")).reshape(-1) for p in plain]
    for t, j in zip(tct, jct):
        np.testing.assert_array_equal(t, j)

    dpi = load_dpi_params_seed0()
    tdpi = dpi_params_from_numpy(dpi, "cpu")
    jdpi = {k: jnp.asarray(v) for k, v in dpi.items()}
    tdec = ting.make_dlrm_tile_decoder(cfg.n_dense, cfg.n_sparse, cfg.modulus)
    jdec = jing.make_dlrm_tile_decoder(cfg.n_dense, cfg.n_sparse, cfg.modulus)

    def ttile(tile):
        pt, score = fused_decrypt_dpi_tile(tile, rk, tdpi, tile_pkts=2)
        return {**tdec(pt), "dpi_score": score}

    def jtile_fn(tile):
        pt, score = jtile(tile, rk, jdpi, tile_pkts=2)
        return {**jdec(pt), "dpi_score": score}

    def poisoned(raw):
        raise AssertionError("host decode touched payload bytes")

    t = ting.BalboaIngest(ting.IngestConfig(**_ingest_kw()), None,
                          lambda i: tct[i], decode_fn=poisoned,
                          tile_to_batch=ttile, device="cpu")
    j = jing.BalboaIngest(jing.IngestConfig(**_ingest_kw()), None,
                          lambda i: jct[i], decode_fn=poisoned,
                          tile_to_batch=jtile_fn)

    jm = JDLRM(cfg)
    jparams = jm.init_params(jax.random.key(0))
    tm = DLRM(tcfg.smoke_config(), device="cpu")
    tm.load_state_dict(dlrm_params_from_numpy(
        jax.tree.map(np.asarray, jparams), "cpu"))

    @jax.jit
    def train_step(p, batch):
        (l, m), g = jax.value_and_grad(jm.loss, has_aux=True)(p, batch)
        return jax.tree.map(lambda a, b: a - LR * b, p, g), l

    worst_ulp = worst_score = worst_loss = 0.0
    for i, ((tb, trep), (jb, jrep)) in enumerate(
            zip(t.stream_batches(N_SHARDS), j.stream_batches(N_SHARDS))):
        assert (trep.ticks, trep.tiles, trep.tiles_overlapped,
                trep.refetches, trep.events) == \
            (jrep.ticks, jrep.tiles, jrep.tiles_overlapped, jrep.refetches,
             jrep.events), f"shard {i}: reports differ"
        # the decrypted records are the plaintext records
        raw = _records(cfg, i)
        np.testing.assert_array_equal(tb["sparse"].numpy(),
                                      raw[:, cfg.n_dense:] % cfg.modulus)
        np.testing.assert_allclose(
            tb["dense"].numpy(), np.log1p(np.maximum(raw[:, :cfg.n_dense],
                                                     0)), rtol=1e-5)
        np.testing.assert_array_equal(tb["sparse"].numpy(),
                                      np.asarray(jb["sparse"]))
        ulps = int(np.abs(tb["dense"].numpy().view(np.int32).astype(np.int64)
                          - np.asarray(jb["dense"]).view(np.int32)).max())
        assert ulps <= 1, f"shard {i}: dense {ulps} ulp from the reference"
        worst_ulp = max(worst_ulp, ulps)
        ts, js = tb["dpi_score"].numpy(), np.asarray(jb["dpi_score"])
        assert ts.shape == (N_PKTS,)
        np.testing.assert_allclose(ts, js, rtol=DPI_TOL, atol=DPI_TOL)
        worst_score = max(worst_score, float(np.abs(ts - js).max()))
        flagged = int((ts > DPI_THRESHOLD).sum())
        assert flagged == int((js > DPI_THRESHOLD).sum())

        label = syn.dlrm_labels(raw, cfg.n_dense, cfg.modulus)
        tbatch = {"dense": tb["dense"], "sparse": tb["sparse"],
                  "label": torch.from_numpy(label)}
        jbatch = {"dense": jb["dense"], "sparse": jb["sparse"],
                  "label": jnp.asarray(label)}
        tl = [_torch_sgd(tm, tbatch) for _ in range(STEPS)]
        jl = []
        for _ in range(STEPS):
            jparams, loss = train_step(jparams, jbatch)
            jl.append(float(loss))
        with torch.no_grad():
            after = float(tm.loss(tbatch)[0])
        print(f"shard {i}: {flagged} of {N_PKTS} packets flagged; losses "
              f"{['%.6f' % x for x in tl]} (port) vs "
              f"{['%.6f' % x for x in jl]} (reference), after {after:.6f}")
        np.testing.assert_allclose(tl, jl, rtol=TRAIN_RTOL, atol=TRAIN_ATOL)
        worst_loss = max(worst_loss, float(np.abs(np.subtract(tl, jl)).max()))
        assert after < tl[0], f"shard {i}: loss did not fall"

    want = dlrm_params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    worst_param = 0.0
    for k, v in tm.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(),
                                   rtol=TRAIN_RTOL, atol=TRAIN_ATOL,
                                   err_msg=k)
        worst_param = max(worst_param,
                          float((v - want[k]).abs().max()))
    print(f"secure ingest: dense worst {worst_ulp} ulp, scores worst "
          f"{worst_score:.3e} (tol {DPI_TOL}), losses worst {worst_loss:.3e}, "
          f"parameters worst {worst_param:.3e} (rtol={TRAIN_RTOL}, "
          f"atol={TRAIN_ATOL})")
    assert t.host_payload_bytes == 0 and j.host_payload_bytes == 0


def test_out_of_range_ids_send_no_gradient_like_jax():
    """JAX clamps an out-of-range gather id in the forward pass but drops
    its gradient; the port keeps the clamped value and drops the
    gradient of every id still outside the table after the negative
    wrap.  Gradients held against ``jax.grad`` of the reference loss."""
    cfg = jcfg.smoke_config()
    rows = cfg.embed_rows
    jm = JDLRM(cfg)
    params = jm.init_params(jax.random.key(4))
    tm = DLRM(tcfg.smoke_config(), device="cpu")
    tm.load_state_dict(dlrm_params_from_numpy(
        jax.tree.map(np.asarray, params), "cpu"))
    rng = np.random.default_rng(4)
    odd = np.array([-2 * rows, -rows - 1, -1, rows, 5 * rows])
    b = 12
    sparse = rng.integers(1, rows - 1, (b, cfg.n_sparse))
    sparse[:len(odd)] = odd[:, None]             # every table sees them
    batch = {"dense": rng.random((b, cfg.n_dense)).astype(np.float32),
             "sparse": sparse.astype(np.int32),
             "label": (rng.random(b) > 0.5).astype(np.float32)}
    jg = jax.grad(lambda p: jm.loss(p, {k: jnp.asarray(v)
                                        for k, v in batch.items()})[0])(params)
    want = dlrm_params_from_numpy(jax.tree.map(np.asarray, jg), "cpu")
    loss, _ = tm.loss({k: torch.from_numpy(v) for k, v in batch.items()})
    loss.backward()
    got = {k: p.grad for k, p in tm.named_parameters()}
    worst = max(float((got[k] - want[k]).abs().max()) for k in want)
    print(f"gradients with out-of-range ids: worst abs error {worst:.3e} "
          f"(rtol={GRAD_RTOL}, atol={GRAD_ATOL})")
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   rtol=GRAD_RTOL, atol=GRAD_ATOL, err_msg=k)
    # row 0 is read only by the two ids below -rows (clamped up to it):
    # it takes no gradient.  The last row takes id -1's and not those of
    # rows and 5 * rows (clamped down to it).
    assert float(got["tables"][:, 0].abs().max()) == 0.0
    assert float(got["tables"][:, rows - 1].abs().max()) > 0.0
    with torch.no_grad():
        clamped = tm(torch.from_numpy(batch["dense"]),
                     torch.from_numpy(batch["sparse"]))
    np.testing.assert_allclose(
        clamped.numpy(), np.asarray(jm.forward(
            params, jnp.asarray(batch["dense"]),
            jnp.asarray(batch["sparse"]))), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("n", [1, 2])
def test_secure_tile_transform_lands_one_score_per_packet(n):
    """The tile transform's ``dpi_score`` has one row per packet, which
    the landing zone places at the packet's row; a short final tile
    lands only its own packets."""
    cfg = tcfg.smoke_config()
    rk = ops.expand_key(KEY)
    tdpi = dpi_params_from_numpy(load_dpi_params_seed0(), "cpu")
    raw = syn.encode_dlrm_packets(_records(cfg, 0))[:n * MTU]
    ct = ops.aes_ecb(torch.from_numpy(raw.reshape(-1, 16).copy()), rk)
    tile = ct.reshape(n, MTU)
    pt, score = fused_decrypt_dpi_tile(tile, rk, tdpi, tile_pkts=2)
    np.testing.assert_array_equal(pt.numpy().reshape(-1), raw)
    assert score.shape == (n,)
    zone = ting.DeviceLandingZone({"dpi_score": ((4,), torch.float32)},
                                  device="cpu")
    zone.place("dpi_score", score, 4 - n)
    np.testing.assert_array_equal(zone.arrays()["dpi_score"][4 - n:].numpy(),
                                  score.numpy())
