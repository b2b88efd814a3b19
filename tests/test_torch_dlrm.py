"""The port's DLRM against the JAX reference, on the CPU, and the slice
end to end: records streamed through the ingest, landed and scored.

The reference's parameters (``repro.models.dlrm.DLRM.init_params``) are
carried across with ``dlrm_params_from_numpy``; forward pass and loss
must agree within rtol = 1e-5, atol = 1e-6 (float32 products summed in
another order), with the worst error printed.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import dlrm as jcfg
from repro.core import ingest as jing
from repro.data import synthetic as jsyn
from repro.models.dlrm import DLRM as JDLRM
from repro_torch.configs import dlrm as tcfg
from repro_torch.core import ingest as ting
from repro_torch.data import synthetic as syn
from repro_torch.models.dlrm import DLRM, dlrm_params_from_numpy

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-6
MTU = 4096


def _models(cfg, seed=0):
    jm = JDLRM(cfg)
    params = jm.init_params(jax.random.key(seed))
    tm = DLRM(tcfg.smoke_config() if cfg == jcfg.smoke_config() else cfg,
              device="cpu")
    tm.load_state_dict(dlrm_params_from_numpy(
        jax.tree.map(np.asarray, params), "cpu"))
    return jm, params, tm


def _batch(cfg, b, seed, sparse_hi=None, sparse_lo=0):
    rng = np.random.default_rng(seed)
    dense = np.log1p(rng.integers(0, 100_000, (b, cfg.n_dense))
                     ).astype(np.float32)
    sparse = rng.integers(sparse_lo, sparse_hi or cfg.embed_rows,
                          (b, cfg.n_sparse)).astype(np.int32)
    label = (rng.random(b) > 0.5).astype(np.float32)
    return {"dense": dense, "sparse": sparse, "label": label}


def _compare(jm, params, tm, batch, what):
    jl = np.asarray(jm.forward(params, jnp.asarray(batch["dense"]),
                               jnp.asarray(batch["sparse"])))
    tb = {k: torch.from_numpy(v.copy()) for k, v in batch.items()}
    with torch.no_grad():
        tl = tm(tb["dense"], tb["sparse"]).numpy()
        tloss, tmet = tm.loss(tb)
    jloss, jmet = jm.loss(params, {k: jnp.asarray(v)
                                   for k, v in batch.items()})
    print(f"{what}: logits worst abs {np.abs(tl - jl).max():.3e}, loss "
          f"{float(tloss):.7f} vs {float(jloss):.7f}")
    np.testing.assert_allclose(tl, jl, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=RTOL,
                               atol=ATOL)
    assert float(tmet["acc"]) == pytest.approx(float(jmet["acc"]), abs=1e-6)


def test_configs_are_the_references():
    assert dataclasses.asdict(tcfg.config()) == \
        dataclasses.asdict(jcfg.config())
    assert dataclasses.asdict(tcfg.smoke_config()) == \
        dataclasses.asdict(jcfg.smoke_config())


@pytest.mark.parametrize("b,seed", [(1, 0), (64, 1), (300, 2)])
def test_forward_and_loss_match_reference(b, seed):
    cfg = jcfg.smoke_config()
    jm, params, tm = _models(cfg, seed)
    _compare(jm, params, tm, _batch(cfg, b, seed), f"B={b}")


def test_gather_clamps_like_the_reference():
    """Ids past the table (modulus > embed_rows) clamp to the last row,
    negative ids count from the end: the reference's gather semantics
    (torch's own indexing would raise)."""
    cfg = jcfg.smoke_config()
    jm, params, tm = _models(cfg, 3)
    batch = _batch(cfg, 50, 4, sparse_lo=-3 * cfg.embed_rows,
                   sparse_hi=5 * cfg.embed_rows)
    assert (batch["sparse"] >= cfg.embed_rows).any()
    assert (batch["sparse"] < -cfg.embed_rows).any()
    _compare(jm, params, tm, batch, "clamped ids")


def test_own_init_follows_the_reference_scheme():
    cfg = tcfg.smoke_config()
    m = DLRM(cfg, seed=5, device="cpu")
    sd = m.state_dict()
    assert set(sd) == set(dlrm_params_from_numpy(jax.tree.map(
        np.asarray, JDLRM(jcfg.smoke_config()).init_params(
            jax.random.key(0))), "cpu"))
    assert sd["tables"].shape == (cfg.n_sparse, cfg.embed_rows,
                                  cfg.embed_dim)
    assert abs(float(sd["tables"].std()) - 0.02) < 0.002
    w0 = sd["bottom_w.0"]
    assert abs(float(w0.std()) * np.sqrt(cfg.n_dense) - 1.0) < 0.1
    assert all(float(v.abs().max()) == 0.0 for k, v in sd.items()
               if "_b." in k)
    n_params = sum(p.numel() for p in m.parameters())
    jn = sum(a.size for a in jax.tree.leaves(JDLRM(jcfg.smoke_config())
                                             .init_params(jax.random.key(0))))
    assert n_params == jn
    again = DLRM(cfg, seed=5, device="cpu").state_dict()
    assert all(torch.equal(sd[k], again[k]) for k in sd)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            DLRM(cfg)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            dlrm_params_from_numpy({"tables": {}, "bottom": {}, "top": {}})


def test_slice_end_to_end_matches_reference():
    """The slice as a user drives it: shard 2 streams from 2 replicas x 2
    QPs, each tile preprocessed as it lands, and the landed batch is
    scored by the DLRM — in both packages, from the same records and the
    same weights.  Reports equal; losses agree."""
    cfg = jcfg.smoke_config()
    rpp = (MTU // 4) // (cfg.n_dense + cfg.n_sparse)
    n_pkts, index = 8, 2

    def shard_fn(i):
        return jsyn.encode_dlrm_packets(
            jsyn.dlrm_shard(i, rpp * n_pkts, cfg.n_dense, cfg.n_sparse))

    kw = dict(batch_bytes=n_pkts * MTU, n_storage_nodes=2, qps_per_node=2,
              tile_pkts=2, link_bw_pkts_per_tick=1)
    j = jing.BalboaIngest(
        jing.IngestConfig(**kw), None, shard_fn,
        tile_to_batch=jing.make_dlrm_tile_decoder(cfg.n_dense, cfg.n_sparse,
                                                  cfg.modulus))
    t = ting.BalboaIngest(
        ting.IngestConfig(**kw), None, shard_fn,
        tile_to_batch=ting.make_dlrm_tile_decoder(cfg.n_dense, cfg.n_sparse,
                                                  cfg.modulus),
        device="cpu")
    (jb, jrep), = j.stream_batches(1, start=index)
    (tb, trep), = t.stream_batches(1, start=index)
    assert (trep.ticks, trep.tiles, trep.events) == \
        (jrep.ticks, jrep.tiles, jrep.events)
    raw = syn.dlrm_shard(index, rpp * n_pkts, cfg.n_dense, cfg.n_sparse)
    label = syn.dlrm_labels(raw, cfg.n_dense, cfg.modulus)
    np.testing.assert_array_equal(label, jsyn.dlrm_labels(
        raw, cfg.n_dense, cfg.modulus))
    np.testing.assert_allclose(tb["dense"].numpy(),
                               np.log1p(np.maximum(raw[:, :cfg.n_dense], 0)),
                               rtol=1e-5)
    jm, params, tm = _models(cfg, 7)
    jloss, _ = jm.loss(params, {"dense": jb["dense"], "sparse": jb["sparse"],
                                "label": jnp.asarray(label)})
    with torch.no_grad():
        tloss, tmet = tm.loss({**tb, "label": torch.from_numpy(label)})
    print(f"slice: loss {float(tloss):.7f} (port) vs {float(jloss):.7f} "
          f"(reference), accuracy {float(tmet['acc']):.3f}")
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=RTOL,
                               atol=ATOL)
    assert t.host_payload_bytes == 0
