"""Data-parallel DLRM training over the port's allreduce against the JAX
reference, on the CPU.

* ``ravel_params`` is ``jax.flatten_util.ravel_pytree`` of the
  reference's parameter tree, element for element (dict keys sorted as
  strings: ``t10`` before ``t2``, ``l10`` before ``l2``), and
  ``unravel_params`` inverts it.
* Each worker's raveled gradient (torch autograd on ``DLRM.loss``) is
  ``jax.grad`` of the reference's ``model.loss`` within rtol = 1e-5,
  atol = 1e-6 (the DLRM's tolerance: float32 products summed in another
  order), for all 4 shards; the worst error is printed.
* ``repro_torch.examples.allreduce_dlrm.main`` on the CPU: every sum
  bit-identical to ``allreduce_oracle`` and the parameters bit-identical
  to the oracle fold (the example asserts both), and after 2 steps
  within rtol = 1e-5, atol = 1e-6 of the reference example's 2 steps,
  run in-process through ``repro`` from the same initial weights.
* One averaged update at the full DLRM's widths, cut to 2 tables of
  100,000 x 64 rows and to 26 tables of 1,000 rows, matches the
  reference example's update from the same weights within the same
  tolerance (``ravel_params``, ``unravel_params`` and ``sgd_apply`` at
  the full table size).
* ``CollectiveGroup.allreduce_bucketed`` in fused epochs (3 buckets, the
  last one ragged) is ``allreduce_oracle`` of the whole vector, bit for
  bit, with no refusal and no abort.
"""
import importlib.util
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from repro.configs import dlrm as jcfg
from repro.models.dlrm import DLRM as JDLRM
from repro_torch.common.config import DLRMConfig
from repro_torch.configs import dlrm as tcfg
from repro_torch.core import fused
from repro_torch.core.collectives import allreduce_oracle, make_ring_group
from repro_torch.examples import allreduce_dlrm as ex
from repro_torch.models.dlrm import (DLRM, dlrm_params_from_numpy,
                                     ravel_params, unravel_params)

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
RTOL, ATOL = 1e-5, 1e-6

# (reference config, port config): the smoke DLRM (26 tables: t10 < t2),
# a tiny one, and one with 11 bottom layers (l10 < l2)
CONFIGS = {
    "smoke": (jcfg.smoke_config(), tcfg.smoke_config()),
    "tiny": tuple(c(n_sparse=3, embed_rows=7, embed_dim=4,
                    bottom_mlp=(5, 4), top_mlp=(3, 1), modulus=7)
                  for c in (jcfg.smoke_config().__class__, DLRMConfig)),
    "deep": tuple(c(n_sparse=12, embed_rows=5, embed_dim=2,
                    bottom_mlp=(3,) * 10 + (2,), top_mlp=(2,) * 10 + (1,),
                    modulus=5)
                  for c in (jcfg.smoke_config().__class__, DLRMConfig)),
}


def _carried(jc, tc, seed=0):
    jm = JDLRM(jc)
    params = jax.tree.map(np.asarray, jm.init_params(jax.random.key(seed)))
    tm = DLRM(tc, device="cpu")
    tm.load_state_dict(dlrm_params_from_numpy(params, "cpu"))
    return jm, params, tm


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_ravel_is_ravel_pytree(name):
    jc, tc = CONFIGS[name]
    _, params, tm = _carried(jc, tc)
    want, _ = ravel_pytree(params)
    got = ravel_params(tm)
    assert got.dtype == torch.float32 and not got.requires_grad
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  np.asarray(want).view(np.uint32))
    back = unravel_params(tm, got)
    assert sorted(back) == sorted(tm.state_dict())
    for k, v in tm.state_dict().items():
        assert torch.equal(back[k], v), k
    # a fresh model loaded from the unraveled vector ravels back the same
    tm2 = DLRM(tc, seed=1, device="cpu")
    tm2.load_state_dict(back)
    assert torch.equal(ravel_params(tm2), got)


def test_unravel_rejects_a_wrong_length():
    tm = DLRM(CONFIGS["tiny"][1], device="cpu")
    with pytest.raises(ValueError):
        unravel_params(tm, torch.zeros(ravel_params(tm).numel() + 1))


def test_worker_gradients_match_jax_grad():
    jc, tc = CONFIGS["smoke"]
    jm, params, tm = _carried(jc, tc)
    grad_fn = jax.jit(jax.grad(lambda p, b: jm.loss(p, b)[0]))
    worst = 0.0
    for r in range(ex.WORLD):
        batch = ex.worker_batch(tc, r, "cpu")
        got = ex.worker_grad(tm, batch)
        want = np.asarray(ravel_pytree(grad_fn(
            params, {k: jax.numpy.asarray(v.numpy())
                     for k, v in batch.items()}))[0])
        assert got.dtype == np.float32 and got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
        worst = max(worst, float(np.max(np.abs(got - want))))
    print(f"worst |grad port - grad jax| over {ex.WORLD} shards: {worst:.3e}")


def _reference_example(steps: int):
    """examples/allreduce_dlrm.py's main, run for ``steps`` steps; returns
    its initial and final parameter trees (recorded at its ravel_pytree
    calls: the first call ravels the initial tree, the next to last the
    trained one)."""
    spec = importlib.util.spec_from_file_location(
        "reference_allreduce_dlrm", ROOT / "examples" / "allreduce_dlrm.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.STEPS = steps
    seen = []
    real = mod.ravel_pytree

    def recording(tree):
        seen.append(tree)
        return real(tree)
    mod.ravel_pytree = recording
    mod.main()
    return seen[0], seen[-2]


def test_main_on_cpu_matches_the_reference_example():
    steps = 2
    init, want = _reference_example(steps)
    out = ex.main(device="cpu", steps=steps,
                  params=jax.tree.map(np.asarray, init))
    assert len(out["losses"]) == steps
    assert out["losses"][-1] < out["losses"][0]
    assert out["absorbed"] > 0 and out["ticks"] > 0
    want_flat = np.asarray(ravel_pytree(want)[0])
    assert out["flat"].shape == want_flat.shape
    np.testing.assert_allclose(out["flat"], want_flat, rtol=RTOL, atol=ATOL)
    print(f"worst |params port - params reference| after {steps} steps: "
          f"{float(np.max(np.abs(out['flat'] - want_flat))):.3e}")


# the full config() cut in one dimension each: every table at its full
# 100,000 x 64 rows with 2 of the 26 tables, and all 26 tables (351
# interaction pairs) with 1,000 rows each; the MLPs at full width
FULL_CUTS = {
    "full_rows": dict(n_sparse=2),
    "full_tables": dict(embed_rows=1000, modulus=1000),
}


@pytest.mark.parametrize("cut", sorted(FULL_CUTS))
def test_full_width_update_matches_reference(cut):
    """One averaged update at the full DLRM's widths (cut as
    ``FULL_CUTS`` says): the 4 workers' raveled gradients, the oracle's
    sum, ``sgd_apply`` through ``unravel_params`` against the
    reference example's update (``p - LR * unravel(sum / WORLD)``) from
    the same initial weights, within rtol = 1e-5, atol = 1e-6; the mean
    loss before and after the step in both packages is printed."""
    from repro.core.collectives import allreduce_oracle as jallreduce_oracle
    jc = jcfg.config().__class__(**FULL_CUTS[cut])
    tc = DLRMConfig(**FULL_CUTS[cut])
    jm, params, tm = _carried(jc, tc)
    jp = jax.tree.map(jax.numpy.asarray, params)
    grad_fn = jax.jit(jax.grad(lambda p, b: jm.loss(p, b)[0]))
    loss_fn = jax.jit(lambda p, b: jm.loss(p, b)[0])
    batches = [ex.worker_batch(tc, r, "cpu") for r in range(ex.WORLD)]
    jbatches = [{k: jax.numpy.asarray(v.numpy()) for k, v in b.items()}
                for b in batches]

    def losses():
        with torch.no_grad():
            t = float(np.mean([tm.loss(b)[0].item() for b in batches]))
        return t, float(np.mean([loss_fn(jp, b) for b in jbatches]))

    before = losses()
    flats = [ex.worker_grad(tm, b) for b in batches]
    jflats = [np.asarray(ravel_pytree(grad_fn(jp, b))[0]) for b in jbatches]
    ex.sgd_apply(tm, allreduce_oracle(flats), ex.WORLD)
    _, unravel = ravel_pytree(jp)
    jp = jax.tree.map(lambda p, g: p - ex.LR * g, jp, unravel(
        jax.numpy.asarray(jallreduce_oracle(jflats)) / ex.WORLD))
    got, want = ravel_params(tm).numpy(), np.asarray(ravel_pytree(jp)[0])
    after = losses()
    print(f"{cut}: {got.size} parameters, worst |params port - params "
          f"reference| after the update "
          f"{float(np.max(np.abs(got - want))):.3e}; mean loss "
          f"{before[0]:.4f} -> {after[0]:.4f} (port), "
          f"{before[1]:.4f} -> {after[1]:.4f} (reference)")
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(after[0], after[1], rtol=RTOL, atol=ATOL)


def test_bucketed_fused_ring_is_the_whole_oracle():
    rng = np.random.default_rng(23)
    n = 1003                  # ring chunk 251: buckets of 100, 100, 51
    xs = [rng.standard_normal(n).astype(np.float32) for _ in range(4)]
    g = make_ring_group(4, 400 * 4 + 16, epoch_mode="fused", device="cpu")
    fused.STATS.reset()
    out = g.allreduce_bucketed(xs, 400)
    want = allreduce_oracle(xs)
    for r, o in enumerate(out):
        assert o.shape == (n,)
        assert (o.view(np.uint32) == want.view(np.uint32)).all(), r
    st = fused.STATS.snapshot()
    assert st["refusals"] == 0 and st["aborts"] == 0
    assert st["epochs"] == 3 * 6          # 3 ring steps a phase, 2 phases
    assert g.stats.transfers == 3 * 6


def test_bucketed_ring_takes_a_tensor_its_buffers_cannot():
    g = make_ring_group(4, 64 * 4 + 16, device="cpu")
    xs = [np.full((10, 30), r + 1, np.float32) for r in range(4)]
    with pytest.raises(ValueError):
        g.allreduce(xs)
    out = g.allreduce_bucketed(xs, 64)
    for o in out:
        assert o.shape == (10, 30) and (o == 10).all()
    with pytest.raises(ValueError):
        g.allreduce_bucketed(xs, 30)         # not a multiple of the world
