"""The port's optimizers against the reference's, on the CPU.

Units: ``cosine_schedule`` (warmup 0, 1 and 20, steps 0..total+5),
``global_norm`` and ``clip_by_global_norm`` over a tree with a stacked
leaf, ``compress_grads_bf16``, ``topk_error_feedback`` (ties at the
threshold kept), ``_update_gate_bias`` and both optimizers'
``state_spec`` trees (shapes, axes and leaf order, every arch).  Then
one optimizer update from the same parameters (the reference's
``init_params``, carried with ``lm_params_from_numpy``), numpy-seeded
gradients and the same state (``opt_state_from_numpy``): AdamW on
granite-3-2b and Adafactor on deepseek-v3-671b, whose stacked norm
scales are factored with a ``v_col`` shared across the layers; first
from the zero state, then a second update from the reference's state
after the first (count 1).

Tolerances (each test prints the worst error it saw): the schedule
within ``ULPS`` float32 units in the last place of the peak learning
rate (``1 + cos(pi t)`` cancels near the end, where the two libraries'
cosines, an ulp apart, differ by many ulps of the result); the norm
within ``ULPS`` ulps, the clipped leaves likewise — the same float32
ops in the same order, but XLA's reductions sum in another order; the
updated parameters and slots within ``UPDATE_ULPS`` ulps of the larger
of the reference's value before and after the update (the reasons at
``UPDATE_ULPS``); the bf16 cast, top-k and the gate bias bit-exact.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _train_diff as D
from repro.configs import ALL_ARCHS
from repro.configs import get_smoke_config as jget
from repro.models import params as JP
from repro.models.model import Model as JModel
from repro.optim import optimizers as jo
from repro.train.step import _update_gate_bias as j_update_gate_bias
from repro_torch.configs import get_smoke_config as tget
from repro_torch.models import params as P
from repro_torch.models.model import (Model, lm_params_from_numpy,
                                      param_spec)
from repro_torch.optim import optimizers as to
from repro_torch.train.step import _update_gate_bias

torch.set_num_threads(1)

ULPS = 8
# one update, per element, in ulps of the larger of the value before and
# after it (p - lr * u and b1 * m + (1 - b1) * g may cancel): AdamW is
# elementwise, but XLA may contract a product and a sum into one
# rounding, and a first moment that cancels passes its error on to the
# update; Adafactor divides by means of g^2 over the rows, the columns
# and the whole leaf, each summed by XLA in another order
UPDATE_ULPS = {"adamw": 16, "adafactor": 32}
LR = 1e-3


@pytest.mark.parametrize("warmup", [0, 1, 20])
def test_cosine_schedule(warmup):
    total = 100
    steps = np.arange(total + 6)
    want = np.asarray(jax.vmap(jo.cosine_schedule(3e-4, warmup, total))(
        jnp.asarray(steps)))
    fn = to.cosine_schedule(3e-4, warmup, total)
    got = np.array([float(fn(int(s))) for s in steps], np.float32)
    assert fn(0).dtype == torch.float32
    # in ulps of the peak: 1 + cos(pi t) cancels near t = 1, where an ulp
    # of cos between the two libraries is many ulps of the result
    err = np.abs(got - want) / np.spacing(np.float32(3e-4))
    print(f"warmup {warmup}: lr at steps 0..{total + 5} within "
          f"{err.max():.0f} ulps of the peak lr of the reference's "
          f"({int((got != want).sum())} of {len(steps)} steps differ)")
    assert err.max() <= ULPS
    if warmup:
        assert got[0] == 0.0


def _tree(seed):
    """A stacked (L=3) leaf, a matrix, a vector, a bf16 leaf."""
    rng = np.random.default_rng(seed)
    return {"blocks": rng.standard_normal((3, 5, 7)).astype(np.float32),
            "emb": rng.standard_normal((11, 4)).astype(np.float32),
            "norm": rng.standard_normal((6,)).astype(np.float32),
            "z": rng.standard_normal((9,)).astype(np.float32)}


def _port_tree(t):
    out = {k: torch.from_numpy(v.copy()) for k, v in t.items()}
    out["blocks"] = list(out["blocks"].unbind(0))
    out["z"] = out["z"].to(torch.bfloat16)
    return out


def _jax_tree(t):
    out = {k: jnp.asarray(v) for k, v in t.items()}
    out["z"] = out["z"].astype(jnp.bfloat16)
    return out


@pytest.mark.parametrize("max_norm", [1.0, 100.0])
def test_global_norm_and_clip(max_norm):
    t = _tree(3)
    jclipped, jnorm = jax.jit(lambda x: jo.clip_by_global_norm(
        x, max_norm))(_jax_tree(t))
    assert float(jo.global_norm(_jax_tree(t))) == float(jnorm)
    norm0 = to.global_norm(_port_tree(t))
    clipped, norm = to.clip_by_global_norm(_port_tree(t), max_norm)
    assert float(norm0) == float(norm)
    n_err = float(D.ulps(float(norm), float(jnorm)))
    got = D.port_items(clipped)
    want = D.ref_items(jclipped)
    assert list(got) == list(want)
    assert clipped["z"].dtype == torch.bfloat16
    errs = {k: float(D.ulps(got[k], np.asarray(want[k], np.float32)).max())
            for k in want}
    print(f"max_norm {max_norm}: norm {float(norm):.6f} ({n_err:.0f} ulps);"
          f" clipped leaves' worst ulps {errs}")
    assert n_err <= ULPS
    assert max(errs.values()) <= ULPS


def test_compress_grads_bf16():
    t = _tree(4)
    got = D.port_items(to.compress_grads_bf16(_port_tree(t)))
    want = D.ref_items(jo.compress_grads_bf16(_jax_tree(t)))
    for k in want:
        np.testing.assert_array_equal(got[k], np.asarray(want[k],
                                                         np.float32))
    assert to.compress_grads_bf16(_port_tree(t))["blocks"][0].dtype \
        == torch.bfloat16


@pytest.mark.parametrize("fraction", [0.05, 0.3, 1.0])
def test_topk_error_feedback(fraction):
    t = _tree(5)
    r = {k: (v * 0.1).astype(np.float32) for k, v in _tree(6).items()
         if k != "z"}
    t.pop("z")
    # ties at the threshold, both signs (residual 0 there): emb keeps
    # k = 2 of 44 at fraction 0.05, and 8 entries tie at 5.0; blocks
    # keeps 5 of 105, and 7 tie at 9.0
    t["emb"][0], t["emb"][1], r["emb"][:2] = 5.0, -5.0, 0.0
    t["blocks"][1, 0], r["blocks"][1, 0] = 9.0, 0.0
    js, jr = jo.topk_error_feedback({k: jnp.asarray(v) for k, v in t.items()},
                                    {k: jnp.asarray(v) for k, v in r.items()},
                                    fraction)
    pt = _port_tree({**t, "z": np.zeros(1, np.float32)})
    pt.pop("z")
    pr = _port_tree({**r, "z": np.zeros(1, np.float32)})
    pr.pop("z")
    s, nr = to.topk_error_feedback(pt, pr, fraction)
    assert isinstance(s["blocks"], list) and len(s["blocks"]) == 3
    if fraction == 0.05:
        assert int((D.port_items(s)["emb"] != 0).sum()) == 8
        assert int((D.port_items(s)["blocks"] != 0).sum()) == 7
    kept = 0
    for k in t:
        np.testing.assert_array_equal(D.port_items(s)[k], np.asarray(js[k]))
        np.testing.assert_array_equal(D.port_items(nr)[k], np.asarray(jr[k]))
        kept += int((D.port_items(s)[k] != 0).sum())
    print(f"fraction {fraction}: {kept} entries kept, equal to the "
          f"reference's, residuals equal")


def test_update_gate_bias():
    cfg = jget("deepseek-v3-671b")
    params = JModel(cfg).init_params(jax.random.key(0))
    rng = np.random.default_rng(7)
    load = rng.random(cfg.n_experts).astype(np.float32)
    load[2] = load.mean()                  # sign 0 where load == mean
    want = jax.tree.map(np.asarray, j_update_gate_bias(
        params, jnp.asarray(load)))
    tcfg = tget("deepseek-v3-671b")
    m = Model(tcfg, device="cpu")
    m.load_state_dict(lm_params_from_numpy(
        jax.tree.map(np.asarray, params), tcfg, "cpu"))
    _update_gate_bias(m, torch.from_numpy(load))
    got = D.groups_of(m)
    want = D.ref_items(want)
    names = [k for k in want if k.endswith("gate_bias")]
    assert names
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    print(f"gate biases {names} equal to the reference's")


@pytest.mark.parametrize("opt", ["adamw", "adafactor"])
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_state_spec_matches_reference(arch, opt):
    jspec = jo.make_optimizer(opt).state_spec(JModel(jget(arch)).param_spec())
    tspec = to.make_optimizer(opt).state_spec(param_spec(tget(arch)))
    want = D.ref_items(jspec)
    got = dict(P.tree_items(tspec))
    assert list(got) == list(want)          # paths and leaf order
    for k, s in want.items():
        assert tuple(got[k]) == (s.shape, s.axes, s.init, s.dtype), k


# ---------------------------------------------------------------------------
# one update, the reference's against the port's
# ---------------------------------------------------------------------------

def _reference_updates(arch):
    """The reference's parameters, two gradients, and the states and
    parameters after one update from the zero state and one more."""
    cfg = jget(arch)
    opt = jo.make_optimizer(cfg.optimizer)
    m = JModel(cfg)
    params = m.init_params(jax.random.key(0))
    state = JP.init(opt.state_spec(m.param_spec()), jax.random.key(1),
                    "float32")
    flat, treedef = jax.tree.flatten(params)
    paths = list(D.ref_items(params))
    grads = []
    for seed in (11, 12):
        g = D.grads_like(D.ref_items(jax.tree.map(np.asarray, params)), seed)
        grads.append(jax.tree.unflatten(treedef, [jnp.asarray(g[p])
                                                  for p in paths]))
    upd = jax.jit(opt.update)
    lr = jnp.float32(LR)
    p1, s1 = upd(grads[0], state, params, lr)
    p2, s2 = upd(grads[1], s1, p1, lr)
    host = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    return {"params": [host(params), host(p1), host(p2)],
            "state": [host(state), host(s1), host(s2)],
            "grads": [D.ref_items(host(g)) for g in grads]}


@pytest.fixture(scope="module", params=[("granite-3-2b", "adamw"),
                                        ("deepseek-v3-671b", "adafactor")])
def updates(request):
    arch, opt = request.param
    assert jget(arch).optimizer == opt
    return arch, _reference_updates(arch)


@pytest.mark.parametrize("which", [0, 1])
def test_one_update_matches_reference(updates, which):
    """Update ``which`` (0: from the zero state; 1: from the state after
    the first, count 1), both from the reference's inputs."""
    arch, ref = updates
    cfg = tget(arch)
    opt = to.make_optimizer(cfg.optimizer)
    m = Model(cfg, device="cpu")
    m.load_state_dict(lm_params_from_numpy(ref["params"][which], cfg, "cpu"))
    state = P.opt_state_from_numpy(ref["state"][which], cfg, "cpu")
    groups = P.leaf_groups(m)
    grads = D.as_port_tree(ref["grads"][which], groups)
    with torch.no_grad():
        _, new = opt.update(grads, state, groups, torch.tensor(LR))
    assert int(new["count"]) == which + 1
    assert new["count"].dtype == torch.int32
    want_p = D.ref_items(ref["params"][which + 1])
    got_p = D.groups_of(m)
    want_s = D.ref_items(ref["state"][which + 1]["slots"])
    got_s = D.port_items(new["slots"])
    assert list(got_s) == list(want_s)
    old_p = D.ref_items(ref["params"][which])
    old_s = D.ref_items(ref["state"][which]["slots"])
    errs = {k: float(D.ulps(got_p[k], want_p[k], old_p[k]).max())
            for k in want_p}
    errs.update({f"slot {k}": float(D.ulps(got_s[k], want_s[k],
                                           old_s[k]).max())
                 for k in want_s})
    worst = max(errs, key=errs.get)
    stacked_norms = [k for k in want_s if k.startswith("decoder.blocks")
                     and k.endswith("scale.v_col")]
    print(f"{arch} {cfg.optimizer} update {which + 1}: {len(want_p)} "
          f"params, {len(want_s)} slots; worst {errs[worst]:.0f} ulps "
          f"({worst}); stacked norm v_col slots {stacked_norms[:2]}")
    if cfg.optimizer == "adafactor":
        # a stacked norm scale (L, d): v_col (d,) shared by the layers
        k = stacked_norms[0]
        assert want_s[k].ndim == 1
        assert want_s[k.replace("v_col", "v_row")].ndim == 1
    assert errs[worst] <= UPDATE_ULPS[cfg.optimizer]
