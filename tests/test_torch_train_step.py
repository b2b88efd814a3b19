"""The port's train step (``make_train_step``) against the reference's,
on the CPU, and remat.

From the reference's weights (``lm_params_from_numpy``) and optimizer
state (``opt_state_from_numpy``) and numpy-seeded batches, at float32
compute, remat on (the configs' own): the reference's step, jitted,
runs steps 0 and 1; the port runs step 0 from the same initial state,
and step 1 from the reference's state after step 0 (count 1, the
learning rate past its first value).  Cases:

* granite-3-2b — AdamW
* granite-3-2b with ``pod_grad_compression="bf16"``
* deepseek-v3-671b — Adafactor, MoE, MTP, the aux-loss-free gate bias
* qwen2-vl-72b — Adafactor, ``microbatches=2`` (``mrope_pos`` (3, B, S)
  sliced on dim 1)

Tolerances (each test prints the worst error it saw): the metrics
``loss``, ``xent`` and ``aux`` within ``LOSS_ATOL``, ``grad_norm``
within ``GNORM_RTOL`` relative, ``lr`` within 1 ulp; each new
parameter within ``ELEM_LR`` x lr of the reference's (Adam's update is
about lr * sign(g) early on, and a gradient within float order of 0 can
take the other sign in the two packages), and every leaf's error norm
within ``NORM_RTOL`` of its update's norm (the reference's new minus
old parameters); the optimizer slots within ``SLOT_RTOL`` of their
leaf's largest magnitude, ``SLOT_RTOL_BF16`` with bf16 compression (a
bf16 rounding may go the other way).

Remat: gradients with ``remat=False``, ``remat=True`` and
``remat_policy="dots"`` are equal (recomputation gives the same
values), on a decoder-only arch and on whisper-base's encoder.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _train_diff as D
from _lm_batches import lm_batch
from repro.common.config import TrainConfig as JTrainConfig
from repro.configs import get_smoke_config as jget
from repro.models import params as JP
from repro.models.model import Model as JModel
from repro.train.step import make_train_step as j_make_train_step
from repro_torch.common.config import TrainConfig
from repro_torch.configs import get_smoke_config as tget
from repro_torch.models import params as P
from repro_torch.models.model import Model, lm_params_from_numpy
from repro_torch.train.step import make_train_step

torch.set_num_threads(1)

LOSS_ATOL = 1e-5
GNORM_RTOL = 1e-5
ELEM_LR = 2.5
NORM_RTOL = 2e-3
SLOT_RTOL = 1e-4
# with bf16 compression, a gradient within float order of a bf16
# rounding boundary rounds to the other neighbour in the two packages:
# one bf16 ulp, 2^-8 of it (2^-7 of its square in v)
SLOT_RTOL_BF16 = 2 ** -7
B, S = 4, 16
LR = 1e-3

CASES = {
    "granite-3-2b": ("granite-3-2b", {}),
    "granite-3-2b-bf16": ("granite-3-2b", {"pod_grad_compression": "bf16"}),
    "deepseek-v3-671b": ("deepseek-v3-671b", {}),
    "qwen2-vl-72b-mb2": ("qwen2-vl-72b", {"microbatches": 2}),
}


def _tc(cls, kw):
    return cls(steps=10, learning_rate=LR, warmup_steps=0, **kw)


def _reference(arch, kw):
    cfg = jget(arch).replace(compute_dtype="float32")
    assert cfg.remat
    m = JModel(cfg)
    step, opt = j_make_train_step(m, _tc(JTrainConfig, kw))
    params = m.init_params(jax.random.key(0))
    state = JP.init(opt.state_spec(m.param_spec()), jax.random.key(1),
                    "float32")
    batches = [lm_batch(cfg, B, S, seed=s) for s in (1, 2)]
    jstep = jax.jit(step)
    host = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    out = {"params": [host(params)], "state": [host(state)],
           "metrics": [], "batches": batches}
    for i, b in enumerate(batches):
        params, state, met = jstep(params, state, {
            k: jnp.asarray(v) for k, v in b.items()}, jnp.int32(i))
        out["params"].append(host(params))
        out["state"].append(host(state))
        out["metrics"].append({k: float(v) for k, v in met.items()})
    return out


@pytest.fixture(scope="module", params=list(CASES))
def case(request):
    arch, kw = CASES[request.param]
    return request.param, arch, kw, _reference(arch, kw)


@pytest.mark.parametrize("which", [0, 1])
def test_train_step_matches_reference(case, which):
    name, arch, kw, ref = case
    cfg = tget(arch).replace(compute_dtype="float32")
    m = Model(cfg, device="cpu")
    m.load_state_dict(lm_params_from_numpy(ref["params"][which], cfg, "cpu"))
    state = P.opt_state_from_numpy(ref["state"][which], cfg, "cpu")
    step, _ = make_train_step(m, _tc(TrainConfig, kw))
    batch = {k: torch.from_numpy(v.copy())
             for k, v in ref["batches"][which].items()}
    state, met = step(state, batch, which)

    want = ref["metrics"][which]
    assert sorted(met) == sorted(want) == ["aux", "grad_norm", "loss", "lr",
                                           "xent"]
    got = {k: float(v) for k, v in met.items()}
    m_err = {k: abs(got[k] - want[k]) for k in ("loss", "xent", "aux")}
    g_err = abs(got["grad_norm"] - want["grad_norm"]) / want["grad_norm"]
    lr_ulps = float(D.ulps(got["lr"], want["lr"]))

    old = D.ref_items(ref["params"][which])
    new = D.ref_items(ref["params"][which + 1])
    mine = D.groups_of(m)
    assert list(mine) == list(new)
    lr = want["lr"]
    elem = {k: float(np.max(np.abs(mine[k] - new[k]))) / lr for k in new}
    norm = {}
    for k in new:
        step_norm = float(np.linalg.norm(new[k] - old[k]))
        err = float(np.linalg.norm(mine[k] - new[k]))
        norm[k] = err / step_norm if step_norm > 0 else err
    want_s = D.ref_items(ref["state"][which + 1]["slots"])
    got_s = D.port_items(state["slots"])
    assert list(got_s) == list(want_s)
    slot = {k: float(np.max(np.abs(got_s[k] - want_s[k])))
            / max(float(np.max(np.abs(want_s[k]))), 1e-30) for k in want_s}
    assert int(state["count"]) == which + 1
    we, wn, ws = (max(d, key=d.get) for d in (elem, norm, slot))
    print(f"{name} step {which}: loss {got['loss']:.6f} (ref "
          f"{want['loss']:.6f}); metric errs {m_err}, grad_norm rel "
          f"{g_err:.2e}, lr {lr_ulps:.0f} ulps; params: worst elem "
          f"{elem[we]:.3f} x lr ({we}), worst norm-rel {norm[wn]:.2e} "
          f"({wn}); slots worst rel {slot[ws]:.2e} ({ws})")
    assert max(m_err.values()) < LOSS_ATOL
    assert g_err < GNORM_RTOL
    assert lr_ulps <= 1
    assert elem[we] < ELEM_LR
    assert norm[wn] < NORM_RTOL
    assert slot[ws] < (SLOT_RTOL_BF16 if kw.get("pod_grad_compression")
                       else SLOT_RTOL)


# ---------------------------------------------------------------------------
# remat changes memory, never numbers
# ---------------------------------------------------------------------------

def _grads(cfg, batch):
    m = Model(cfg, device="cpu").init_params(0)
    loss, _ = m.loss(batch)
    loss.backward()
    return loss.item(), {n: p.grad.clone() for n, p in m.named_parameters()
                         if p.grad is not None}


@pytest.mark.parametrize("arch", ["gemma2-2b", "deepseek-v3-671b",
                                  "whisper-base"])
def test_remat_keeps_gradients(arch):
    base = tget(arch).replace(compute_dtype="float32")
    batch = {k: torch.from_numpy(v)
             for k, v in lm_batch(base, 2, 16, seed=3).items()}
    runs = {name: _grads(base.replace(**kw), batch) for name, kw in (
        ("off", {"remat": False}), ("nothing", {"remat": True}),
        ("dots", {"remat": True, "remat_policy": "dots"}))}
    loss0, g0 = runs["off"]
    assert len(g0) > 0
    for name in ("nothing", "dots"):
        loss, g = runs[name]
        assert sorted(g) == sorted(g0)
        worst = max(float((g[k] - g0[k]).abs().max()) for k in g0)
        print(f"{arch} remat {name}: loss {loss:.6f} (off {loss0:.6f}), "
              f"{len(g)} gradients, max abs diff {worst:.1e}")
        assert loss == loss0
        for k in g0:
            assert torch.equal(g[k], g0[k]), (name, k)


def test_remat_recomputes_in_the_backward_pass():
    """With remat on, the block's forward runs again in the backward
    pass (twice in all); with "dots" its 2-D matmuls are kept, and
    attention's batched products run again."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.n = {}

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.n[func] = self.n.get(func, 0) + 1
            return func(*args, **(kwargs or {}))

    base = tget("granite-3-2b").replace(compute_dtype="float32")
    batch = {k: torch.from_numpy(v)
             for k, v in lm_batch(base, 2, 16, seed=3).items()}
    counts = {}
    for name, kw in (("off", {"remat": False}), ("nothing", {"remat": True}),
                     ("dots", {"remat": True, "remat_policy": "dots"})):
        m = Model(base.replace(**kw), device="cpu").init_params(0)
        loss, _ = m.loss(batch)
        with Count() as c:
            loss.backward()
        counts[name] = c.n
    mm = torch.ops.aten.mm.default
    bmm = torch.ops.aten.bmm.default
    print({k: (v.get(mm, 0), v.get(bmm, 0)) for k, v in counts.items()})
    # the backward pass's products: 2 a forward product; recomputation adds
    # the forward's own
    assert counts["nothing"][mm] > counts["off"][mm]
    assert counts["dots"][mm] == counts["off"][mm]
    assert counts["dots"].get(bmm, 0) > counts["off"].get(bmm, 0)
