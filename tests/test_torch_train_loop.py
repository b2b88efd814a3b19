"""The port's checkpoints and Trainer, on the CPU: against the
reference's where the two meet, and the framework tests of
``tests/test_system.py`` in the port.

* Checkpoint interop, both ways, on granite-3-2b (AdamW) and
  deepseek-v3-671b (Adafactor, stacked norm scales): the reference's
  ``Checkpointer`` writes ``{"params", "opt"}`` and the port restores
  it leaf for leaf, bit-equal; the port writes (``params_to_numpy``, the
  optimizer state keyed by the reference's paths, and a bf16 leaf) and
  the reference restores it, bit-equal, the bf16 leaf kept bf16.
* Resume equality: the reference's ``Trainer`` runs ``K`` steps and
  checkpoints; from copies of that directory the reference and the port
  each resume and train to step ``N`` (float32 compute).  Per-step
  losses within ``LOSS_ATOL``; every leaf of the two step-``N``
  checkpoints compared: the parameters within ``ELEM_LR`` x lr
  a step of each other per element (Adam's update is about
  lr * sign(g), and a gradient within float order of 0 may take the
  other sign), the parameters' error norm within ``NORM_RTOL`` of the
  norm of their change since the resume, and the optimizer state within
  ``SLOT_RTOL`` of its leaf's largest magnitude.  Worst errors printed.
* ``test_system.py`` in the port: ``test_crash_resume_training``,
  ``test_training_reduces_loss``, ``test_checkpoint_roundtrip``,
  ``test_checkpoint_keeps_latest``, ``test_mtp_loss_present``; and for
  ``test_sharding_divisibility_fallback`` the reference's resolution and
  fallback on both packages' rule tables (the trainer on a mesh:
  ``tests/test_torch_mesh_train.py``).
"""
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _train_diff as D
from repro.checkpoint.checkpoint import Checkpointer as JCheckpointer
from repro.common.config import TrainConfig as JTrainConfig
from repro.configs import get_smoke_config as jget
from repro.models import params as JP
from repro.models.model import Model as JModel
from repro.optim import optimizers as jo
from repro.train.loop import Trainer as JTrainer
from repro.train.loop import lm_batch_iterator as j_batches
from repro_torch.checkpoint.checkpoint import Checkpointer
from repro_torch.common.config import TrainConfig
from repro_torch.configs import get_smoke_config
from repro_torch.models import params as P
from repro_torch.models.model import Model, lm_params_from_numpy, param_spec
from repro_torch.optim import optimizers as to
from repro_torch.parallel import sharding
from repro_torch.train.loop import Trainer, lm_batch_iterator

torch.set_num_threads(1)

K, N = 3, 6
LR = 1e-3
LOSS_ATOL = 2e-5
ELEM_LR = 2.5
NORM_RTOL = 5e-3
SLOT_RTOL = 1e-4


def _reference_state(arch, seed=0):
    """The reference's params and an optimizer state of random slots."""
    cfg = jget(arch)
    m = JModel(cfg)
    params = m.init_params(jax.random.key(seed))
    opt = jo.make_optimizer(cfg.optimizer)
    spec = opt.state_spec(m.param_spec())
    rng = np.random.default_rng(seed)
    leaves, treedef = jax.tree.flatten(spec, is_leaf=JP.is_spec)
    vals = [np.asarray(5, np.int32) if s.dtype == "int32"
            else rng.random(s.shape).astype(np.float32) for s in leaves]
    return cfg, {"params": params,
                 "opt": jax.tree.unflatten(treedef, [jnp.asarray(v)
                                                     for v in vals])}


def _port_like(cfg, device="cpu"):
    """What the port's Trainer restores into: ``meta`` stand-ins of the
    reference's parameter tree, and a zero optimizer state."""
    opt = to.make_optimizer(cfg.optimizer)
    spec = param_spec(cfg)
    return {"params": P.shapes(spec, cfg.param_dtype),
            "opt": P.init(opt.state_spec(spec), torch.Generator(), "float32",
                          device)}


@pytest.mark.parametrize("arch", ["granite-3-2b", "deepseek-v3-671b"])
def test_reference_checkpoint_restores_in_the_port(arch, tmp_path):
    cfg, state = _reference_state(arch)
    JCheckpointer(str(tmp_path)).save(4, state, blocking=True)
    tcfg = get_smoke_config(arch)
    step, got = Checkpointer(str(tmp_path)).restore(_port_like(tcfg))
    assert step == 4
    want = D.ref_items(jax.tree.map(np.asarray, state))
    mine = {k: np.asarray(v) for k, v in P.tree_items(got)}
    assert list(mine) == list(want)
    for k in want:
        np.testing.assert_array_equal(mine[k], want[k], err_msg=k)
    # and into a model and the port's optimizer state
    m = Model(tcfg, device="cpu")
    m.load_state_dict(P.params_from_numpy(got["params"], m.param_spec(),
                                          torch.device("cpu"),
                                          tcfg.param_dtype))
    for k, v in D.groups_of(m).items():
        np.testing.assert_array_equal(v, want["params." + k])
    assert got["opt"]["count"].dtype == torch.int32
    print(f"{arch}: {len(want)} leaves restored bit-equal in the port")


@pytest.mark.parametrize("arch", ["granite-3-2b", "deepseek-v3-671b"])
def test_port_checkpoint_restores_in_the_reference(arch, tmp_path):
    cfg, jstate = _reference_state(arch, seed=1)
    tcfg = get_smoke_config(arch)
    host = jax.tree.map(np.asarray, jstate)
    m = Model(tcfg, device="cpu")
    m.load_state_dict(lm_params_from_numpy(host["params"], tcfg, "cpu"))
    opt = P.opt_state_from_numpy(host["opt"], tcfg, "cpu")
    z = torch.linspace(-3, 3, 7).to(torch.bfloat16)
    Checkpointer(str(tmp_path)).save(
        9, {"params": P.params_to_numpy(m), "opt": opt, "z": z},
        blocking=True)
    like = {**jstate, "z": jnp.zeros(7, jnp.bfloat16)}
    step, got = JCheckpointer(str(tmp_path)).restore(like)
    assert step == 9
    assert got["z"].dtype == jnp.bfloat16
    np.testing.assert_array_equal(np.asarray(got["z"], np.float32),
                                  z.float().numpy())
    want = D.ref_items(host)
    mine = D.ref_items(jax.tree.map(np.asarray, got))
    for k in want:
        np.testing.assert_array_equal(mine[k], want[k], err_msg=k)
    print(f"{arch}: {len(want)} leaves and a bf16 leaf restored bit-equal "
          f"in the reference")


def _tc(cls, directory, steps):
    return cls(steps=steps, checkpoint_every=K, learning_rate=LR,
               warmup_steps=2, checkpoint_dir=str(directory), log_every=100)


def test_resume_from_reference_checkpoint_matches_reference(tmp_path):
    arch = "granite-3-2b"
    jcfg = jget(arch).replace(compute_dtype="float32")
    tcfg = get_smoke_config(arch).replace(compute_dtype="float32")
    base = tmp_path / "base"
    first = JTrainer(JModel(jcfg), _tc(JTrainConfig, base, K)).run(
        j_batches(jcfg, 4, 32))
    assert first.steps_run == K
    shutil.copytree(base, tmp_path / "ref")
    shutil.copytree(base, tmp_path / "port")
    ref = JTrainer(JModel(jcfg), _tc(JTrainConfig, tmp_path / "ref", N)).run(
        j_batches(jcfg, 4, 32))
    mine = Trainer(Model(tcfg, device="cpu"),
                   _tc(TrainConfig, tmp_path / "port", N)).run(
        lm_batch_iterator(tcfg, 4, 32))
    assert ref.resumed_from == mine.resumed_from == K
    assert ref.steps_run == mine.steps_run == N - K
    loss_err = max(abs(a - b) for a, b in zip(mine.losses, ref.losses))

    def leaves(d, step):
        with np.load(d / f"step_{step:08d}" / "arrays.npz") as z:
            return [z[f"leaf_{i}"] for i in range(len(z.files))]
    start = leaves(base, K)
    want = leaves(tmp_path / "ref", N)
    got = leaves(tmp_path / "port", N)
    paths = [k for k, _ in P.tree_items(_port_like(tcfg))]
    assert len(start) == len(want) == len(got) == len(paths)
    elem, norm, slot = {}, {}, {}
    for k, s, w, g in zip(paths, start, want, got):
        assert w.shape == g.shape and w.dtype == g.dtype, k
        if k.startswith("opt."):
            slot[k] = float(np.max(np.abs(g - w))) / max(
                float(np.max(np.abs(w))), 1e-30)
            continue
        elem[k] = float(np.max(np.abs(g - w))) / (LR * (N - K))
        moved = float(np.linalg.norm(w - s))
        norm[k] = float(np.linalg.norm(g - w)) / max(moved, 1e-30)
    we, wn, ws = (max(d, key=d.get) for d in (elem, norm, slot))
    print(f"resume at {K} to {N}: losses {mine.losses} (ref {ref.losses}), "
          f"max err {loss_err:.2e}; params: worst {elem[we]:.3f} x lr a "
          f"step ({we}), worst norm-rel {norm[wn]:.2e} ({wn}); optimizer "
          f"state: worst rel {slot[ws]:.2e} ({ws})")
    assert loss_err < LOSS_ATOL
    assert elem[we] < ELEM_LR
    assert norm[wn] < NORM_RTOL
    assert slot[ws] < SLOT_RTOL


# ---------------------------------------------------------------------------
# tests/test_system.py's framework tests, in the port
# ---------------------------------------------------------------------------

def test_crash_resume_training(tmp_path):
    cfg = get_smoke_config("granite-3-2b")
    tc = TrainConfig(steps=10, checkpoint_every=4, learning_rate=1e-3,
                     checkpoint_dir=str(tmp_path / "ck"), log_every=100)
    m = Model(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="injected failure"):
        Trainer(m, tc).run(lm_batch_iterator(cfg, 4, 32), crash_at=6)
    assert Checkpointer(tc.checkpoint_dir).all_steps() == [4]
    res = Trainer(m, tc).run(lm_batch_iterator(cfg, 4, 32))
    assert res.resumed_from == 4
    assert res.steps_run == 6          # 4..9
    assert np.isfinite(res.final_loss)


def test_training_reduces_loss(tmp_path):
    cfg = get_smoke_config("granite-3-2b")
    tc = TrainConfig(steps=30, checkpoint_every=1000, learning_rate=3e-3,
                     warmup_steps=5, checkpoint_dir=str(tmp_path / "ck2"),
                     log_every=1000)
    m = Model(cfg, device="cpu")
    res = Trainer(m, tc).run(lm_batch_iterator(cfg, 8, 64))
    first = np.mean(res.losses[:5])
    last = np.mean(res.losses[-5:])
    print(f"loss {first:.4f} -> {last:.4f} over 30 steps")
    assert last < first - 0.1, f"no learning: {first} -> {last}"


def test_checkpoint_roundtrip(tmp_path):
    ck = Checkpointer(str(tmp_path / "c"))
    state = {"a": torch.arange(10, dtype=torch.float32),
             "b": {"c": torch.ones((3, 4), dtype=torch.bfloat16)}}
    ck.save(7, state, blocking=True)
    step, got = ck.restore(state)
    assert step == 7
    np.testing.assert_array_equal(got["a"].numpy(), np.arange(10))
    assert got["b"]["c"].dtype == torch.bfloat16


def test_checkpoint_keeps_latest(tmp_path):
    ck = Checkpointer(str(tmp_path / "c"), keep=2)
    for s in (1, 2, 3, 4):
        ck.save(s, {"x": torch.tensor(s)}, blocking=True)
    assert ck.all_steps() == [3, 4]


def test_checkpoint_save_is_a_snapshot(tmp_path):
    """The host copy is taken when ``save`` is called: changing the
    state in place afterwards (the next step) does not reach the file."""
    ck = Checkpointer(str(tmp_path / "c"))
    x = torch.zeros(1000)
    ck.save(1, {"x": x})
    x.add_(1.0)
    ck.wait()
    assert float(ck.restore({"x": x})[1]["x"].sum()) == 0.0


def test_sharding_divisibility_fallback(tmp_path):
    """The reference's test, on the port's rule tables (both packages on
    a stand-in mesh: ``resolve_spec`` reads only the axis names and
    sizes), and an indivisible dim falls back to replication, logged as
    the reference logs it.  ``constrain`` moves nothing; the trainer
    takes a mesh (its data-parallel run: ``tests/
    test_torch_mesh_train.py``)."""
    from types import SimpleNamespace

    from repro.parallel import sharding as jsh
    one = SimpleNamespace(mesh_dim_names=("data", "model"), shape=(1, 1))
    spec = sharding.resolve_spec((8, 128), ("batch", "d_ff"), one,
                                 sharding.make_rules("train"), "t")
    assert spec == ("data", "model")
    mesh = SimpleNamespace(mesh_dim_names=("data", "model"), shape=(2, 4))
    jmesh = SimpleNamespace(axis_names=("data", "model"),
                            devices=SimpleNamespace(shape=(2, 4)))
    for mod, m in ((sharding, mesh), (jsh, jmesh)):
        mod.clear_fallback_log()
        got = mod.resolve_spec((7, 128), ("batch", "d_ff"), m,
                               mod.make_rules("train"), "t2")
        assert tuple(got) == (None, "model")
    assert sharding.FALLBACK_LOG == jsh.FALLBACK_LOG == [
        ("t2", "batch", 7, ("data",), "indivisible")]
    x = torch.zeros(7, 128)
    assert sharding.constrain(x, "batch", "d_ff") is x
    assert sharding.active_mesh() is None
    cfg = get_smoke_config("granite-3-2b")
    tc = TrainConfig(checkpoint_dir=str(tmp_path))
    assert Trainer(Model(cfg, device="cpu"), tc).mesh is None


def test_mtp_loss_present():
    cfg = get_smoke_config("deepseek-v3-671b")
    assert cfg.mtp
    m = Model(cfg, device="cpu").init_params(0)
    toks = torch.randint(0, cfg.vocab, (2, 16),
                         generator=torch.Generator().manual_seed(1))
    loss, metrics = m.loss({"tokens": toks,
                            "targets": torch.roll(toks, -1, 1)})
    assert "mtp" in metrics and np.isfinite(metrics["mtp"].item())


def test_init_state_redraws_the_weights(tmp_path):
    """A model reused by a second trainer starts again from the seed's
    weights and a zero optimizer state."""
    cfg = get_smoke_config("granite-3-2b")
    tc = TrainConfig(steps=2, checkpoint_every=100, warmup_steps=0,
                     checkpoint_dir=str(tmp_path), log_every=100)
    m = Model(cfg, device="cpu")
    fresh = Model(cfg, device="cpu").init_params(tc.seed).state_dict()
    Trainer(m, tc).run(lm_batch_iterator(cfg, 2, 16))
    assert not torch.equal(m.state_dict()["embed.table"],
                           fresh["embed.table"])
    state = Trainer(m, tc).init_state(tc.seed)
    for k, v in m.state_dict().items():
        assert torch.equal(v, fresh[k]), k
    assert int(state["count"]) == 0
    assert all(float(t.abs().max()) == 0 for s in state["slots"].values()
               for t in s.values())
