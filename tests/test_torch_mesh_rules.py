"""The port's logical-axis sharding (``repro_torch.parallel.sharding``)
against the reference's (``repro.parallel.sharding``), on the CPU.

The rule tables and ``make_rules`` are compared as data.  Then every
argument leaf of every (arch x shape) cell — parameters, inputs, and the
optimizer state (train) or the cache (serve) — is resolved on both
production meshes by both packages, in the reference dry run's order,
and the specs and the fallback logs must be equal, entry for entry.

No device and no process group: the reference's ``resolve_spec`` reads
only ``mesh.axis_names`` and ``mesh.devices.shape``, the port's only
``mesh.mesh_dim_names`` and ``mesh.shape``, so stand-in meshes with
those attributes drive both, and nothing is compiled.
"""
from types import SimpleNamespace

import jax
import pytest
import torch

from repro.common.config import LM_SHAPES as J_SHAPES
from repro.configs import ALL_ARCHS, get_config as j_get_config
from repro.models import params as JP
from repro.models.model import Model as JModel, input_specs as j_input_specs
from repro.optim.optimizers import make_optimizer as j_make_optimizer
from repro.parallel import sharding as jsh
from repro_torch.common.config import SHAPES_BY_NAME
from repro_torch.configs import get_config
from repro_torch.launch.dryrun import argument_bytes, resolve_cell
from repro_torch.parallel import sharding as sh

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


def _j_mesh(name):
    shape, axes = MESHES[name]
    return SimpleNamespace(axis_names=axes,
                           devices=SimpleNamespace(shape=shape))


def _t_mesh(name):
    shape, axes = MESHES[name]
    return SimpleNamespace(mesh_dim_names=axes, shape=shape)


def _j_enc_len(cfg, shape):
    if cfg.is_encdec and shape.is_decode:
        return 1504
    return shape.seq_len if cfg.is_encdec else 0


def _j_resolve_cell(cfg, shape, mesh):
    """The reference dry run's resolution order (``build_lowering``):
    params, inputs, then the optimizer state or the cache, each tree by
    ``jax.tree.map`` (pytree order)."""
    rules = jsh.make_rules("train" if shape.kind == "train" else "serve",
                           long_context=(shape.name == "long_500k"))
    ctx = f"{cfg.name}/{shape.name}"
    model = JModel(cfg)
    pspec = model.param_spec()
    ispecs, iaxes = j_input_specs(cfg, shape)
    trees = [(JP.shapes(pspec, cfg.param_dtype), JP.axes(pspec)),
             (ispecs, iaxes)]
    if shape.kind == "train":
        ospec = j_make_optimizer(cfg.optimizer).state_spec(pspec)
        trees.append((JP.shapes(ospec, "float32"), JP.axes(ospec)))
    else:
        cspec = model.cache_spec(shape.global_batch, shape.seq_len,
                                 _j_enc_len(cfg, shape))
        trees.append((JP.shapes(cspec, cfg.compute_dtype), JP.axes(cspec)))
    out = []
    for shapes, axes in trees:
        specs = jax.tree.map(
            lambda s, a: jsh.resolve_spec(s.shape, a, mesh, rules, ctx),
            shapes, axes,
            is_leaf=lambda t: isinstance(t, jax.ShapeDtypeStruct))
        out.extend(tuple(s) for s in jax.tree.leaves(
            specs, is_leaf=lambda t: isinstance(
                t, jax.sharding.PartitionSpec)))
    return out


def test_rule_tables_equal_the_references():
    assert sh.TRAIN_RULES == jsh.TRAIN_RULES
    assert sh.SERVE_RULES == jsh.SERVE_RULES
    assert sh.LONG_CONTEXT_OVERRIDES == jsh.LONG_CONTEXT_OVERRIDES
    for kind in ("train", "prefill", "decode"):
        for lc in (False, True):
            assert sh.make_rules(kind, long_context=lc) == \
                jsh.make_rules(kind, long_context=lc), (kind, lc)
    assert sh._c("data", ("pod", "data"), None) == \
        jsh._c("data", ("pod", "data"), None)


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_every_leaf_resolves_as_the_references(arch, mesh):
    n_leaves = n_fallbacks = 0
    for jshape in J_SHAPES:
        jcfg = j_get_config(arch)
        tshape = SHAPES_BY_NAME[jshape.name]
        jsh.clear_fallback_log()
        want = _j_resolve_cell(jcfg, jshape, _j_mesh(mesh))
        want_log = list(jsh.FALLBACK_LOG)
        want_summary = jsh.fallback_summary()
        sh.clear_fallback_log()
        got = [tuple(leaf[-1]) for leaf in resolve_cell(
            get_config(arch), tshape, _t_mesh(mesh))]
        assert got == want, (arch, jshape.name, mesh)
        assert sh.FALLBACK_LOG == want_log, (arch, jshape.name, mesh)
        assert sh.fallback_summary() == want_summary
        n_leaves += len(got)
        n_fallbacks += len(want_log)
    print(f"{arch} on {mesh}: {n_leaves} leaves over 4 shapes equal, "
          f"{n_fallbacks} fallback entries equal")


def test_named_sharding_blocks():
    mesh = _t_mesh("2x16x16")
    ns = sh.NamedSharding(mesh, sh.PartitionSpec(("pod", "data"), None,
                                                 "model"))
    assert ns.local_shape((64, 7, 32)) == (2, 7, 2)
    assert ns.local_bytes((64, 7, 32), torch.bfloat16) == 2 * 7 * 2 * 2
    from torch.distributed.tensor import Replicate, Shard
    assert ns.placements() == [Shard(0), Shard(0), Shard(2)]
    ns2 = sh.NamedSharding(_t_mesh("16x16"), sh.PartitionSpec(None, "data"))
    assert ns2.placements() == [Shard(1), Replicate()]
    # tree_shardings and named_sharding: resolve_spec leaf by leaf
    rules, m = sh.make_rules("train"), _t_mesh("16x16")
    tree = {"b": torch.empty((32, 8), device="meta"),
            "a": {"w": torch.empty((7, 64), device="meta")}}
    axes = {"b": ("batch", "heads"), "a": {"w": ("embed", "d_ff")}}
    got = sh.tree_shardings(tree, axes, m, rules, "t")
    assert got["b"].spec == ("data", None) and got["a"]["w"].spec == \
        (None, "model")
    assert sh.named_sharding((32, 8), ("batch", "heads")) is None
    with sh.activate(m, rules, "t"):
        assert sh.named_sharding((32, 8), ("batch", "heads")).spec == \
            got["b"].spec


def test_constrain_fills_the_log_and_moves_nothing():
    x = torch.arange(24.0).reshape(2, 3, 4)
    sh.clear_fallback_log()
    assert sh.constrain(x, "batch", "heads", None) is x
    assert sh.FALLBACK_LOG == [] and sh.active_mesh() is None
    mesh = _t_mesh("16x16")
    with sh.activate(mesh, sh.make_rules("train"), "t"):
        assert sh.active_mesh() is mesh
        assert sh.constrain(x, "batch", "heads", None) is x
    assert sh.active_mesh() is None
    assert sh.FALLBACK_LOG == [("t", "batch", 2, ("data",), "indivisible"),
                               ("t", "heads", 3, ("model",), "indivisible")]


def test_argument_bytes_split_by_tree():
    """The dry run's per-device argument bytes on gemma2-2b's two cells
    (the totals the reference's compiled memory analysis reports,
    ``tests/test_torch_mesh_dryrun.py``)."""
    mesh = _t_mesh("16x16")
    cfg = get_config("gemma2-2b")
    train = argument_bytes(cfg, SHAPES_BY_NAME["train_4k"], mesh)
    assert sum(train.values()) == 384_748_552, train
    assert train["opt_state"] == 2 * train["params"] + 4   # m, v + count
    long = argument_bytes(cfg, SHAPES_BY_NAME["long_500k"], mesh)
    assert sum(long.values()) == 3_794_860_040, long
    assert long["inputs"] == 4 and long["index_scalar"] == 4
