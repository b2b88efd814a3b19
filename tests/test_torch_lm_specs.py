"""The port's LM configs and parameter trees against the reference, on
the CPU, allocating nothing at full size.

* Every arch's ``config()`` and ``smoke_config()`` equal the
  reference's, field for field.
* Every full config's parameter spec tree equals the reference's leaf
  for leaf (path, shape, logical axes, initializer, dtype), so
  ``count_params`` and ``param_bytes`` agree exactly; gemma2-2b has
  2,614,341,888 parameters (10,457,367,552 B in float32).  The port's
  ``shapes`` are tensors on the ``meta`` device.
* The decode cache spec trees agree leaf for leaf.
* At smoke size the port's ``Model`` holds exactly the parameters
  ``lm_params_from_numpy`` makes of the reference's tree (same names,
  shapes and dtypes), and ``init_params`` draws the same weights from
  one seed on every call, by the reference's per-leaf rules.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import ALL_ARCHS
from repro.configs import get_config as jget_config
from repro.configs import get_smoke_config as jget_smoke
from repro.models import params as JP
from repro.models.model import Model as JModel
from repro_torch.configs import ALL_ARCHS as T_ARCHS
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.models import params as P
from repro_torch.models.model import (Model, cache_spec, lm_params_from_numpy,
                                      param_spec)

torch.set_num_threads(1)


def _jleaves(tree):
    out = {}
    for path, s in jax.tree_util.tree_flatten_with_path(
            tree, is_leaf=JP.is_spec)[0]:
        out[".".join(p.key for p in path)] = tuple(s)
    return out


def _tleaves(tree):
    return {path: tuple(s) for path, s in P.leaves(tree)}


def test_registries_equal():
    assert T_ARCHS == ALL_ARCHS
    assert get_config("dlrm").name == "dlrm"


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_configs_equal(arch):
    for mine, ref in ((get_config(arch), jget_config(arch)),
                      (get_smoke_config(arch), jget_smoke(arch))):
        assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
        for prop in ("resolved_head_dim", "n_blocks", "scanned_layers",
                     "tail_pattern", "is_encdec"):
            assert getattr(mine, prop) == getattr(ref, prop), prop
        assert [s.name for s in mine.active_shapes()] == \
            [s.name for s in ref.active_shapes()]


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_full_config_param_tree_equals_reference(arch):
    cfg, jcfg = get_config(arch), jget_config(arch)
    spec, jspec = param_spec(cfg), JModel(jcfg).param_spec()
    assert _tleaves(spec) == _jleaves(jspec)
    n, nb = P.count_params(spec), P.param_bytes(spec, cfg.param_dtype)
    assert n == JP.count_params(jspec)
    assert nb == JP.param_bytes(jspec, jcfg.param_dtype)
    shapes = P.shapes(spec, cfg.param_dtype)
    metas = [t for _, t in _flat(shapes)]
    assert all(t.device.type == "meta" for t in metas)
    assert sum(t.numel() * t.element_size() for t in metas) == nb
    print(f"{arch}: {n:,} parameters, {nb:,} B at {cfg.param_dtype}")
    if arch == "gemma2-2b":
        assert (n, nb) == (2_614_341_888, 10_457_367_552)


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}.")
        else:
            yield prefix + k, v


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_cache_spec_equals_reference(arch):
    cfg, jcfg = get_config(arch), jget_config(arch)
    enc = 1504 if cfg.is_encdec else 0
    mine = cache_spec(cfg, 2, 4096, enc)
    ref = JModel(jcfg).cache_spec(2, 4096, enc)
    assert _tleaves(mine) == _jleaves(ref)


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_smoke_model_holds_the_reference_tree(arch):
    cfg = get_smoke_config(arch)
    ref = jax.tree.map(np.asarray, JModel(jget_smoke(arch)).init_params(
        jax.random.key(0)))
    sd = lm_params_from_numpy(ref, cfg, "cpu")
    m = Model(cfg, device="cpu")
    mine = m.state_dict()
    assert sorted(mine) == sorted(sd)
    for k, v in sd.items():
        assert mine[k].shape == v.shape and mine[k].dtype == v.dtype, k
    m.load_state_dict(sd)
    # a stacked leaf is split along its layers axis: block i is row i
    if "blocks" in ref["decoder"]:
        name, leaf = next(_flat(ref["decoder"]["blocks"]))
        for i in range(leaf.shape[0]):
            np.testing.assert_array_equal(
                m.state_dict()[f"decoder.blocks.{i}.{name}"].numpy(), leaf[i])


@pytest.mark.parametrize("arch", ["gemma2-2b", "deepseek-v3-671b",
                                  "xlstm-125m", "whisper-base"])
def test_init_params_is_seeded_and_follows_the_reference_rules(arch):
    """One seed, one set of weights (drawn on a CPU generator); each
    leaf drawn by the reference's rule: zeros and ones exactly, and a
    random leaf of 1024 or more elements within 20 % of the standard
    deviation of the reference's draw of the same leaf."""
    cfg = get_smoke_config(arch)
    a = Model(cfg, device="cpu").init_params(seed=3).state_dict()
    b = Model(cfg, device="cpu").init_params(seed=3).state_dict()
    c = Model(cfg, device="cpu").init_params(seed=4).state_dict()
    ref = lm_params_from_numpy(jax.tree.map(np.asarray, JModel(
        jget_smoke(arch)).init_params(jax.random.key(0))), cfg, "cpu")
    worst = 0.0
    for k, want in ref.items():
        assert torch.equal(a[k], b[k]), k
        if not torch.equal(want, torch.zeros_like(want)) and \
                not torch.equal(want, torch.ones_like(want)):
            assert not torch.equal(a[k], c[k]), k
            if want.numel() >= 1024:
                r = a[k].float().std().item() / want.float().std().item()
                worst = max(worst, abs(r - 1))
        else:
            assert torch.equal(a[k], want), k
    print(f"{arch}: worst std ratio off by {worst:.3f}")
    assert worst < 0.2
