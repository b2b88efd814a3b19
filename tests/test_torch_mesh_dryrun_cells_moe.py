"""The port's MoE on the dry run's DTensor token stream: deepseek-v2-236b
x train_4k held to the reference's partition (a file of its own so that
``--dist loadfile`` gives its ~50 s walk a worker), and ``moe_ffn``
taking the reference's branch for every input.

On a DTensor ``x`` (the dry run's step, placed on the 16x16 mesh),
``moe_ffn`` picks its branch by the reference's rule alone: at most
``FLAT_PATH_MAX_TOKENS`` tokens take ``_moe_flat``, else
``expert_sharding="ep_sm"`` under a mesh takes the shard_map body
(``_moe_chunked_shardmap``), else ``_moe_chunked``, whose chunk loop
the walk counts as the reference's ``lax.scan`` is compiled: one body
times its trip count, the weights' reads hoisted out of the loop.  The
train cell's router contracts over its weight's split (the reference's
all-reduced logits each chunk), its top-k gathers the scores whole and
keeps each rank's block of the result, the experts' buckets move by
all-to-all (``_dryrun_check.check_cells``: memory exact, the fallback
text equal, dot FLOPs within 1 %, each kind's elements within 1 %,
``replicated_ops == {}``).
"""
import jax
import jax.numpy as jnp

from repro.configs import get_smoke_config as ref_smoke_config
from repro.models import moe as jmoe
from repro.parallel import sharding as jsharding
from repro_torch.configs import get_smoke_config

from _dryrun_check import check_cells, result, start

BRANCHES = ("_moe_flat", "_moe_chunked", "_moe_chunked_shardmap")

# the cells whose MoE layers each branch takes: deepseek-v3's smoke
# config at full shapes, ep_sm with 16 experts (they split over "data")
CASES = {"flat": ("decode_32k", None),
         "chunked": ("prefill_32k", None),
         "ep_sm": ("prefill_32k", {"expert_sharding": "ep_sm",
                                   "n_experts": 16})}

_BRANCHES = r"""
import json
from repro_torch.launch.dryrun import run_cell
from repro_torch.models import moe
taken = []
for name in %r:
    def wrap(cfg, p, x, compute_dtype, _f=getattr(moe, name), _n=name):
        taken.append([_n, list(x.shape), type(x).__name__])
        return _f(cfg, p, x, compute_dtype)
    setattr(moe, name, wrap)
out = {}
for key, (shape, over) in %r.items():
    taken.clear()
    r = run_cell("deepseek-v3-671b", shape, False, opt_override=over,
                 verbose=False, smoke=True)
    out[key] = {"status": r["status"], "error": r.get("error"),
                "replicated": r.get("replicated_ops"), "taken": list(taken)}
print("RESULT " + json.dumps(out))
""" % (BRANCHES, CASES)


def test_deepseek_v2_train_cell_matches_the_references_partition():
    got = check_cells("deepseek-v2-236b", ("train_4k",), dot_rtol=0.01)
    kinds = got["train_4k"]["coll_elements"]
    assert kinds["all-to-all(g=16)"] > 0 \
        and kinds["collective-permute(g=256)"] > 0


def _reference_branch(over, shape, monkeypatch):
    """The branch the reference's ``moe_ffn`` takes for an ``x`` of
    ``shape`` (abstract: ``jax.eval_shape``), under a mesh."""
    cfg = ref_smoke_config("deepseek-v3-671b")
    if over:
        cfg = cfg.replace(**over)
    taken = []
    for name in BRANCHES:
        def stub(cfg, p, x, compute_dtype, _n=name):
            taken.append(_n)
            return (jnp.zeros(x.shape, x.dtype), jnp.zeros((), jnp.float32),
                    jnp.zeros((cfg.n_experts,), jnp.float32))
        monkeypatch.setattr(jmoe, name, stub)
    monkeypatch.setattr(jsharding, "active_mesh", lambda: object())
    params = jax.tree.map(lambda s: jax.ShapeDtypeStruct(s.shape, jnp.float32),
                          jmoe.moe_spec(cfg),
                          is_leaf=lambda s: hasattr(s, "axes"))
    jax.eval_shape(lambda p, x: jmoe.moe_ffn(cfg, p, x),
                   params, jax.ShapeDtypeStruct(tuple(shape), jnp.bfloat16))
    assert len(taken) == 1, taken
    return taken[0]


def test_moe_ffn_on_a_dtensor_takes_the_references_branch(monkeypatch):
    """deepseek-v3 smoke on the fake 16x16 mesh: its decode's MoE layers
    take the flat branch, its prefill's the chunked one, and with
    ``expert_sharding="ep_sm"`` the shard_map body — each on a DTensor
    token stream, each the branch the reference's ``moe_ffn`` takes for
    that shape and config."""
    got = result(start(_BRANCHES), timeout=600)
    want = {"flat": "_moe_flat", "chunked": "_moe_chunked",
            "ep_sm": "_moe_chunked_shardmap"}
    for key, (shape, over) in CASES.items():
        cell = got[key]
        assert cell["status"] == "ok", cell
        assert cell["replicated"] == {}, cell
        cfg = get_smoke_config("deepseek-v3-671b")
        n_moe = cfg.n_layers - cfg.first_dense_layers
        assert len(cell["taken"]) == n_moe, cell["taken"]
        for name, x_shape, kind in cell["taken"]:
            assert kind == "DTensor", cell["taken"]
            assert name == want[key], (key, cell["taken"])
            assert _reference_branch(over, x_shape, monkeypatch) == name
