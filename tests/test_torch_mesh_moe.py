"""The port's shard_map MoE (``expert_sharding="ep_sm"``, ``moe.
_moe_chunked_shardmap``) on an 8-rank gloo world, a 4 x 2 ("data",
"model") mesh, on the CPU — the reference test's input: deepseek-v3's
smoke config at float32, x of shape (4, 4096, d_model), all 16,384
tokens on the chunked path.

The weights and x are drawn once with numpy (seeded) and carried to
three runs:
  * the port's no-mesh path (``_moe_chunked``), in this process;
  * the port's ep_sm on every rank of the world (a subprocess that
    spawns the 8 ranks: a process group never lives in the pytest
    worker);
  * the reference's ep_sm under ``jax.jit`` on an 8-device host mesh
    with Auto axes (a subprocess; JAX 0.9's default Explicit axes are
    what fail the reference's own ``test_ep_sm_shardmap_moe_matches_
    pjit_on_real_mesh``).

Each run returns y and the gradients of sum(sin(y)) with respect to x,
w1, w2 and w3.  On every rank the forward must equal the no-mesh path's
and the reference's within ``FWD_ATOL``, and each gradient within
``GRAD_RTOL`` of its leaf's largest magnitude: the ranks' collectives'
backwards must leave each rank holding the whole gradient of each
global input.  Each rank's forward must call exactly 2 all-to-alls and
1 all-reduce a chunk (and the 1 all-gather of ``out_specs``), counted by
``CommDebugMode``.  The worst errors are printed.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
DATA, MODEL = 4, 2
WORLD = DATA * MODEL
X_SHAPE = (4, 4096)           # (batch, seq); d_model from the config
FWD_ATOL = 1e-5
GRAD_RTOL = 1e-5
GRAD_KEYS = ("x", "w1", "w2", "w3")


def _cfg():
    from repro_torch.configs import get_smoke_config
    return get_smoke_config("deepseek-v3-671b").replace(
        compute_dtype="float32", expert_sharding="ep_sm")


def _inputs():
    """The MoE's parameters (by ``moe_spec``) and x, numpy, seeded."""
    from repro_torch.models import moe
    from repro_torch.models import params as P
    cfg = _cfg()
    rng = np.random.default_rng(0)
    flat = {}
    for path, s in P.leaves(moe.moe_spec(cfg)):
        std = 0.02 if len(s.shape) == 1 else s.shape[-2] ** -0.5
        flat[path] = (std * rng.standard_normal(s.shape)).astype(np.float32)
    x = (0.1 * rng.standard_normal(X_SHAPE + (cfg.d_model,))).astype(
        np.float32)
    return P.nest(flat), x


def _torch_run(p_np, x_np, mesh=None):
    """(y, grads) of the port's moe_ffn, and the forward's collective
    counts under ``mesh``."""
    from repro_torch.models import moe
    from repro_torch.parallel import sharding as sh
    leaves = {}

    def to_t(tree, prefix=""):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = to_t(v, prefix + k + ".")
            else:
                out[k] = leaves[prefix + k] = torch.tensor(
                    v, requires_grad=True)
        return out

    p = to_t(p_np)
    x = torch.tensor(x_np, requires_grad=True)
    counts = None
    if mesh is None:
        y = moe.moe_ffn(_cfg(), p, x, torch.float32)[0]
    else:
        from torch.distributed.tensor.debug import CommDebugMode
        with sh.activate(mesh, sh.make_rules("train"), "moe"), \
                CommDebugMode() as comm:
            y = moe.moe_ffn(_cfg(), p, x, torch.float32)[0]
        counts = {str(k).rsplit(".", 1)[-1]: v
                  for k, v in comm.get_comm_counts().items()}
    torch.sin(y).sum().backward()
    grads = {"x": x.grad, **{k: leaves[k].grad for k in ("w1", "w2", "w3")}}
    return (y.detach().numpy(), {k: g.numpy() for k, g in grads.items()},
            counts)


def _worker(rank: int, store: str, out_dir: str):
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, WORLD),
                            rank=rank, world_size=WORLD)
    try:
        from repro_torch.launch.mesh import make_host_mesh
        mesh = make_host_mesh(data=DATA, model=MODEL, device="cpu")
        p_np, x_np = _inputs()
        y, grads, counts = _torch_run(p_np, x_np, mesh)
        np.savez(Path(out_dir) / f"rank{rank}.npz", y=y, **grads)
        (Path(out_dir) / f"rank{rank}.json").write_text(json.dumps(counts))
    finally:
        dist.destroy_process_group()


_REF = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, jax.numpy as jnp, numpy as np
import repro.models.moe as moe
from repro.configs import get_smoke_config
from repro.parallel import sharding as sh
d = np.load(sys.argv[1], allow_pickle=True)
p = jax.tree.map(jnp.asarray, d["p"].item())
x = jnp.asarray(d["x"])
cfg = get_smoke_config("deepseek-v3-671b").replace(
    compute_dtype="float32", expert_sharding="ep_sm")
mesh = jax.make_mesh((4, 2), ("data", "model"),
                     axis_types=(jax.sharding.AxisType.Auto,) * 2)

def loss(x, w1, w2, w3):
    q = dict(p, w1=w1, w2=w2, w3=w3)
    y = moe.moe_ffn(cfg, q, x, jnp.float32)[0]
    return jnp.sum(jnp.sin(y)), y

with sh.activate(mesh, sh.make_rules("train"), "moe"):
    (_, y), g = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2, 3),
                                           has_aux=True))(
        x, p["w1"], p["w2"], p["w3"])
np.savez(sys.argv[2], y=np.asarray(y),
         **{k: np.asarray(v) for k, v in zip(("x", "w1", "w2", "w3"), g)})
print("REF_OK")
"""


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src") + os.pathsep + str(ROOT / "tests")
    env.setdefault("GLOO_SOCKET_IFNAME", "lo")
    return env


def _worst(y, grads, y_want, g_want):
    fwd = float(np.abs(y - y_want).max())
    rel = {k: float(np.abs(grads[k] - g_want[k]).max()
                    / np.abs(g_want[k]).max()) for k in GRAD_KEYS}
    return fwd, rel


def test_ep_sm_moe_on_a_4x2_gloo_world(tmp_path):
    p_np, x_np = _inputs()
    np.savez(tmp_path / "in.npz", p=np.array(p_np, dtype=object), x=x_np)
    ref = subprocess.Popen(
        [sys.executable, "-c", _REF, str(tmp_path / "in.npz"),
         str(tmp_path / "ref.npz")], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, env=_env(), cwd=ROOT)
    world = subprocess.Popen(
        [sys.executable, __file__, str(tmp_path / "store"), str(tmp_path)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=_env(), cwd=ROOT)
    y0, g0, _ = _torch_run(p_np, x_np)          # the no-mesh path
    out, err = world.communicate(timeout=300)
    assert world.returncode == 0, err[-3000:]
    rout, rerr = ref.communicate(timeout=300)
    assert "REF_OK" in rout, rerr[-3000:]
    want = np.load(tmp_path / "ref.npz")
    fwd_ref, rel_ref = _worst(y0, g0, want["y"], want)
    print(f"no-mesh port vs reference ep_sm: fwd {fwd_ref:.3e}, grads rel "
          + ", ".join(f"{k} {v:.3e}" for k, v in rel_ref.items()))
    worst = {"mesh": [0.0, dict.fromkeys(GRAD_KEYS, 0.0)],
             "ref": [0.0, dict.fromkeys(GRAD_KEYS, 0.0)]}
    for rank in range(WORLD):
        got = np.load(tmp_path / f"rank{rank}.npz")
        counts = json.loads((tmp_path / f"rank{rank}.json").read_text())
        assert counts == {"all_to_all_single": 2, "all_reduce": 1,
                          "all_gather_into_tensor": 1}, (rank, counts)
        for name, (yw, gw) in (("mesh", (y0, g0)), ("ref", (want["y"], want))):
            fwd, rel = _worst(got["y"], got, yw, gw)
            assert fwd < FWD_ATOL, (rank, name, fwd)
            for k in GRAD_KEYS:
                assert rel[k] < GRAD_RTOL, (rank, name, k, rel[k])
                worst[name][1][k] = max(worst[name][1][k], rel[k])
            worst[name][0] = max(worst[name][0], fwd)
    for name, what in (("mesh", "the port's no-mesh path"),
                       ("ref", "the reference's ep_sm")):
        fwd, rel = worst[name]
        print(f"ep_sm on 8 ranks vs {what}: worst fwd {fwd:.3e} (bound "
              f"{FWD_ATOL}), worst grads rel " + ", ".join(
                  f"{k} {v:.3e}" for k, v in rel.items())
              + f" (bound {GRAD_RTOL}; |y| up to {np.abs(y0).max():.3f})")


if __name__ == "__main__":
    import torch.multiprocessing as mp
    mp.start_processes(_worker, args=(sys.argv[1], sys.argv[2]),
                       nprocs=WORLD, start_method="spawn")
