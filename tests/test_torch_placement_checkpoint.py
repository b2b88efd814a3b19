"""The elastic checkpoint restore against the JAX reference, on the CPU.

The reference writes granite-3-2b's smoke parameters (its
``init_params(key(0))``, float32) with its ``Checkpointer``, and restores
them by the train rules (``tree_shardings`` of the parameter specs'
logical axes: FSDP "embed" over "data", TP over "model") on host meshes
of 2x1, 2x2 and 1x1 of its 4 host devices (Auto axes).  The port's
``Checkpointer.restore(like, shardings=)`` restores the same file in
gloo worlds of 2, 4 and 1 ranks on ``make_host_mesh`` meshes of those
shapes.  Then:

  * every rank's block of every leaf is bit-equal to the reference's
    shard at the same mesh coordinate, under the same resolved spec;
  * the 4-rank world saves its ``DTensor`` leaves (a collective: every
    rank calls ``save``, only the rank at coordinate (0, 0) writes); the
    reference restores that file bit for bit, and so does the port's
    2-rank world (a 4-rank save restored on 2 ranks).

Process groups live only in subprocesses: each world is spawned by this
file run as a script; the reference runs in its own.
"""
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
ARCH = "granite-3-2b"
# mesh -> (world, (data, model))
MESHES = {"2x1": (2, (2, 1)), "2x2": (4, (2, 2)), "1x1": (1, (1, 1))}

_REF = r"""
import os, pickle, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, numpy as np
from jax.sharding import AxisType, Mesh
sys.path.insert(0, sys.argv[3])
import test_torch_placement_checkpoint as T
from repro.checkpoint.checkpoint import Checkpointer
from repro.configs import get_smoke_config
from repro.models import params as P
from repro.models.model import Model
from repro.parallel import sharding as sh
cfg = get_smoke_config(T.ARCH)
pspec = Model(cfg).param_spec()
like = {"params": P.shapes(pspec, cfg.param_dtype)}


def shardings_on(shape):
    n = shape[0] * shape[1]
    mesh = Mesh(np.array(jax.devices()[:n]).reshape(shape),
                ("data", "model"), axis_types=(AxisType.Auto,) * 2)
    return mesh, {"params": sh.tree_shardings(
        like["params"], P.axes(pspec), mesh, sh.make_rules("train"))}


out = {"n_devices": len(jax.devices())}
if sys.argv[1] == "write":
    params = Model(cfg).init_params(jax.random.key(0))
    Checkpointer(sys.argv[2]).save(0, {"params": params}, blocking=True)
    out["whole"] = [np.asarray(x) for x in jax.tree.leaves(params)]
    out["meshes"] = {}
    for name, (world, shape) in T.MESHES.items():
        mesh, shd = shardings_on(shape)
        _, got = Checkpointer(sys.argv[2]).restore(like, shardings=shd)
        leaves = []
        for a, s in zip(jax.tree.leaves(got), jax.tree.leaves(shd)):
            assert a.sharding == s
            blocks = {}
            for piece in a.addressable_shards:
                coord = tuple(int(i) for i in
                              np.argwhere(mesh.devices == piece.device)[0])
                blocks[coord] = np.asarray(piece.data)
            leaves.append({"spec": T.spec_entries(s.spec), "blocks": blocks})
        out["meshes"][name] = leaves
else:
    # the port's DTensor save, restored whole and on the 2x2 mesh
    _, got = Checkpointer(sys.argv[2]).restore(like)
    out["whole"] = [np.asarray(x) for x in jax.tree.leaves(got)]
    _, shd = shardings_on((2, 2))
    _, got = Checkpointer(sys.argv[2]).restore(like, shardings=shd)
    out["sharded_whole"] = [np.asarray(x) for x in jax.tree.leaves(got)]
with open(sys.argv[4], "wb") as f:
    pickle.dump(out, f)
print("REF_OK")
"""


def spec_entries(spec) -> tuple:
    """A PartitionSpec of either package as a tuple of entries (a name, a
    tuple of names or None), trailing Nones dropped."""
    out = [tuple(e) if isinstance(e, (tuple, list)) else e for e in spec]
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def _restore(ckpt_dir: str, shape):
    """The port's sharded restore of the parameter tree on a
    ``make_host_mesh(*shape)``; returns the mesh, the shardings and the
    restored tree."""
    from repro_torch.checkpoint.checkpoint import Checkpointer
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import params as P
    from repro_torch.models.model import param_spec
    from repro_torch.parallel import sharding as sh
    cfg = get_smoke_config(ARCH)
    pspec = param_spec(cfg)
    like = {"params": P.shapes(pspec, cfg.param_dtype)}
    mesh = make_host_mesh(*shape, device="cpu")
    assert tuple(mesh.shape) == tuple(shape)
    shd = {"params": sh.tree_shardings(like["params"], P.axes(pspec), mesh,
                                       sh.make_rules("train"))}
    step, got = Checkpointer(ckpt_dir).restore(like, shardings=shd)
    assert step == 0
    return mesh, shd, got


def _worker(rank: int, world: int, store: str, tmp: str):
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor
    from repro_torch.checkpoint.checkpoint import Checkpointer
    from repro_torch.models.params import tree_items
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    try:
        out = {}
        for name, (w, shape) in MESHES.items():
            if w != world:
                continue
            mesh, shd, got = _restore(f"{tmp}/ref_ckpt", shape)
            leaves = []
            for (_, a), (_, s) in zip(tree_items(got), tree_items(shd)):
                assert isinstance(a, DTensor) and a.device.type == "cpu"
                leaves.append({"spec": spec_entries(s.spec),
                               "block": a.to_local().numpy().copy()})
            out[name] = {"coordinate": tuple(mesh.get_coordinate()),
                         "leaves": leaves}
            if world == 4:
                Checkpointer(f"{tmp}/port_ckpt").save(0, got, blocking=True)
            if world == 2:
                _, _, again = _restore(f"{tmp}/port_ckpt", shape)
                out["4to2_equal"] = all(
                    torch.equal(a.to_local(), b.to_local())
                    for (_, a), (_, b) in zip(tree_items(got),
                                              tree_items(again)))
        with open(Path(tmp) / f"w{world}_rank{rank}.pkl", "wb") as f:
            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src") + os.pathsep + str(ROOT / "tests")
    env.setdefault("GLOO_SOCKET_IFNAME", "lo")
    env["JAX_PLATFORMS"] = "cpu"
    return env


def _start(args):
    return subprocess.Popen([sys.executable, *args], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=_env(),
                            cwd=ROOT)


def _finish(proc, timeout=240):
    out, err = proc.communicate(timeout=timeout)
    assert proc.returncode == 0, err[-3000:]
    return out


def _world(world: int, tmp: Path):
    return _start([__file__, str(world), str(tmp / f"store{world}"),
                   str(tmp)])


def _ref(mode: str, ckpt: Path, out: Path):
    return _start(["-c", _REF, mode, str(ckpt), str(ROOT / "tests"),
                   str(out)])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("placement_ckpt")
    assert "REF_OK" in _finish(_ref("write", tmp / "ref_ckpt",
                                    tmp / "ref.pkl"))
    _finish(_world(4, tmp))
    procs = [_world(2, tmp), _world(1, tmp),
             _ref("read", tmp / "port_ckpt", tmp / "ref_read.pkl")]
    assert "REF_OK" in _finish(procs[-1])
    for p in procs[:-1]:
        _finish(p)
    out = {}
    for f in ("ref", "ref_read"):
        with open(tmp / f"{f}.pkl", "rb") as fh:
            out[f] = pickle.load(fh)
    for name, (world, _) in MESHES.items():
        out[name] = []
        for r in range(world):
            with open(tmp / f"w{world}_rank{r}.pkl", "rb") as fh:
                out[name].append(pickle.load(fh))
    return out


@pytest.mark.parametrize("name", sorted(MESHES))
def test_reference_checkpoint_restores_sharded_as_the_reference(runs, name):
    ref = runs["ref"]
    assert ref["n_devices"] == 4
    world, shape = MESHES[name]
    want = ref["meshes"][name]
    ranks = [r[name] for r in runs[name]]
    assert sorted(r["coordinate"] for r in ranks) == sorted(
        want[0]["blocks"])
    sharded = 0
    for r in ranks:
        assert len(r["leaves"]) == len(want)
        for i, (got, w) in enumerate(zip(r["leaves"], want)):
            assert got["spec"] == w["spec"], (i, got["spec"], w["spec"])
            block = w["blocks"][r["coordinate"]]
            assert got["block"].dtype == block.dtype, i
            np.testing.assert_array_equal(got["block"], block)
            sharded += got["block"].shape != ref["whole"][i].shape
    print(f"{name}: {world} ranks x {len(want)} leaves bit-equal to the "
          f"reference's shards; {sharded} rank-leaf blocks smaller than "
          f"the leaf")
    assert sharded > 0 or name == "1x1"


def test_dtensor_save_restores_in_the_reference_and_on_two_ranks(runs):
    whole = runs["ref"]["whole"]
    for what in ("whole", "sharded_whole"):
        got = runs["ref_read"][what]
        assert len(got) == len(whole)
        for a, b in zip(got, whole):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)
    assert all(r["4to2_equal"] for r in runs["2x1"])


if __name__ == "__main__":
    import torch.multiprocessing as mp
    world = int(sys.argv[1])
    mp.start_processes(_worker, args=(world, sys.argv[2], sys.argv[3]),
                       nprocs=world, start_method="spawn")
