"""The port's ``Trainer`` on a host mesh, on the CPU: a 2-rank gloo world
(``make_host_mesh(data=2)``), each rank one process, trains granite-3-2b's
smoke config at float32 for 4 steps of batch 4 x 32.  Each rank takes its
"batch" block of every batch and the ranks average their gradients over
"data" before the clip, so the losses must equal, within ``LOSS_ATOL``:

  * the port's one-process ``Trainer`` on the whole batch (no mesh);
  * the reference's ``Trainer`` on a 2-device host mesh with Auto axes
    (JAX 0.9's default Explicit axes make the reference's sharding
    constraints raise, as in its own two red mesh tests).

All three start from the reference's initial weights (carried across)
and see the same batches.  Then ``python -m repro_torch.launch.train
--smoke`` runs with its world of one (the launcher starts it and ends
it) and its losses equal a one-process ``Trainer`` without a mesh.

Process groups live only in subprocesses: the world is spawned by this
file run as a script, the launcher and the reference run in their own.
"""
import json
import os
import pickle
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
STEPS, BATCH, SEQ = 4, 4, 32
LOSS_ATOL = 1e-5
ARCH = "granite-3-2b"

_REF = r"""
import os, pickle, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
import jax, numpy as np
from repro.common.config import TrainConfig
from repro.configs import get_smoke_config
from repro.models.model import Model
from repro.train.loop import Trainer, lm_batch_iterator
cfg = get_smoke_config("granite-3-2b").replace(compute_dtype="float32")
mesh = jax.make_mesh((2, 1), ("data", "model"),
                     axis_types=(jax.sharding.AxisType.Auto,) * 2)
tc = TrainConfig(steps=4, learning_rate=1e-3, checkpoint_dir=sys.argv[2],
                 checkpoint_every=100, log_every=100)
rec = {}

class Recording(Trainer):
    def init_state(self, seed=0):
        params, opt = super().init_state(seed)
        rec["init"] = jax.tree.map(np.asarray, params)
        return params, opt

res = Recording(Model(cfg), tc, mesh=mesh).run(lm_batch_iterator(cfg, 4, 32))
rec["losses"] = res.losses
with open(sys.argv[1], "wb") as f:
    pickle.dump(rec, f)
print("REF_OK", len(jax.devices()))
"""


def _trainer(init, ckpt_dir, mesh=None):
    """The port's Trainer on ``ARCH`` (float32), starting from the
    reference's initial weights ``init``."""
    from repro_torch.common.config import TrainConfig
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.model import Model, lm_params_from_numpy
    from repro_torch.train.loop import Trainer

    class Carrying(Trainer):
        def init_state(self, seed=0):
            state = super().init_state(seed)
            self.model.load_state_dict(lm_params_from_numpy(
                init, self.model.cfg, self.model.device))
            return state

    cfg = get_smoke_config(ARCH).replace(compute_dtype="float32")
    tc = TrainConfig(steps=STEPS, learning_rate=1e-3,
                     checkpoint_dir=str(ckpt_dir), checkpoint_every=100,
                     log_every=100)
    return Carrying(Model(cfg, device="cpu"), tc, mesh=mesh), cfg


def _losses(init, ckpt_dir, mesh=None):
    from repro_torch.train.loop import lm_batch_iterator
    trainer, cfg = _trainer(init, ckpt_dir, mesh)
    return trainer.run(lm_batch_iterator(cfg, BATCH, SEQ)).losses


def _worker(rank: int, store: str, out_dir: str):
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, 2),
                            rank=rank, world_size=2)
    try:
        from repro_torch.launch.mesh import make_host_mesh
        mesh = make_host_mesh(data=2, device="cpu")
        assert tuple(mesh.shape) == (2, 1)
        with open(Path(out_dir) / "ref.pkl", "rb") as f:
            init = pickle.load(f)["init"]
        losses = _losses(init, Path(out_dir) / f"ckpt{rank}", mesh)
        (Path(out_dir) / f"rank{rank}.json").write_text(json.dumps(losses))
    finally:
        dist.destroy_process_group()


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src") + os.pathsep + str(ROOT / "tests")
    env.setdefault("GLOO_SOCKET_IFNAME", "lo")
    return env


def _run(args, timeout=300):
    proc = subprocess.run([sys.executable, *args], capture_output=True,
                          text=True, timeout=timeout, env=_env(), cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc.stdout


def test_host_mesh_trainer_matches_one_process_and_reference(tmp_path):
    out = _run(["-c", _REF, str(tmp_path / "ref.pkl"),
                str(tmp_path / "ref_ckpt")])
    assert "REF_OK 2" in out
    with open(tmp_path / "ref.pkl", "rb") as f:
        ref = pickle.load(f)
    world = subprocess.Popen(
        [sys.executable, __file__, str(tmp_path / "store"), str(tmp_path)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=_env(), cwd=ROOT)
    one = _losses(ref["init"], tmp_path / "one")
    _, err = world.communicate(timeout=300)
    assert world.returncode == 0, err[-3000:]
    ranks = [json.loads((tmp_path / f"rank{r}.json").read_text())
             for r in range(2)]
    assert ranks[0] == ranks[1]
    mesh = np.array(ranks[0])
    assert len(mesh) == len(one) == len(ref["losses"]) == STEPS
    e_one = np.abs(mesh - np.array(one)).max()
    e_ref = np.abs(mesh - np.array(ref["losses"])).max()
    print(f"2-rank host mesh, {STEPS} steps: losses {mesh.round(6).tolist()}"
          f"; vs one process max abs err {e_one:.2e}, vs the reference on "
          f"a 2-device Auto mesh {e_ref:.2e} (bound {LOSS_ATOL})")
    assert e_one < LOSS_ATOL and e_ref < LOSS_ATOL


def test_launch_train_runs_with_its_world_of_one(tmp_path):
    out = _run(["-m", "repro_torch.launch.train", "--arch", ARCH,
                "--smoke", "--steps", "3", "--batch", "2", "--seq", "16",
                "--device", "cpu", "--ckpt-dir", str(tmp_path / "launch")])
    m = re.search(r"\[train\] done: 3 steps, loss ([\d.]+) -> ([\d.]+)", out)
    assert m, out
    from repro_torch.common.config import TrainConfig
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.model import Model
    from repro_torch.train.loop import Trainer, lm_batch_iterator
    cfg = get_smoke_config(ARCH)
    tc = TrainConfig(steps=3, learning_rate=1e-3, checkpoint_every=50,
                     checkpoint_dir=str(tmp_path / "plain"))
    res = Trainer(Model(cfg, device="cpu"), tc).run(
        lm_batch_iterator(cfg, 2, 16))
    assert (m.group(1), m.group(2)) == (f"{res.losses[0]:.4f}",
                                        f"{res.final_loss:.4f}"), out


if __name__ == "__main__":
    import torch.multiprocessing as mp
    mp.start_processes(_worker, args=(sys.argv[1], sys.argv[2]), nprocs=2,
                       start_method="spawn")
