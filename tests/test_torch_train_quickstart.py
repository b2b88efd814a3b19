"""The port's quickstart example and training launcher, each run
in-process beside the reference's, on the CPU.

``repro_torch.examples.quickstart.main`` against ``examples/
quickstart.py`` (gemma2-2b smoke, 120 steps of batch 8 x 128, the
example's own bf16 compute): the reference example's checkpoint
directory is redirected to ``tmp_path`` (it is hardcoded under /tmp,
where a stale run would be resumed), its host mesh is made with Auto
axes (JAX 0.9's default Explicit axes break the reference's sharding
constraints, as in its two red mesh tests), and the port's ``Trainer`` is
given a test-only ``init_state`` that carries the reference's initial
weights, so both start from the same state and see the same batches.
Then ``repro_torch.launch.train.main`` against ``repro.launch.train.
main`` the same way (granite-3-2b smoke, float32 compute).

Tolerances (the worst errors printed): the per-step losses within
``QS_LOSS_ATOL`` for the quickstart — bf16 compute, where each product
and residual add rounds to 2^-8 and 120 steps of two packages' float
orders drift apart (``tests/_lm_diff.py`` holds one bf16 forward's
loss to 1e-2) — and within ``LAUNCH_LOSS_ATOL`` for the launcher at
float32.
"""
import importlib.util
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.common.config import TrainConfig as JTrainConfig
from repro.launch import train as jlaunch
from repro.train.loop import Trainer as JTrainer
from repro_torch.examples import quickstart as tq
from repro_torch.launch import train as tlaunch
from repro_torch.models.model import lm_params_from_numpy
from repro_torch.train.loop import Trainer

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
QS_LOSS_ATOL = 1e-2
LAUNCH_LOSS_ATOL = 1e-4


def _auto_mesh(data: int = 1, model: int = 1):
    """``make_host_mesh`` with Auto axes: JAX 0.9 makes Explicit axes by
    default, where the reference's ``with_sharding_constraint`` raises
    (the reference's own two red mesh tests); on one device either mesh
    places nothing."""
    n = len(jax.devices())
    data = min(data, n)
    model = max(1, min(model, n // max(data, 1)))
    return jax.make_mesh((data, model), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)


def _recording_trainer(base, rec):
    """A reference Trainer that records its initial parameters and its
    result."""
    class Recording(base):
        def init_state(self, seed=0):
            params, opt_state = super().init_state(seed)
            rec["init"] = jax.tree.map(np.asarray, params)
            return params, opt_state

        def run(self, *a, **k):
            rec["result"] = super().run(*a, **k)
            return rec["result"]
    return Recording


def _carrying_trainer(rec, out):
    """The port's Trainer with an ``init_state`` that loads the
    reference's initial weights (``rec["init"]``)."""
    class Carrying(Trainer):
        def init_state(self, seed=0):
            state = super().init_state(seed)
            self.model.load_state_dict(lm_params_from_numpy(
                rec["init"], self.model.cfg, self.model.device))
            return state

        def run(self, *a, **k):
            out["result"] = super().run(*a, **k)
            return out["result"]
    return Carrying


def _compare(name, mine, ref, atol):
    assert len(mine.losses) == len(ref.losses) > 0
    errs = np.abs(np.array(mine.losses) - np.array(ref.losses))
    print(f"{name}: {len(errs)} steps, loss {ref.losses[0]:.4f} -> "
          f"{ref.losses[-1]:.4f} (port {mine.losses[0]:.4f} -> "
          f"{mine.losses[-1]:.4f}); per-step max abs err {errs.max():.2e} "
          f"at step {int(errs.argmax())}, first step {errs[0]:.2e}")
    assert errs.max() < atol


def test_quickstart_matches_reference(tmp_path, monkeypatch, capsys):
    spec = importlib.util.spec_from_file_location(
        "reference_quickstart", ROOT / "examples" / "quickstart.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    rec, out = {}, {}
    monkeypatch.setattr(mod, "TrainConfig", lambda **kw: JTrainConfig(
        **{**kw, "checkpoint_dir": str(tmp_path / "ref")}))
    monkeypatch.setattr(mod, "Trainer", _recording_trainer(mod.Trainer, rec))
    monkeypatch.setattr(mod, "make_host_mesh", _auto_mesh)
    mod.main()
    monkeypatch.setattr(tq, "Trainer", _carrying_trainer(rec, out))
    res = tq.main(device="cpu", checkpoint_dir=str(tmp_path / "port"))
    assert res is out["result"]
    assert "quickstart OK" in capsys.readouterr().out
    assert res.resumed_from is None and res.steps_run == 120
    assert sorted(p.name for p in (tmp_path / "port").iterdir()) == [
        "step_00000050", "step_00000100"]
    with capsys.disabled():
        _compare("quickstart", res, rec["result"], QS_LOSS_ATOL)


def test_launch_train_matches_reference(tmp_path, monkeypatch, capsys):
    rec, out = {}, {}
    argv = ["--arch", "granite-3-2b", "--steps", "6", "--batch", "4",
            "--seq", "32", "--ckpt-every", "4"]
    f32 = lambda get: lambda arch: get(arch).replace(  # noqa: E731
        compute_dtype="float32")
    monkeypatch.setattr(jlaunch, "get_smoke_config",
                        f32(jlaunch.get_smoke_config))
    monkeypatch.setattr(jlaunch, "Trainer", _recording_trainer(JTrainer, rec))
    monkeypatch.setattr(jlaunch, "make_host_mesh", _auto_mesh)
    assert jlaunch.main(argv + ["--ckpt-dir", str(tmp_path / "ref")]) == 0
    monkeypatch.setattr(tlaunch, "get_smoke_config",
                        f32(tlaunch.get_smoke_config))
    monkeypatch.setattr(tlaunch, "Trainer", _carrying_trainer(rec, out))
    # no process group in the pytest worker: the launcher's world of one
    # runs in tests/test_torch_mesh_train.py, in a subprocess
    monkeypatch.setattr(tlaunch, "make_host_mesh", lambda **k: None)
    assert tlaunch.main(argv + ["--ckpt-dir", str(tmp_path / "port"),
                                "--device", "cpu"]) == 0
    assert "[train] done: 6 steps" in capsys.readouterr().out
    assert (tmp_path / "port" / "step_00000004").is_dir()
    with capsys.disabled():
        _compare("launch.train", out["result"], rec["result"],
                 LAUNCH_LOSS_ATOL)


def test_entry_points_do_not_fall_back_to_the_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is that card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tq.main(checkpoint_dir=str(tmp_path))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tlaunch.main(["--ckpt-dir", str(tmp_path)])
