"""Write the port's DPI parameter fixture from the JAX reference.

``chip_smoke.py`` cannot import JAX, so it loads the ternary DPI
parameters from ``src/repro_torch/data/dpi_params_seed0.npz``: the
reference's ``train_dpi_params(*make_dataset(2048, seed=0), steps=200)``,
the model ``examples/secure_flow.py`` trains.  Regenerate with

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/make_dpi_fixture.py
"""
from pathlib import Path

import numpy as np

from repro.data.dpi_dataset import make_dataset
from repro.kernels.dpi_mlp import train_dpi_params

FIXTURE = (Path(__file__).resolve().parents[1] / "src" / "repro_torch"
           / "data" / "dpi_params_seed0.npz")


def reference_params() -> dict:
    params = train_dpi_params(*make_dataset(2048, seed=0), steps=200)
    return {k: np.asarray(v) for k, v in params.items()}


if __name__ == "__main__":
    np.savez(FIXTURE, **reference_params())
    print(f"wrote {FIXTURE}")
