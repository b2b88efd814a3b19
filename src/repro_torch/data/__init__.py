"""Synthetic DPI data, synthetic DLRM records (``synthetic``) and the
committed DPI parameter fixture."""
from pathlib import Path
from typing import Dict

import numpy as np

# the reference's train_dpi_params(*make_dataset(2048, seed=0), steps=200)
# (the model examples/secure_flow.py trains), written by
# tests/make_dpi_fixture.py
DPI_PARAMS_SEED0 = Path(__file__).with_name("dpi_params_seed0.npz")


def load_dpi_params_seed0() -> Dict[str, np.ndarray]:
    with np.load(DPI_PARAMS_SEED0) as f:
        return {k: f[k] for k in f.files}
