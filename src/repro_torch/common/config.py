"""Model configurations of the port.

Only ``DLRMConfig`` is here so far: a copy of the reference's
``repro.common.config.DLRMConfig`` (the port imports nothing of
``repro``), field for field.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple


@dataclass(frozen=True)
class DLRMConfig:
    """The paper's own workload (§8): DLRM behind the BALBOA service chain."""

    name: str = "dlrm"
    n_dense: int = 13               # Criteo-like dense feature count
    n_sparse: int = 26              # sparse (categorical) feature count
    embed_rows: int = 100_000       # rows per embedding table (after Modulus)
    embed_dim: int = 64
    bottom_mlp: Tuple[int, ...] = (512, 256, 64)
    top_mlp: Tuple[int, ...] = (512, 256, 1)
    modulus: int = 100_000          # paper §8.1 Modulus operator range
    param_dtype: str = "float32"
    compute_dtype: str = "float32"
