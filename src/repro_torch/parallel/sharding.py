"""Logical-axis placement, as far as the models call it on one card.

The reference (``repro.parallel.sharding``) resolves logical axis names
("batch", "heads", "expert", ...) to a device mesh through rule tables
and constrains tensors to them.  The port runs on one card so far: no
mesh is active, so ``constrain`` leaves a tensor where it is and
``active_mesh`` is ``None``, which sends the MoE down the reference's
own no-mesh path.  The rule tables come with multi-device placement.
"""
from __future__ import annotations

from typing import Optional

import torch


def active_mesh() -> None:
    """The device mesh in use: none on one card."""
    return None


def constrain(x: torch.Tensor, *names: Optional[str]) -> torch.Tensor:
    """Place ``x`` by the logical names of its dims: the identity while
    no mesh is active."""
    return x
