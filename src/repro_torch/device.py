"""Device selection shared by the port's entry points.

Every entry point (``RdmaNode``, the services, ``incast_scenario``,
``dpi_params_from_numpy``) runs on the card unless the caller asks for
the CPU.  Without a card, a call that did not pass ``device="cpu"``
raises instead of quietly running on the host.
"""
from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means the card; ``"cpu"`` must be asked for by name, and
    so must ``"meta"`` (shapes without storage: the dry run)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port on the host")
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def to_device(a, device: torch.device, dtype=None) -> torch.Tensor:
    """Copy a numpy array onto ``device``.  Always a copy: a tensor made
    by ``torch.from_numpy`` aliases the numpy buffer, and on the CPU
    ``.to("cpu")`` would hand that alias straight back.  A read-only
    array (a view of another framework's buffer) is copied on the host
    first, since torch does not take read-only memory."""
    if isinstance(a, np.ndarray) and not a.flags.writeable:
        a = a.copy()
    t = torch.as_tensor(a)
    if dtype is not None and t.dtype != dtype:
        return t.to(device=device, dtype=dtype)
    return t.to(device=device, copy=True)
