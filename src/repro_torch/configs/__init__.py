"""Architecture registry of the port: ``--arch <id>`` resolves here.

The ten LM architectures' ``config()`` and ``smoke_config()`` are copies
of the reference's ``repro.configs``, value for value; ``dlrm`` is the
paper's own workload (a ``DLRMConfig``)."""
from __future__ import annotations

from typing import Callable, Dict

from repro_torch.configs import (deepseek_v2_236b, deepseek_v3_671b, dlrm,
                                 gemma2_2b, gemma2_27b, gemma3_4b,
                                 granite_3_2b, qwen2_vl_72b,
                                 recurrentgemma_9b, whisper_base, xlstm_125m)

_MODULES = (
    gemma3_4b, gemma2_27b, gemma2_2b, granite_3_2b, xlstm_125m,
    whisper_base, deepseek_v3_671b, deepseek_v2_236b, qwen2_vl_72b,
    recurrentgemma_9b,
)

REGISTRY: Dict[str, Callable] = {m.ARCH_ID: m.config for m in _MODULES}
SMOKE_REGISTRY: Dict[str, Callable] = {m.ARCH_ID: m.smoke_config
                                       for m in _MODULES}
ALL_ARCHS = tuple(REGISTRY)

DLRM_CONFIG = dlrm.config
DLRM_SMOKE = dlrm.smoke_config


def get_config(arch: str):
    if arch == "dlrm":
        return dlrm.config()
    return REGISTRY[arch]()


def get_smoke_config(arch: str):
    if arch == "dlrm":
        return dlrm.smoke_config()
    return SMOKE_REGISTRY[arch]()
