"""Batched serving example: prefill a batch of prompts, decode with the
KV-cache runtime (ring caches on sliding-window layers, recurrent states
on SSM layers), greedy sampling — the reference's ``examples/serve.py``
for gemma2-2b, xlstm-125m and recurrentgemma-9b at smoke size.

  python -m repro_torch.examples.serve [--cpu]
"""
from __future__ import annotations

import sys
from typing import Dict

from repro_torch.configs import get_smoke_config
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.launch.serve import serve_batch

ARCHS = ("gemma2-2b", "xlstm-125m", "recurrentgemma-9b")


def main(device: DeviceLike = None) -> Dict:
    """Serve 4 prompts of 32 tokens, 16 new tokens each, for every arch
    of ``ARCHS`` on ``device`` (default the card).  Returns each arch's
    tokens (on the host) and times."""
    dev = resolve_device(device)
    out = {}
    for arch in ARCHS:
        cfg = get_smoke_config(arch)
        tokens, t_p, t_d = serve_batch(cfg, None, batch_size=4,
                                       prompt_len=32, gen=16, device=dev)
        out[arch] = {"tokens": tokens.cpu(), "prefill_s": t_p,
                     "decode_s": t_d}
        print(f"[serve] {arch:18s} prefill {t_p*1e3:7.1f}ms  "
              f"decode {t_d*1e3:7.1f}ms  "
              f"sample={tokens[0][:6].tolist()}")
    print("serve OK")
    return out


if __name__ == "__main__":
    main("cpu" if "--cpu" in sys.argv[1:] else None)
