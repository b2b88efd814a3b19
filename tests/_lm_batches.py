"""Numpy-seeded LM inputs shared by the port's LM tests (the CPU
differential tests and the card tests); JAX-free, so the card machine,
which has no JAX, imports it too."""
from __future__ import annotations

from typing import Dict

import numpy as np

from repro_torch.launch.serve import ENC_LEN  # whisper: audio frames


def lm_batch(cfg, b: int, s: int, seed: int = 0,
             vision: bool = True) -> Dict[str, np.ndarray]:
    """Tokens, next-token targets and the stub streams ``cfg`` needs:
    audio frames for an encoder-decoder; for a VLM a vision stream mixed
    into about half the positions and M-RoPE positions whose three
    streams differ (t, t // 2, t % 5) — or, with ``vision=False``, text
    only (no vision position, the three streams all t), which is what a
    decode step continues."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
    batch = {"tokens": toks, "targets": np.roll(toks, -1, axis=1)}
    if cfg.is_encdec:
        batch["audio_embed"] = rng.standard_normal(
            (b, ENC_LEN, cfg.d_model)).astype(np.float32)
    if cfg.vision_stub:
        batch["vision_embed"] = rng.standard_normal(
            (b, s, cfg.d_model)).astype(np.float32)
        batch["vision_mask"] = (rng.random((b, s)) > 0.5).astype(np.int32)
        t = np.arange(s)
        pos = np.stack([t, t // 2, t % 5]).astype(np.int32)
        if not vision:
            batch["vision_mask"][:] = 0
            pos = np.stack([t, t, t]).astype(np.int32)
        batch["mrope_pos"] = np.ascontiguousarray(
            np.broadcast_to(pos[:, None], (3, b, s)))
    return batch


def prompt_of(batch: Dict[str, np.ndarray], s: int) -> Dict[str, np.ndarray]:
    """The first ``s`` positions of ``batch`` as prefill inputs (no
    targets; the audio frames whole)."""
    out = {}
    for k, v in batch.items():
        if k == "targets":
            continue
        if k == "mrope_pos":
            out[k] = np.ascontiguousarray(v[:, :, :s])
        elif k == "audio_embed":
            out[k] = v
        else:
            out[k] = np.ascontiguousarray(v[:, :s])
    return out
