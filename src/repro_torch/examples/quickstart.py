"""Quickstart: train a small LM end-to-end with the framework's public
API — config registry, Model, Trainer (checkpointed, resumable) — the
reference's ``examples/quickstart.py``.

  python -m repro_torch.examples.quickstart [--cpu]
"""
from __future__ import annotations

import os
import sys
import tempfile
from typing import Optional

from repro_torch.common.config import TrainConfig
from repro_torch.configs import get_smoke_config
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.model import Model
from repro_torch.train.loop import TrainResult, Trainer, lm_batch_iterator


def main(device: DeviceLike = None,
         checkpoint_dir: Optional[str] = None) -> TrainResult:
    """Train gemma2-2b's smoke config for 120 steps on a synthetic
    Markov stream on ``device`` (default the card), checkpointing into
    ``checkpoint_dir`` (default ``repro_quickstart`` in the temp
    directory; a checkpoint there is resumed); returns the result."""
    if checkpoint_dir is None:
        checkpoint_dir = os.path.join(tempfile.gettempdir(),
                                      "repro_quickstart")
    dev = resolve_device(device)
    # 1. pick an architecture from the registry (reduced config; the
    #    same ModelConfig at full size is gemma2-2b itself)
    cfg = get_smoke_config("gemma2-2b")
    print(f"arch={cfg.name}: {cfg.n_layers}L d={cfg.d_model} "
          f"pattern={cfg.pattern}")

    # 2. trainer with checkpointing + auto-resume
    tc = TrainConfig(steps=120, learning_rate=2e-3, warmup_steps=10,
                     checkpoint_every=50, log_every=20,
                     checkpoint_dir=checkpoint_dir)
    model = Model(cfg, device=dev)
    trainer = Trainer(model, tc)

    # 3. train on a synthetic Markov stream (loss should fall fast)
    res = trainer.run(lm_batch_iterator(cfg, batch=8, seq=128))
    print(f"loss: {res.losses[0]:.3f} -> {res.final_loss:.3f} "
          f"in {res.wall_s:.1f}s"
          + (f" (resumed from step {res.resumed_from})"
             if res.resumed_from else ""))
    assert res.final_loss < res.losses[0], "did not learn"
    print("quickstart OK")
    return res


if __name__ == "__main__":
    main("cpu" if "--cpu" in sys.argv[1:] else None)
