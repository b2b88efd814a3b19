"""Step builders of the port: the serving half of the reference's
``repro.train.step`` (``make_prefill_step``, ``make_decode_step``).
The train step comes with the optimizers.

The model holds its parameters, so a step takes the batch and the cache
(the reference's steps take the parameter tree first)."""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.models.model import Model


def make_prefill_step(model: Model) -> Callable:
    def prefill_step(batch, cache):
        logits, new_cache = model.prefill(batch, cache)
        return logits, new_cache
    return prefill_step


def make_decode_step(model: Model) -> Callable:
    def decode_step(cache, tokens: torch.Tensor, index: int):
        logits, new_cache = model.decode_step(cache, tokens, index)
        # greedy next token (serving returns tokens, not logits, to keep
        # the host <-> device traffic at O(batch))
        next_tok = torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)
        return next_tok[:, None], new_cache
    return decode_step
