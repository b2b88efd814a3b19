"""Serving launcher of the port: batched prefill + greedy decode with
the KV-cache runtime (ring caches on sliding-window layers, recurrent
states on SSM layers), as the reference's ``repro.launch.serve``.

  python -m repro_torch.launch.serve --arch gemma2-2b --full \\
      --batch 4 --prompt-len 32 --gen 16          # on the card
  python -m repro_torch.launch.serve --arch xlstm-125m --cpu
"""
from __future__ import annotations

import argparse
import time
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.configs import ALL_ARCHS, get_config, get_smoke_config
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.model import Model, lm_params_from_numpy
from repro_torch.train.step import make_decode_step, make_prefill_step

ENC_LEN = 16              # whisper: audio frames of a served request


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def prefill_batch(cfg, batch_size: int, prompt_len: int, seed: int = 0,
                  prompts: Optional[np.ndarray] = None,
                  device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """The prefill inputs ``serve_batch`` serves: ``prompts`` (numpy
    int, (batch_size, prompt_len)) or prompts drawn from a CPU generator
    seeded ``seed + 1``; audio frames (seed + 3) for an encoder-decoder;
    an empty vision stream and text M-RoPE positions for a VLM."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed + 1)
    if prompts is None:
        toks = torch.randint(0, cfg.vocab, (batch_size, prompt_len),
                             generator=gen, dtype=torch.int32)
    else:
        toks = torch.from_numpy(np.asarray(prompts, np.int32).copy())
    pre = {"tokens": toks.to(dev)}
    if cfg.is_encdec:
        audio = torch.randn((batch_size, ENC_LEN, cfg.d_model),
                            generator=torch.Generator().manual_seed(seed + 3))
        pre["audio_embed"] = audio.to(dev)
    if cfg.vision_stub:
        pre["vision_embed"] = torch.zeros((batch_size, prompt_len,
                                           cfg.d_model), device=dev)
        pre["vision_mask"] = torch.zeros((batch_size, prompt_len),
                                         dtype=torch.int32, device=dev)
        pre["mrope_pos"] = torch.arange(
            prompt_len, dtype=torch.int32, device=dev)[None, None].expand(
                3, batch_size, prompt_len)
    return pre


def serve_batch(cfg, model: Optional[Model], batch_size: int,
                prompt_len: int, gen: int, seed: int = 0, *,
                params: Optional[Dict] = None,
                prompts: Optional[np.ndarray] = None,
                device: DeviceLike = None):
    """Initialise ``model`` (or a new ``Model(cfg)``) from ``seed`` — or
    load ``params``, the reference's parameter tree as numpy arrays —
    prefill ``batch_size`` prompts of ``prompt_len`` tokens (``prompts``,
    numpy, or drawn from the seed) and decode ``gen`` tokens greedily,
    on ``device`` (default the card; a given model must be there).

    Returns (tokens (B, gen) int32 on the device, prefill seconds,
    decode seconds)."""
    dev = resolve_device(device)
    if model is None:
        model = Model(cfg, device=dev)
    elif model.device.type != dev.type or dev.index not in (
            None, model.device.index):
        raise ValueError(f"the model is on {model.device}, not on {dev}")
    if params is None:
        model.init_params(seed)
    else:
        model.load_state_dict(lm_params_from_numpy(params, cfg, dev))
    pre = prefill_batch(cfg, batch_size, prompt_len, seed, prompts, dev)
    return generate(model, pre, gen)


def generate(model: Model, pre: Dict[str, torch.Tensor], gen: int):
    """Prefill ``pre`` (``prefill_batch``'s inputs, on the model's
    device) into a fresh cache and decode ``gen`` tokens greedily — the
    serving loop of ``serve_batch``, for a model whose weights are
    already in place.

    Returns (tokens (B, gen) int32, prefill seconds, decode seconds)."""
    cfg, dev = model.cfg, model.device
    batch_size, prompt_len = pre["tokens"].shape
    cache = model.init_cache(batch_size, prompt_len + gen,
                             enc_len=ENC_LEN if cfg.is_encdec else 0)
    prefill = make_prefill_step(model)
    decode = make_decode_step(model)

    _sync(dev)
    t0 = time.perf_counter()
    logits, cache = prefill(pre, cache)
    tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]
    _sync(dev)
    t_prefill = time.perf_counter() - t0

    out = [tok]
    t0 = time.perf_counter()
    for t in range(gen - 1):
        tok, cache = decode(cache, tok, prompt_len + t)
        out.append(tok)
    _sync(dev)
    t_decode = time.perf_counter() - t0
    return torch.cat(out, dim=1), t_prefill, t_decode


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma2-2b", choices=ALL_ARCHS)
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the host (default: the card)")
    args = ap.parse_args(argv)
    dev = resolve_device("cpu" if args.cpu else None)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    tokens, t_p, t_d = serve_batch(cfg, Model(cfg, device=dev), args.batch,
                                   args.prompt_len, args.gen, device=dev)
    n_tok = tokens.shape[0] * tokens.shape[1]
    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"[serve] arch={args.arch} batch={args.batch} on {where}: "
          f"prefill={t_p*1e3:.1f}ms decode={t_d*1e3:.1f}ms "
          f"({n_tok/(t_d+1e-9):.0f} tok/s)")
    print(f"[serve] sample tokens: {tokens[0][:8].tolist()}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
