"""Block assembly: unified decoder blocks (dense / MoE / MLA / sliding /
recurrent), the layer stack, encoder-decoder support — the reference's
``repro.models.transformer``.

Where the reference scans one stacked block over ``n_blocks`` layers
(``lax.scan``), the port loops over the ``ModuleList`` that
``ParamTree`` makes of the stacked parameters, and keeps one cache dict
per block in a list.  Where the reference wraps the scan body in
``jax.checkpoint`` (``train`` and ``cfg.remat``), the port wraps each
loop step in ``torch.utils.checkpoint`` (``_remat``): the block's
activations are recomputed in the backward pass, none kept, or with
``remat_policy="dots"`` its matmul outputs kept.
"""
from __future__ import annotations

import functools
import math
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.common.config import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import params as P
from repro_torch.models import ssm
from repro_torch.models.layers import (ffn, ffn_spec, layer_norm,
                                       layer_norm_spec, rms_norm,
                                       rms_norm_spec)
from repro_torch.models.params import Spec


def _norm_spec(cfg: ModelConfig):
    return (layer_norm_spec(cfg.d_model) if cfg.norm_type == "ln"
            else rms_norm_spec(cfg.d_model))


def _norm(cfg: ModelConfig, p, x):
    return (layer_norm(p, x, cfg.norm_eps) if cfg.norm_type == "ln"
            else rms_norm(p, x, cfg.norm_eps))


# ---------------------------------------------------------------------------
# Per-block specs
# ---------------------------------------------------------------------------

def block_spec(cfg: ModelConfig, kind: str, ffn_kind: Optional[str],
               cross: bool = False) -> Dict[str, Any]:
    spec: Dict[str, Any] = {}
    if kind in ("global", "local", "enc"):
        spec["ln1"] = _norm_spec(cfg)
        spec["attn"] = attn.attn_spec(cfg, kind)
        if cfg.sandwich_norm:
            spec["post_attn"] = _norm_spec(cfg)
    elif kind == "mla":
        spec["ln1"] = _norm_spec(cfg)
        spec["attn"] = attn.mla_spec(cfg)
    elif kind == "mlstm":
        spec["ln1"] = _norm_spec(cfg)
        spec["mix"] = ssm.mlstm_block_spec(cfg)
    elif kind == "slstm":
        spec["ln1"] = _norm_spec(cfg)
        spec["mix"] = ssm.slstm_block_spec(cfg)
    elif kind == "rglru":
        spec["ln1"] = _norm_spec(cfg)
        spec["mix"] = ssm.rglru_block_spec(cfg)
    else:
        raise ValueError(kind)
    if cross:
        spec["ln_cross"] = _norm_spec(cfg)
        spec["cross"] = attn.attn_spec(cfg, "cross")
    if ffn_kind == "dense":
        spec["ln2"] = _norm_spec(cfg)
        spec["ffn"] = ffn_spec(cfg.d_model, cfg.d_ff, cfg.ffn_gated,
                               cfg.ffn_bias)
        if cfg.sandwich_norm:
            spec["post_ffn"] = _norm_spec(cfg)
    elif ffn_kind == "dense_first":
        spec["ln2"] = _norm_spec(cfg)
        spec["ffn"] = ffn_spec(cfg.d_model, cfg.dense_d_ff, cfg.ffn_gated,
                               cfg.ffn_bias)
    elif ffn_kind == "moe":
        spec["ln2"] = _norm_spec(cfg)
        spec["moe"] = moe_mod.moe_spec(cfg)
    return spec


def block_cache_spec(cfg: ModelConfig, kind: str, batch: int, max_len: int,
                     cross_len: int = 0) -> Dict[str, Any]:
    spec: Dict[str, Any] = {}
    if kind in ("global", "local"):
        spec["self"] = attn.cache_entry_spec(cfg, kind, batch, max_len)
    elif kind == "mla":
        spec["self"] = attn.cache_entry_spec(cfg, "mla", batch, max_len)
    elif kind == "mlstm":
        spec["self"] = ssm.mlstm_cache_spec(cfg, batch)
    elif kind == "slstm":
        spec["self"] = ssm.slstm_cache_spec(cfg, batch)
    elif kind == "rglru":
        spec["self"] = ssm.rglru_cache_spec(cfg, batch)
    if cross_len:
        kv, hd = cfg.n_kv_heads, cfg.resolved_head_dim
        spec["cross"] = {
            "ck": Spec((batch, cross_len, kv, hd),
                       ("batch", "kv_seq", "kv_heads", "head_dim"), "zeros"),
            "cv": Spec((batch, cross_len, kv, hd),
                       ("batch", "kv_seq", "kv_heads", "head_dim"), "zeros"),
        }
    return spec


# ---------------------------------------------------------------------------
# Per-block apply
# ---------------------------------------------------------------------------

def apply_block(
    cfg: ModelConfig,
    kind: str,
    ffn_kind: Optional[str],
    p,
    x: torch.Tensor,
    *,
    positions: torch.Tensor,
    cache: Optional[Dict[str, Any]] = None,
    cache_index: Optional[int] = None,
    enc_out: Optional[torch.Tensor] = None,
    compute_dtype=torch.bfloat16,
) -> Tuple[torch.Tensor, Optional[Dict[str, Any]],
           Tuple[torch.Tensor, torch.Tensor]]:
    """Returns (x, new_cache_entry, (aux_loss, expert_load))."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    load = torch.zeros((max(cfg.n_experts, 1),), dtype=torch.float32,
                       device=x.device)
    new_cache: Dict[str, Any] = {}
    self_cache = cache.get("self") if cache else None

    if kind in ("mlstm", "slstm"):
        x = ssm.carried(x)
    h = _norm(cfg, p["ln1"], x)
    if kind in ("global", "local", "enc"):
        y, c = attn.self_attention(
            cfg, p["attn"], h, kind=kind, positions=positions,
            cache=self_cache, cache_index=cache_index,
            compute_dtype=compute_dtype)
        if cfg.sandwich_norm:
            y = _norm(cfg, p["post_attn"], y)
    elif kind == "mla":
        y, c = attn.mla_attention(
            cfg, p["attn"], h, positions=positions, cache=self_cache,
            cache_index=cache_index, compute_dtype=compute_dtype)
    elif kind == "mlstm":
        y, c = ssm.mlstm_block(cfg, p["mix"], h, self_cache, compute_dtype)
    elif kind == "slstm":
        y, c = ssm.slstm_block(cfg, p["mix"], h, self_cache, compute_dtype)
    elif kind == "rglru":
        y, c = ssm.rglru_block(cfg, p["mix"], h, self_cache, compute_dtype)
    else:
        raise ValueError(kind)
    x = x + y
    if c is not None:
        new_cache["self"] = c

    if "cross" in p:
        h = _norm(cfg, p["ln_cross"], x)
        if cache is not None and "cross" in cache and enc_out is None:
            # decode: reuse cached cross K/V
            ck, cv = cache["cross"]["ck"], cache["cross"]["cv"]
            y = _cross_from_cache(cfg, p["cross"], h, ck, cv, compute_dtype)
            new_cache["cross"] = cache["cross"]
        else:
            y = attn.cross_attention(cfg, p["cross"], h, enc_out,
                                     compute_dtype)
            if cache is not None:
                new_cache["cross"] = {
                    "ck": attn._project(enc_out, p["cross"]["wk"],
                                        compute_dtype),
                    "cv": attn._project(enc_out, p["cross"]["wv"],
                                        compute_dtype)}
        x = x + y

    if ffn_kind in ("dense", "dense_first"):
        h = _norm(cfg, p["ln2"], x)
        y = ffn(p["ffn"], h, compute_dtype, cfg.ffn_act)
        if cfg.sandwich_norm and "post_ffn" in p:
            y = _norm(cfg, p["post_ffn"], y)
        x = x + y
    elif ffn_kind == "moe":
        h = _norm(cfg, p["ln2"], x)
        y, aux, load = moe_mod.moe_ffn(cfg, p["moe"], h, compute_dtype)
        x = x + y
    return x, (new_cache if new_cache else None), (aux, load)


def _cross_from_cache(cfg, p, x, ck, cv, compute_dtype):
    return attn.cross_attention_kv(cfg, p, x, ck, cv, compute_dtype)


# ---------------------------------------------------------------------------
# Remat
# ---------------------------------------------------------------------------

# jax.checkpoint_policies.dots_with_no_batch_dims_saveable: the products
# of a 2-D weight (torch.matmul folds the leading dims into mm/addmm);
# batched products (attention's bmm) are recomputed
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat(fn, policy: str = "nothing"):
    """``jax.checkpoint(fn, policy=...)``: ``fn``'s activations are
    recomputed in the backward pass — none kept ("nothing"), or the
    matmul outputs kept ("dots")."""
    kw = {}
    if policy == "dots":
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _save_dots)
    return functools.partial(checkpoint, fn, use_reentrant=False, **kw)


# ---------------------------------------------------------------------------
# Layer-stack layout
# ---------------------------------------------------------------------------

def _ffn_kind_for(cfg: ModelConfig, kind: str,
                  is_first_dense: bool) -> Optional[str]:
    if kind in ("mlstm", "slstm"):
        return None                       # integrated in the block
    if is_first_dense:
        return "dense_first"
    return "moe" if cfg.n_experts else "dense"


def stack_layout(cfg: ModelConfig):
    """(first_dense_kinds, scanned_pattern, tail_kinds) for the decoder."""
    first = [("mla" if cfg.use_mla else "global", "dense_first")] \
        * cfg.first_dense_layers
    pat = [(k, _ffn_kind_for(cfg, k, False)) for k in cfg.pattern]
    tail = [(k, _ffn_kind_for(cfg, k, False)) for k in cfg.tail_pattern]
    return first, pat, tail


def decoder_spec(cfg: ModelConfig, cross: bool = False):
    first, pat, tail = stack_layout(cfg)
    spec: Dict[str, Any] = {}
    for i, (k, fk) in enumerate(first):
        spec[f"first_{i}"] = block_spec(cfg, k, fk, cross)
    if cfg.n_blocks > 0:
        pat_spec = {f"sub{j}": block_spec(cfg, k, fk, cross)
                    for j, (k, fk) in enumerate(pat)}
        spec["blocks"] = P.stack(pat_spec, cfg.n_blocks)
    for i, (k, fk) in enumerate(tail):
        spec[f"tail_{i}"] = block_spec(cfg, k, fk, cross)
    return spec


def decoder_cache_spec(cfg: ModelConfig, batch: int, max_len: int,
                       cross_len: int = 0):
    first, pat, tail = stack_layout(cfg)
    spec: Dict[str, Any] = {}
    for i, (k, _) in enumerate(first):
        spec[f"first_{i}"] = block_cache_spec(cfg, k, batch, max_len,
                                              cross_len)
    if cfg.n_blocks > 0:
        pat_spec = {f"sub{j}": block_cache_spec(cfg, k, batch, max_len,
                                                cross_len)
                    for j, (k, _) in enumerate(pat)}
        spec["blocks"] = P.stack(pat_spec, cfg.n_blocks)
    for i, (k, _) in enumerate(tail):
        spec[f"tail_{i}"] = block_cache_spec(cfg, k, batch, max_len,
                                             cross_len)
    return spec


def apply_decoder(
    cfg: ModelConfig,
    params,
    x: torch.Tensor,
    *,
    positions: torch.Tensor,
    cache: Optional[Dict[str, Any]] = None,
    cache_index: Optional[int] = None,
    enc_out: Optional[torch.Tensor] = None,
    train: bool = False,
    compute_dtype=torch.bfloat16,
):
    """Runs the first-dense layers, the pattern blocks (one loop step a
    block, ``params["blocks"][i]`` and ``cache["blocks"][i]``), and the
    tail layers.

    Returns (x, new_cache, (aux_loss, expert_load))."""
    first, pat, tail = stack_layout(cfg)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    load = torch.zeros((max(cfg.n_experts, 1),), dtype=torch.float32,
                       device=x.device)
    new_cache: Dict[str, Any] = {}

    def run_block(kind, fk, p, x, c):
        return apply_block(cfg, kind, fk, p, x, positions=positions,
                           cache=c, cache_index=cache_index, enc_out=enc_out,
                           compute_dtype=compute_dtype)

    for i, (k, fk) in enumerate(first):
        c = cache.get(f"first_{i}") if cache else None
        x, nc, (a, l) = run_block(k, fk, params[f"first_{i}"], x, c)
        aux, load = aux + a, load + l
        if nc is not None:
            new_cache[f"first_{i}"] = nc

    if cfg.n_blocks > 0:
        def block_step(bp, bc, x, aux, load):
            nc_out = {}
            for j, (k, fk) in enumerate(pat):
                c = bc.get(f"sub{j}") if bc else None
                x, nc, (a, l) = run_block(k, fk, bp[f"sub{j}"], x, c)
                aux, load = aux + a, load + l
                nc_out[f"sub{j}"] = nc if nc is not None else {}
            return x, aux, load, nc_out

        step = (_remat(block_step, cfg.remat_policy)
                if train and cfg.remat else block_step)
        blocks_out: List[Dict[str, Any]] = []
        for i, bp in enumerate(params["blocks"]):
            bc = cache["blocks"][i] if cache is not None else None
            x, aux, load, nc_out = step(bp, bc, x, aux, load)
            blocks_out.append(nc_out)
        if cache is not None:
            new_cache["blocks"] = blocks_out

    for i, (k, fk) in enumerate(tail):
        c = cache.get(f"tail_{i}") if cache else None
        x, nc, (a, l) = run_block(k, fk, params[f"tail_{i}"], x, c)
        aux, load = aux + a, load + l
        if nc is not None:
            new_cache[f"tail_{i}"] = nc

    return x, (new_cache if cache is not None else None), (aux, load)


# ---------------------------------------------------------------------------
# Encoder (whisper)
# ---------------------------------------------------------------------------

def encoder_spec(cfg: ModelConfig):
    blk = block_spec(cfg, "enc", "dense")
    return {"blocks": P.stack(blk, cfg.n_encoder_layers),
            "ln_post": _norm_spec(cfg)}


def apply_encoder(cfg: ModelConfig, params, x, positions, train=False,
                  compute_dtype=torch.bfloat16):
    def body(bp, x):
        return apply_block(cfg, "enc", "dense", bp, x, positions=positions,
                           compute_dtype=compute_dtype)[0]
    fn = _remat(body) if train and cfg.remat else body   # nothing saved
    for bp in params["blocks"]:
        x = fn(bp, x)
    return _norm(cfg, params["ln_post"], x)


def _sinusoid_div(dim: int, device) -> torch.Tensor:
    return torch.exp(torch.arange(0, dim, 2, dtype=torch.float32,
                                  device=device)
                     * (-math.log(10000.0) / dim))


def sinusoidal_positions(seq: int, dim: int, dtype=torch.float32,
                         device=None) -> torch.Tensor:
    pos = torch.arange(seq, dtype=torch.float32, device=device)[:, None]
    div = _sinusoid_div(dim, device)
    pe = torch.zeros((seq, dim), dtype=torch.float32, device=device)
    pe[:, 0::2] = torch.sin(pos * div)
    pe[:, 1::2] = torch.cos(pos * div)
    return pe.to(dtype)


def sinusoidal_at(pos: int, dim: int, dtype=torch.float32,
                  device=None) -> torch.Tensor:
    """Sinusoidal embedding of one position."""
    ang = float(pos) * _sinusoid_div(dim, device)
    pe = torch.zeros((dim,), dtype=torch.float32, device=device)
    pe[0::2] = torch.sin(ang)
    pe[1::2] = torch.cos(ang)
    return pe.to(dtype)
