"""Attention variants: GQA (full / sliding-window / bidirectional / cross),
logit softcaps, qk-norm, RoPE / M-RoPE, MLA (DeepSeek) with absorbed
decode, and KV caches (contiguous for global layers, a phase-aligned ring
for sliding-window layers, int8 with per-slot scales, compressed latents
for MLA) — the reference's ``repro.models.attention``, function for
function.

Scores are float32 whatever the compute dtype (the reference's
``preferred_element_type=float32``: bf16 products summed in float32);
the probabilities are cast back to the value dtype before the value
product.  Masked scores take ``NEG_INF``, a large finite negative, so a
row with no valid key stays finite.

Caches are dicts of tensors.  A prefill returns new cache tensors; a
decode step writes its one new entry into the cache's tensors in place
and returns that cache (the reference's serving loop donates the cache
to the same effect).
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.common.config import ModelConfig
from repro_torch.models.layers import apply_mrope, apply_rope, rms_norm, softcap
from repro_torch.models.params import Spec
from repro_torch.parallel.sharding import (constrain, product_as,
                                           rows_split_as, set_slot)

NEG_INF = -2.3819763e38  # large negative for bf16-safe masking


# ---------------------------------------------------------------------------
# Specs
# ---------------------------------------------------------------------------

def attn_spec(cfg: ModelConfig, kind: str = "global"):
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    spec = {
        "wq": Spec((d, h, hd), ("embed", "heads", "head_dim")),
        "wk": Spec((d, kv, hd), ("embed", "kv_heads", "head_dim")),
        "wv": Spec((d, kv, hd), ("embed", "kv_heads", "head_dim")),
        "wo": Spec((h, hd, d), ("heads", "head_dim", "embed")),
    }
    if cfg.use_qk_norm:
        spec["q_norm"] = Spec((hd,), (None,), "zeros")
        spec["k_norm"] = Spec((hd,), (None,), "zeros")
    return spec


def mla_spec(cfg: ModelConfig):
    d, h = cfg.d_model, cfg.n_heads
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    kvr, qr = cfg.kv_lora_rank, cfg.q_lora_rank
    spec = {
        "wkv_a": Spec((d, kvr + dr), ("embed", "lora")),
        "kv_norm": Spec((kvr,), (None,), "zeros"),
        "wkv_b": Spec((kvr, h, dn + dv), ("lora", "heads", "head_dim")),
        "wo": Spec((h, dv, d), ("heads", "head_dim", "embed")),
    }
    if qr:
        spec["wq_a"] = Spec((d, qr), ("embed", "lora"))
        spec["q_norm"] = Spec((qr,), (None,), "zeros")
        spec["wq_b"] = Spec((qr, h, dn + dr), ("lora", "heads", "head_dim"))
    else:
        spec["wq"] = Spec((d, h, dn + dr), ("embed", "heads", "head_dim"))
    return spec


# ---------------------------------------------------------------------------
# Cache specs (per layer-kind)
# ---------------------------------------------------------------------------

def cache_entry_spec(cfg: ModelConfig, kind: str, batch: int, max_len: int):
    kv, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    if kind == "mla":
        return {
            "ckv": Spec((batch, max_len, cfg.kv_lora_rank),
                        ("batch", "cache_seq", None), "zeros"),
            "kpe": Spec((batch, max_len, cfg.qk_rope_head_dim),
                        ("batch", "cache_seq", None), "zeros"),
        }
    length = min(max_len, cfg.sliding_window) if kind == "local" else max_len
    kv_dtype = "int8" if cfg.kv_cache_quant else None
    spec = {
        "k": Spec((batch, length, kv, hd),
                  ("batch", "cache_seq", "kv_heads", "head_dim"), "zeros",
                  dtype=kv_dtype),
        "v": Spec((batch, length, kv, hd),
                  ("batch", "cache_seq", "kv_heads", "head_dim"), "zeros",
                  dtype=kv_dtype),
        # absolute positions of each slot; -1 = empty (masks padding)
        "pos": Spec((batch, length), ("batch", "cache_seq"), "zeros",
                    dtype="int32"),
    }
    if cfg.kv_cache_quant:
        # per-(slot, head) symmetric scales
        spec["k_scale"] = Spec((batch, length, kv),
                               ("batch", "cache_seq", "kv_heads"), "zeros",
                               dtype="float32")
        spec["v_scale"] = Spec((batch, length, kv),
                               ("batch", "cache_seq", "kv_heads"), "zeros",
                               dtype="float32")
    return spec


def _quant_kv(x: torch.Tensor):
    """(..., KV, D) -> int8 values + per-(.., KV) scale."""
    amax = torch.amax(torch.abs(x.float()), dim=-1)
    scale = torch.clamp_min(amax, 1e-6) / 127.0
    q = torch.round(x.float() / scale[..., None])
    return torch.clamp(q, -127, 127).to(torch.int8), scale


def _dequant_kv(q: torch.Tensor, scale: torch.Tensor, dtype):
    return (q.float() * scale[..., None].float()).to(dtype)


# ---------------------------------------------------------------------------
# Core dot-product attention (naive and chunked online-softmax)
# ---------------------------------------------------------------------------

def _build_mask(qpos, kpos, causal: bool, window: int) -> torch.Tensor:
    """(.., S, T) boolean mask from absolute positions.

    qpos: (B, S) or (S,);  kpos: (B, T) or (T,).  -1 in kpos = invalid slot.
    """
    q = qpos[..., :, None]
    k = kpos[..., None, :]
    mask = k >= 0
    if causal:
        mask = mask & (k <= q)
    if window > 0:
        mask = mask & (k > q - window)
    return mask


def _scores(qh: torch.Tensor, k: torch.Tensor, scale: float, cap: float
            ) -> torch.Tensor:
    """(B,S,KV,G,D) x (B,T,KV,D) -> (B,KV,S,G,T) float32, softcapped."""
    sc = torch.einsum("bsngd,btnd->bnsgt", qh.float(), k.float()) * scale
    return softcap(sc, cap)


def _dot_attention(
    q: torch.Tensor,         # (B, S, H, D)
    k: torch.Tensor,         # (B, T, KV, D)
    v: torch.Tensor,         # (B, T, KV, Dv)
    mask: torch.Tensor,      # broadcastable to (B, 1, 1, S, T)
    scale: float,
    cap: float,
    impl: str = "naive",
    chunk: int = 1024,
) -> torch.Tensor:
    b, s, h, d = q.shape
    t, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    qh = q.reshape(b, s, kvh, g, d)
    while mask.dim() < 5:
        mask = mask[:, None] if mask.dim() >= 2 else mask[None]
    if impl == "chunked" and t > chunk and t % chunk == 0:
        return _dot_attention_chunked(qh, k, v, mask, scale, cap, chunk
                                      ).reshape(b, s, h, v.shape[-1])
    scores = _scores(qh, k, scale, cap)
    # scores: (B, KV, S, G, T); mask: (B,1,1,S,T) -> align as (B,1,S,1,T).
    scores = torch.where(mask.transpose(2, 3), scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    # the output projection takes the heads as the queries hold them
    out = product_as(qh, torch.einsum, "bnsgt,btnd->bsngd", probs, v)
    return out.reshape(b, s, h, v.shape[-1])


def _dot_attention_chunked(qh, k, v, mask, scale, cap, chunk):
    """Online-softmax (flash-style) attention over KV chunks.

    qh: (B,S,KV,G,D); mask: (B,1,1,S,T).  Returns (B,S,KV,G,Dv).
    """
    b, s, kvh, g, d = qh.shape
    t = k.shape[1]
    dv = v.shape[-1]
    maskc = mask.expand(b, 1, 1, s, t)
    m_run = torch.full((b, kvh, s, g), NEG_INF, dtype=torch.float32,
                       device=qh.device)
    l_run = torch.zeros((b, kvh, s, g), dtype=torch.float32,
                        device=qh.device)
    acc = torch.zeros((b, kvh, s, g, dv), dtype=v.dtype, device=qh.device)
    for c0 in range(0, t, chunk):
        kb, vb = k[:, c0:c0 + chunk], v[:, c0:c0 + chunk]
        mb = maskc[..., c0:c0 + chunk]
        sc = _scores(qh, kb, scale, cap)
        sc = torch.where(mb.transpose(2, 3), sc, NEG_INF)
        m_new = torch.maximum(m_run, torch.amax(sc, dim=-1))
        p = torch.exp(sc - m_new[..., None])
        alpha = torch.exp(m_run - m_new)
        l_run = l_run * alpha + torch.sum(p, dim=-1)
        pv = torch.einsum("bnsgt,btnd->bnsgd", p.to(vb.dtype), vb)
        acc = acc * alpha[..., None].to(acc.dtype) + pv
        m_run = m_new
    out = acc / torch.clamp_min(l_run, 1e-37)[..., None].to(acc.dtype)
    return out.permute(0, 2, 1, 3, 4)                 # (B,S,KV,G,Dv)


def _sliding_attention_blocked(
    q: torch.Tensor,         # (B, S, H, D)
    k: torch.Tensor,         # (B, S, KV, D)
    v: torch.Tensor,         # (B, S, KV, Dv)
    qpos: torch.Tensor,      # (B, S)
    window: int,
    scale: float,
    cap: float,
    block_q: int = 2048,
) -> torch.Tensor:
    """Sliding-window attention in query blocks: block i attends only to
    the KV slice [i*bq - window, i*bq + bq) — O(S * (window + bq))
    compute and score memory instead of O(S^2)."""
    b, s, h, d = q.shape
    bq = min(block_q, window, s)
    while s % bq != 0:
        bq //= 2
    span = window + bq
    kp = F.pad(k, (0, 0, 0, 0, window, 0))
    vp = F.pad(v, (0, 0, 0, 0, window, 0))
    pp = F.pad(qpos, (window, 0), value=-1)
    outs = []
    for q0 in range(0, s, bq):
        qpi = qpos[:, q0:q0 + bq]
        mask = _build_mask(qpi, pp[:, q0:q0 + span], True, window)
        outs.append(_dot_attention(q[:, q0:q0 + bq], kp[:, q0:q0 + span],
                                   vp[:, q0:q0 + span], mask[:, None, None],
                                   scale, cap, "naive"))
    return torch.cat(outs, dim=1)


# ---------------------------------------------------------------------------
# GQA self-attention (full-seq and cached-decode)
# ---------------------------------------------------------------------------

def _project(x, w, compute_dtype):
    """(B,S,d) x (d,H,K) -> (B,S,H,K)."""
    return torch.einsum("bsd,dhk->bshk", x, w.to(compute_dtype))


def _out_proj(out, w, compute_dtype):
    """(B,S,H,K) x (H,K,d) -> (B,S,d)."""
    return torch.einsum("bshk,hkd->bsd", out, w.to(compute_dtype))


def _project_qkv(cfg, p, x, positions, theta, compute_dtype):
    q = _project(x, p["wq"], compute_dtype)
    k = _project(x, p["wk"], compute_dtype)
    v = _project(x, p["wv"], compute_dtype)
    if cfg.use_qk_norm:
        q = rms_norm({"scale": p["q_norm"]}, q, cfg.norm_eps)
        k = rms_norm({"scale": p["k_norm"]}, k, cfg.norm_eps)
    if cfg.mrope_sections != (0, 0, 0) and positions.dim() == 3:
        q = apply_mrope(q, positions, theta, cfg.mrope_sections)
        k = apply_mrope(k, positions, theta, cfg.mrope_sections)
    else:
        pos2d = positions if positions.dim() == 2 else positions[0]
        q = apply_rope(q, pos2d, theta)
        k = apply_rope(k, pos2d, theta)
    q = constrain(q, "batch", "seq", "heads", "head_dim")
    k = constrain(k, "batch", "seq", "kv_heads", "head_dim")
    v = constrain(v, "batch", "seq", "kv_heads", "head_dim")
    return q, k, v


def _ring_window(t: torch.Tensor, length: int, fill=0) -> torch.Tensor:
    """A prefill's (B, S, ...) keys/values/positions as the (B, length,
    ...) ring: the last ``length`` positions rolled by ``S % length``
    (so that decode's slot ``pos % length`` overwrites the oldest), or
    padded with ``fill`` to ``length``."""
    s = t.shape[1]
    if s >= length:
        return torch.roll(t[:, -length:], s % length, dims=1)
    pad = [0, 0] * (t.dim() - 2) + [0, length - s]
    return F.pad(t, pad, value=fill)


def self_attention(
    cfg: ModelConfig,
    p,
    x: torch.Tensor,                  # (B, S, d_model)
    *,
    kind: str,                        # "global" | "local" | "enc"
    positions: torch.Tensor,          # (B,S) or (3,B,S) int32
    cache: Optional[dict] = None,
    cache_index: Optional[int] = None,   # decode position
    compute_dtype=torch.bfloat16,
) -> Tuple[torch.Tensor, Optional[dict]]:
    theta = cfg.rope_theta
    if kind == "global" and cfg.rope_theta_global:
        theta = cfg.rope_theta_global
    window = cfg.sliding_window if kind == "local" else 0
    causal = kind != "enc"
    hd = cfg.resolved_head_dim
    scale = 1.0 / math.sqrt(hd)

    # the cache takes the positions as given; the rotations and the mask
    # take them split like the rows they meet
    whole = positions if positions.dim() == 2 else positions[0]
    positions = rows_split_as(positions, x, positions.dim() - 2)
    q, k, v = _project_qkv(cfg, p, x, positions, theta, compute_dtype)
    s = x.shape[1]
    pos2d = positions if positions.dim() == 2 else positions[0]

    new_cache = None
    use_blocked = (kind == "local" and cfg.attn_impl == "blocked"
                   and s > window and s > 1)
    k_att, v_att = k, v
    if cache is None:
        mask = _build_mask(pos2d, pos2d, causal, window)
    elif s > 1:
        # prefill: fill the cache.  Local (ring) caches keep the last
        # ``window`` positions, phase-aligned with decode's slots.
        length = cache["k"].shape[1]
        k_w, v_w = _ring_window(k, length), _ring_window(v, length)
        p_w = _ring_window(whole, length, fill=-1).to(torch.int32)
        if cfg.kv_cache_quant:
            kq, ks = _quant_kv(k_w)
            vq, vs = _quant_kv(v_w)
            new_cache = {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs,
                         "pos": p_w}
        else:
            new_cache = {"k": k_w.to(cache["k"].dtype),
                         "v": v_w.to(cache["v"].dtype), "pos": p_w}
        mask = _build_mask(pos2d, pos2d, causal, window)
    else:
        # decode: write the new KV into its ring slot, in place
        slot = int(cache_index) % cache["k"].shape[1]
        if cfg.kv_cache_quant:
            kq, ks = _quant_kv(k)
            vq, vs = _quant_kv(v)
            for name, t in (("k", kq), ("v", vq), ("k_scale", ks),
                            ("v_scale", vs)):
                set_slot(cache[name], 1, slot, t)
            k_att = _dequant_kv(cache["k"], cache["k_scale"], k.dtype)
            v_att = _dequant_kv(cache["v"], cache["v_scale"], v.dtype)
        else:
            set_slot(cache["k"], 1, slot, k)
            set_slot(cache["v"], 1, slot, v)
            for name in ("k", "v"):
                constrain(cache[name], "batch", "cache_seq", "kv_heads",
                          "head_dim")
            k_att, v_att = cache["k"], cache["v"]
        set_slot(cache["pos"], 1, slot, whole.to(torch.int32))
        new_cache = cache
        mask = _build_mask(pos2d, cache["pos"], causal, window)

    if use_blocked and k_att is k:
        out = _sliding_attention_blocked(q, k, v, pos2d, window, scale,
                                         cfg.attn_softcap)
    else:
        mask = mask[:, None, None] if mask.dim() == 3 \
            else mask[None, None, None]
        out = _dot_attention(q, k_att, v_att, mask, scale, cfg.attn_softcap,
                             "naive" if cfg.attn_impl == "blocked"
                             else cfg.attn_impl, cfg.attn_chunk)
    out = constrain(out, "batch", "seq", "heads", "head_dim")
    y = _out_proj(out, p["wo"], compute_dtype)
    return constrain(y, "batch", "seq", "d_model"), new_cache


def cross_attention(
    cfg: ModelConfig, p, x: torch.Tensor, kv_src: torch.Tensor,
    compute_dtype=torch.bfloat16,
) -> torch.Tensor:
    """Encoder-decoder cross attention (no positions, no mask)."""
    k = _project(kv_src, p["wk"], compute_dtype)
    v = _project(kv_src, p["wv"], compute_dtype)
    return cross_attention_kv(cfg, p, x, k, v, compute_dtype)


def cross_attention_kv(cfg: ModelConfig, p, x: torch.Tensor,
                       k: torch.Tensor, v: torch.Tensor,
                       compute_dtype=torch.bfloat16) -> torch.Tensor:
    """Cross attention on projected (or cached) keys and values."""
    scale = 1.0 / math.sqrt(cfg.resolved_head_dim)
    q = _project(x, p["wq"], compute_dtype)
    mask = torch.ones((1, 1, 1, x.shape[1], k.shape[1]), dtype=torch.bool,
                      device=x.device)
    out = _dot_attention(q, k, v, mask, scale, 0.0, cfg.attn_impl,
                         cfg.attn_chunk)
    return _out_proj(out, p["wo"], compute_dtype)


# ---------------------------------------------------------------------------
# MLA — multi-head latent attention (DeepSeek V2/V3)
# ---------------------------------------------------------------------------

def _mla_queries(cfg, p, x, pos2d, compute_dtype):
    dn = cfg.qk_nope_head_dim
    if cfg.q_lora_rank:
        cq = torch.matmul(x, p["wq_a"].to(compute_dtype))
        cq = rms_norm({"scale": p["q_norm"]}, cq, cfg.norm_eps)
        q = torch.einsum("bsr,rhk->bshk", cq, p["wq_b"].to(compute_dtype))
    else:
        q = _project(x, p["wq"], compute_dtype)
    q_nope, q_pe = q[..., :dn], q[..., dn:]
    q_pe = apply_rope(q_pe, pos2d, cfg.rope_theta)
    return q_nope, q_pe


def mla_attention(
    cfg: ModelConfig, p, x: torch.Tensor, *,
    positions: torch.Tensor,
    cache: Optional[dict] = None,
    cache_index: Optional[int] = None,
    compute_dtype=torch.bfloat16,
) -> Tuple[torch.Tensor, Optional[dict]]:
    dn, dr = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    kvr, h = cfg.kv_lora_rank, cfg.n_heads
    scale = 1.0 / math.sqrt(dn + dr)
    b, s, _ = x.shape
    pos2d = rows_split_as(positions if positions.dim() == 2
                          else positions[0], x)

    q_nope, q_pe = _mla_queries(cfg, p, x, pos2d, compute_dtype)
    ckv_full = torch.matmul(x, p["wkv_a"].to(compute_dtype))
    ckv, k_pe = ckv_full[..., :kvr], ckv_full[..., kvr:]
    ckv = rms_norm({"scale": p["kv_norm"]}, ckv, cfg.norm_eps)
    k_pe = apply_rope(k_pe[:, :, None, :], pos2d, cfg.rope_theta)[:, :, 0, :]

    wkv_b = p["wkv_b"].to(compute_dtype)          # (kvr, H, dn+dv)
    wk_b, wv_b = wkv_b[..., :dn], wkv_b[..., dn:]

    if cache is not None and s == 1:
        # ---- absorbed decode on the compressed latent cache, in place ----
        length = cache["ckv"].shape[1]
        idx = int(cache_index)
        set_slot(cache["ckv"], 1, idx, ckv)
        set_slot(cache["kpe"], 1, idx, k_pe)
        constrain(cache["ckv"], "batch", "cache_seq", None)
        constrain(cache["kpe"], "batch", "cache_seq", None)
        new_cache = cache
        ckv_c = cache["ckv"].to(compute_dtype)
        kpe_c = cache["kpe"].to(compute_dtype)
        # absorb wk_b into the query:  (B,1,H,dn) x (kvr,H,dn) -> (B,1,H,kvr)
        q_lat = torch.einsum("bshk,rhk->bshr", q_nope, wk_b)
        sc = (torch.einsum("bshr,btr->bhst", q_lat.float(), ckv_c.float())
              + torch.einsum("bshk,btk->bhst", q_pe.float(), kpe_c.float())
              ) * scale
        valid = torch.arange(length, device=x.device) <= idx
        sc = torch.where(valid, sc, NEG_INF)
        probs = torch.softmax(sc, dim=-1).to(compute_dtype)
        ctx_lat = torch.einsum("bhst,btr->bshr", probs, ckv_c)
        out = torch.einsum("bshr,rhv->bshv", ctx_lat, wv_b)
    else:
        # ---- train / prefill: expand latents, standard attention ---------
        k_nope = torch.einsum("bsr,rhk->bshk", ckv, wk_b)
        val = torch.einsum("bsr,rhv->bshv", ckv, wv_b)
        k = torch.cat([k_nope, k_pe[:, :, None, :].expand(b, s, h, dr)],
                      dim=-1)
        q = torch.cat([q_nope, q_pe], dim=-1)
        q = constrain(q, "batch", "seq", "heads", "head_dim")
        k = constrain(k, "batch", "seq", "heads", "head_dim")
        mask = _build_mask(pos2d, pos2d, True, 0)[:, None, None]
        out = _dot_attention(q, k, val, mask, scale, 0.0, cfg.attn_impl,
                             cfg.attn_chunk)
        new_cache = None
        if cache is not None:
            pad = cache["ckv"].shape[1] - s
            new_cache = {
                "ckv": F.pad(ckv, (0, 0, 0, pad)).to(cache["ckv"].dtype),
                "kpe": F.pad(k_pe, (0, 0, 0, pad)).to(cache["kpe"].dtype)}
    out = constrain(out, "batch", "seq", "heads", "head_dim")
    y = torch.einsum("bshv,hvd->bsd", out, p["wo"].to(compute_dtype))
    return constrain(y, "batch", "seq", "d_model"), new_cache
