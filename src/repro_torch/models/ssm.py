"""Recurrent sequence mixers: xLSTM (mLSTM + sLSTM) and Griffin RG-LRU —
the reference's ``repro.models.ssm``.

mLSTM   — matrix-memory LSTM in the chunkwise-parallel stabilized form
          (intra-chunk quadratic + inter-chunk recurrent state), plus an
          O(1) recurrent step for decode.
sLSTM   — scalar-memory LSTM with exponential gating and a normalizer
          state; sequential over time.
RG-LRU  — real-gated linear recurrent unit; a log-depth parallel scan
          over time (the reference's ``lax.associative_scan`` adds in
          another tree order, so the two agree to float32 rounding), an
          O(1) decode step.
"""
from __future__ import annotations

import contextlib
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.common.config import ModelConfig
from repro_torch.models.layers import gelu
from repro_torch.models.params import Spec
from repro_torch.parallel.sharding import (carried_grads, constrain,
                                           is_distributed, laid_out_as,
                                           lookup_by_table, product_as,
                                           reduced_by_heads, replicated_on)


# ---------------------------------------------------------------------------
# Depthwise causal conv1d (width w) — shift-and-add form
# ---------------------------------------------------------------------------

def conv1d_spec(width: int, dim: int):
    return {"w": Spec((width, dim), (None, "d_ff")),
            "b": Spec((dim,), ("d_ff",), "zeros")}


def causal_conv1d(params, x: torch.Tensor,
                  state: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """x: (B, S, D). state: (B, w-1, D) trailing inputs from the past."""
    w = params["w"].shape[0]
    wts = params["w"].to(x.dtype)
    if state is not None:
        xin = torch.cat([state.to(x.dtype), x], dim=1)
    else:
        xin = F.pad(x, (0, 0, w - 1, 0))
    s = x.shape[1]
    y = torch.zeros_like(x)
    for j in range(w):
        y = y + xin[:, j:j + s, :] * wts[w - 1 - j][None, None, :]
    y = y + params["b"].to(x.dtype)
    new_state = xin[:, -(w - 1):, :] if state is not None else None
    return y, new_state


def carried(x: torch.Tensor, like: Optional[torch.Tensor] = None
            ) -> torch.Tensor:
    """The residual of an xLSTM stack, or an sLSTM scan's state, as the
    reference's partition carries it from layer to layer or step to
    step: its last dim (d_model) split over the axis that splits the
    sLSTM conv's channels and each gate's block (a slice).  A plain
    tensor as it is, but one that joins a placed ``like`` (the scan's
    zero state beside the placed step's inputs), placed first."""
    if like is not None and is_distributed(like) and not is_distributed(x):
        x = replicated_on(x, like.device_mesh)
    if is_distributed(x):
        x = constrain(x, "batch", *([None] * (x.ndim - 2)), "embed_tp")
    return x


def embedding_layout(cfg: ModelConfig):
    """The context an xLSTM stack's embedding lookup runs in: the table
    taken to the tokens (``sharding.lookup_by_table``), so that the
    lookup leaves the residual split as ``carried`` carries it.  A
    no-op context for any other stack, and outside the dry run."""
    if any(k in ("mlstm", "slstm") for k in cfg.pattern):
        return lookup_by_table()
    return contextlib.nullcontext()


# ===========================================================================
# mLSTM
# ===========================================================================

def mlstm_block_spec(cfg: ModelConfig):
    d = cfg.d_model
    inner = 2 * d                       # projection factor 2 (xLSTM paper)
    nh = cfg.n_heads
    return {
        "w_up": Spec((d, 2 * inner), ("embed", "d_ff")),
        "conv": conv1d_spec(cfg.conv_width, inner),
        "wq": Spec((inner, inner), ("d_ff", None)),
        "wk": Spec((inner, inner), ("d_ff", None)),
        "wv": Spec((inner, inner), ("d_ff", None)),
        "w_if": Spec((inner, 2 * nh), ("d_ff", None)),
        "b_if": Spec((2 * nh,), (None,), "zeros"),
        "gn_scale": Spec((inner,), (None,), "ones"),
        "w_down": Spec((inner, d), ("d_ff", "embed")),
    }


def _mlstm_chunkwise(q, k, v, ig, fg, chunk: int, state=None):
    """Chunkwise-parallel stabilized mLSTM.

    q,k,v: (B, H, S, dh); ig, fg: (B, H, S) gate pre-activations.
    state: optional (C, n, m) = ((B,H,dh,dh), (B,H,dh), (B,H)).
    Returns h: (B,H,S,dh) and final state.
    """
    b, h, s, dh = q.shape
    q = q * (1.0 / math.sqrt(dh))
    if s % chunk != 0:
        chunk = s                                  # single chunk fallback
    dev = q.device
    if state is None:
        C = torch.zeros((b, h, dh, dh), dtype=torch.float32, device=dev)
        n = torch.zeros((b, h, dh), dtype=torch.float32, device=dev)
        # with C0 = n0 = 0 the initial stabilizer value is irrelevant;
        # 0 avoids extreme exponents
        m = torch.zeros((b, h), dtype=torch.float32, device=dev)
        if is_distributed(q):
            # the scan's carry laid out as its step leaves it (the
            # reference's C: the heads and the value dim split)
            C = laid_out_as(C, "bhsd,bhse->bhde", k, v)
            n = laid_out_as(n, "bhsd->bhd", k)
            m = laid_out_as(m, "bhs->bh", ig)
        if (is_distributed(q) or q.is_meta) and torch.is_grad_enabled():
            # the chunk's state comes from the chunk before: its
            # gradient flows on (the reference's scan computes it), and
            # the one chunk the dry run walks keeps what a later chunk
            # of the loop keeps for it
            C, n, m = (t.requires_grad_() for t in (C, n, m))
    else:
        C, n, m = [x.float() for x in state]

    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                device=dev))

    def step(c0, C, n, m):
        qb, kb, vb = (t[:, :, c0:c0 + chunk].float() for t in (q, k, v))
        ib, fb = (t[:, :, c0:c0 + chunk].float() for t in (ig, fg))
        logf = F.logsigmoid(fb)                   # (B,H,L)
        bcum = torch.cumsum(logf, dim=-1)         # inclusive
        btot = bcum[..., -1]
        # stabilizers per query position t
        a = ib - bcum                             # i_s - b_s
        m_intra = bcum + torch.amax(
            torch.where(tri, a[..., None, :], -60.0), dim=-1)   # (B,H,L)
        m_inter = bcum + m[..., None]
        m_t = torch.maximum(m_intra, m_inter)
        # intra-chunk scores
        dmat = bcum[..., :, None] - bcum[..., None, :] + ib[..., None, :]
        dmat = torch.where(tri, dmat - m_t[..., :, None], -60.0)
        smat = torch.einsum("bhtd,bhsd->bhts", qb, kb) * torch.exp(dmat)
        # inter-chunk
        scale_in = torch.exp(bcum + m[..., None] - m_t)        # (B,H,L)
        h_inter = torch.einsum("bhtd,bhde->bhte", qb, C) * scale_in[..., None]
        n_inter = torch.einsum("bhtd,bhd->bht", qb, n) * scale_in
        num = h_inter + torch.einsum("bhts,bhse->bhte", smat, vb)
        den = n_inter + torch.sum(smat, dim=-1)
        out = num / torch.maximum(torch.abs(den), torch.exp(-m_t))[..., None]
        # state update to end of chunk
        m_next = torch.maximum(m + btot, torch.amax(
            ib + btot[..., None] - bcum, dim=-1))
        kv_scale = torch.exp(ib + btot[..., None] - bcum - m_next[..., None])
        decay = torch.exp(m + btot - m_next)
        C = (C * decay[..., None, None]
             + torch.einsum("bhs,bhsd,bhse->bhde", kv_scale, kb, vb))
        n = n * decay[..., None] + torch.einsum("bhs,bhsd->bhd", kv_scale, kb)
        return out, C, n, m_next

    if q.is_meta:
        # shapes only (the dry run): the chunks are alike, so one is run
        # and counted as the s // chunk it stands for
        from repro_torch.launch.cost_analysis import count_as
        nch = s // chunk
        out, C, n, m = count_as(nch, lambda: step(0, C, n, m),
                                [q, k, v, ig, fg, C, n, m], carry=3)
        out = carried_grads(out, C, n, m)
        out = out[:, :, None].expand(b, h, nch, chunk, dh).reshape(
            b, h, s, dh)
        return out.to(v.dtype), (C, n, m)
    outs = []
    for c0 in range(0, s, chunk):
        out, C, n, m = step(c0, C, n, m)
        outs.append(out)
    return torch.cat(outs, dim=2).to(v.dtype), (C, n, m)


def _mlstm_step(q, k, v, ig, fg, state):
    """O(1) recurrent decode step. q,k,v: (B,H,dh); ig,fg: (B,H)."""
    C, n, m = state
    dh = q.shape[-1]
    q = q.float() * (1.0 / math.sqrt(dh))
    k, v = k.float(), v.float()
    logf = F.logsigmoid(fg.float())
    m_new = torch.maximum(logf + m, ig.float())
    fs = torch.exp(logf + m - m_new)
    is_ = torch.exp(ig.float() - m_new)
    C_new = fs[..., None, None] * C + is_[..., None, None] * (
        k[..., :, None] * v[..., None, :])
    n_new = fs[..., None] * n + is_[..., None] * k
    num = torch.einsum("bhd,bhde->bhe", q, C_new)
    den = torch.einsum("bhd,bhd->bh", q, n_new)
    h = num / torch.maximum(torch.abs(den), torch.exp(-m_new))[..., None]
    return h, (C_new, n_new, m_new)


def _group_rms(x, scale, nh, eps):
    """Per-head RMS norm over the head dim ('group norm' of xLSTM)."""
    lead = x.shape[:-1]
    d = x.shape[-1]
    xh = x.reshape(*lead, nh, d // nh).float()
    var = torch.mean(torch.square(xh), dim=-1, keepdim=True)
    xh = xh * torch.rsqrt(var + eps)
    return (xh.reshape(*lead, d) * scale.float()).to(x.dtype)


def mlstm_block(cfg: ModelConfig, p, x: torch.Tensor, cache=None,
                compute_dtype=torch.bfloat16):
    """Pre-up-projection mLSTM block.  x: (B,S,d). cache: dict or None."""
    d = cfg.d_model
    inner = 2 * d
    nh = cfg.n_heads
    dh = inner // nh
    b, s, _ = x.shape

    up = torch.matmul(x, p["w_up"].to(compute_dtype))
    up = constrain(up, "batch", "seq", "d_ff")
    xm, z = torch.chunk(up, 2, dim=-1)
    conv_state = cache["conv"] if cache is not None else None
    xc, conv_new = causal_conv1d(p["conv"], xm, conv_state)
    xc = F.silu(xc)
    # the recurrence takes q, k and the gates by head, v by head and
    # value dim (the dry run reduces their partial sums so)
    q = reduced_by_heads(torch.matmul, xc, p["wq"].to(compute_dtype),
                         heads=nh, whole=True)
    k = reduced_by_heads(torch.matmul, xc, p["wk"].to(compute_dtype),
                         heads=nh, whole=True)
    v = reduced_by_heads(torch.matmul, xm, p["wv"].to(compute_dtype),
                         heads=nh, whole=False)
    gates = (reduced_by_heads(torch.matmul, xc, p["w_if"].to(compute_dtype),
                              heads=nh, whole=True)
             + p["b_if"].to(compute_dtype))
    ig, fg = gates[..., :nh], gates[..., nh:]

    def heads(t):  # (B,S,inner) -> (B,H,S,dh)
        return t.reshape(b, s, nh, dh).transpose(1, 2)

    new_cache = None
    if cache is None or s > 1:
        h, (C, n, m) = _mlstm_chunkwise(
            heads(q), heads(k), heads(v), ig.transpose(1, 2),
            fg.transpose(1, 2), cfg.mlstm_chunk)
        if cache is not None:          # prefill: keep the final state
            new_cache = {"C": C, "n": n, "m": m, "conv": conv_new}
    else:                              # decode
        state = (cache["C"], cache["n"], cache["m"])
        hq = heads(q)[:, :, 0], heads(k)[:, :, 0], heads(v)[:, :, 0]
        h1, (C, n, m) = _mlstm_step(*hq, ig[:, 0], fg[:, 0], state)
        h = h1[:, :, None, :]
        new_cache = {"C": C, "n": n, "m": m, "conv": conv_new}

    h = h.to(compute_dtype)
    hflat = h.transpose(1, 2).reshape(b, s, inner)
    hflat = _group_rms(hflat, p["gn_scale"], nh, cfg.norm_eps)
    hflat = hflat * F.silu(z)
    y = torch.matmul(hflat, p["w_down"].to(compute_dtype))
    return constrain(y, "batch", "seq", "d_model"), new_cache


def mlstm_cache_spec(cfg: ModelConfig, batch: int):
    d = cfg.d_model
    inner = 2 * d
    nh = cfg.n_heads
    dh = inner // nh
    return {
        "C": Spec((batch, nh, dh, dh), ("batch", None, None, None), "zeros",
                  dtype="float32"),
        "n": Spec((batch, nh, dh), ("batch", None, None), "zeros",
                  dtype="float32"),
        "m": Spec((batch, nh), ("batch", None), "zeros", dtype="float32"),
        "conv": Spec((batch, cfg.conv_width - 1, inner),
                     ("batch", None, "d_ff"), "zeros"),
    }


# ===========================================================================
# sLSTM
# ===========================================================================

def slstm_block_spec(cfg: ModelConfig):
    d = cfg.d_model
    nh = cfg.n_heads
    dh = d // nh
    ffn_inner = int(d * 4 / 3) // 64 * 64 or 64   # GeGLU factor 4/3
    return {
        "conv": conv1d_spec(cfg.conv_width, d),
        "w_in": Spec((d, 4 * d), ("embed", "d_ff")),       # z, i, f, o
        "b_in": Spec((4 * d,), (None,), "zeros"),
        # recurrent block-diagonal weights: small init (0.02) — the
        # generic 3D fan-in rule would give std 1/sqrt(n_heads) and the
        # recurrence amplifies it exponentially over the sequence
        "r": Spec((nh, dh, 4 * dh), (None, None, None), "normal"),
        "gn_scale": Spec((d,), (None,), "ones"),
        "w_up": Spec((d, 2 * ffn_inner), ("embed", "d_ff")),
        "w_down": Spec((ffn_inner, d), ("d_ff", "embed")),
    }


def _slstm_cell(p, xg, state, nh):
    """One sLSTM step. xg: (B, 4d) input-gate preacts; state of (B,d)."""
    c, n, m, h = state
    b, d4 = xg.shape
    d = d4 // 4
    dh = d // nh
    # laid out as each head's block of the gate pre-activations
    rec = product_as(xg.reshape(b, nh, 4 * dh), torch.einsum,
                     "bhd,hde->bhe", h.reshape(b, nh, dh).float(),
                     p["r"].float()).reshape(b, 4 * d)
    # both xg and rec are laid out [z | i | f | o] per head groups flattened
    pre = xg.float() + rec
    zp, ip, fp, op = torch.chunk(pre, 4, dim=-1)
    z = torch.tanh(zp)
    o = torch.sigmoid(op)
    logf = F.logsigmoid(fp)
    m_new = torch.maximum(logf + m, ip)
    i_ = torch.exp(ip - m_new)
    f_ = torch.exp(logf + m - m_new)
    c_new = f_ * c + i_ * z
    n_new = f_ * n + i_
    # normalizer floored at 1 (|c| <= n by construction, so h stays in
    # [-1,1] either way): 1/n with n -> 0 makes backward cotangents
    # explode
    h_new = o * c_new / torch.clamp_min(n_new, 1.0)
    return (c_new, n_new, m_new, h_new)


def slstm_block(cfg: ModelConfig, p, x: torch.Tensor, cache=None,
                compute_dtype=torch.bfloat16):
    """Post-up-projection sLSTM block. x: (B,S,d)."""
    d = cfg.d_model
    nh = cfg.n_heads
    b, s, _ = x.shape
    conv_state = cache["conv"] if cache is not None else None
    xc, conv_new = causal_conv1d(p["conv"], x, conv_state)
    xc = F.silu(xc)
    xg = (torch.matmul(xc, p["w_in"].to(compute_dtype))
          + p["b_in"].to(compute_dtype))

    if cache is None:
        c0 = torch.zeros((b, d), dtype=torch.float32, device=x.device)
        state = (c0, c0, c0, c0)
    else:
        state = (cache["c"], cache["n"], cache["m"], cache["h"])
    if x.is_meta:
        # shapes only (the dry run): the steps are alike, so one is run
        # and counted as the s it stands for
        from repro_torch.launch.cost_analysis import count_as
        state = tuple(carried(t, like=xg) for t in state)
        if torch.is_grad_enabled():
            # the step's state comes from the step before: its gradient
            # flows on (the reference's scan computes it each step), and
            # the one step walked keeps what a later step keeps for it
            state = tuple(t.detach().requires_grad_() for t in state)
        state = count_as(s, lambda: _slstm_cell(p, xg[:, 0], state, nh),
                         [xg, *state], carry=4)
        hs = carried_grads(state[3], *state[:3])
        hs = hs.to(compute_dtype)[:, None].expand(b, s, d)
    else:
        hs = []
        for t in range(s):
            state = _slstm_cell(p, xg[:, t], state, nh)
            hs.append(state[3].to(compute_dtype))
        hs = torch.stack(hs, dim=1)                        # (B,S,d)
    hs = _group_rms(hs, p["gn_scale"], nh, cfg.norm_eps)
    up = torch.matmul(hs, p["w_up"].to(compute_dtype))
    g, u = torch.chunk(up, 2, dim=-1)
    y = torch.matmul(gelu(g) * u, p["w_down"].to(compute_dtype))
    new_cache = None
    if cache is not None:
        c, n, m, h_last = state
        new_cache = {"c": c, "n": n, "m": m, "h": h_last, "conv": conv_new}
    return constrain(y, "batch", "seq", "d_model"), new_cache


def slstm_cache_spec(cfg: ModelConfig, batch: int):
    d = cfg.d_model
    return {
        "c": Spec((batch, d), ("batch", None), "zeros", dtype="float32"),
        "n": Spec((batch, d), ("batch", None), "zeros", dtype="float32"),
        "m": Spec((batch, d), ("batch", None), "zeros", dtype="float32"),
        "h": Spec((batch, d), ("batch", None), "zeros", dtype="float32"),
        "conv": Spec((batch, cfg.conv_width - 1, d),
                     ("batch", None, None), "zeros"),
    }


# ===========================================================================
# RG-LRU (Griffin / RecurrentGemma)
# ===========================================================================

RGLRU_C = 8.0


def rglru_block_spec(cfg: ModelConfig):
    d = cfg.d_model
    lru = cfg.lru_width or d
    return {
        "w_gate": Spec((d, lru), ("embed", "lru")),        # GeLU branch
        "w_x": Spec((d, lru), ("embed", "lru")),           # recurrent branch
        "conv": {"w": Spec((cfg.conv_width, lru), (None, "lru")),
                 "b": Spec((lru,), ("lru",), "zeros")},
        "w_a": Spec((lru, lru), ("lru", None)),            # recurrence gate
        "b_a": Spec((lru,), (None,), "zeros"),
        "w_i": Spec((lru, lru), ("lru", None)),            # input gate
        "b_i": Spec((lru,), (None,), "zeros"),
        "lam": Spec((lru,), (None,), "normal"),            # Λ parameter
        "w_down": Spec((lru, d), ("lru", "embed")),
    }


def _rglru_scan(a: torch.Tensor, b: torch.Tensor, h0=None) -> torch.Tensor:
    """h_t = a_t * h_{t-1} + b_t over axis 1, as a log-depth parallel
    (Hillis-Steele) scan of the pairs (a, b) under the combine
    (a1, b1), (a2, b2) -> (a2 * a1, a2 * b1 + b2)."""
    if h0 is not None:
        # fold the initial state into the first element
        b = torch.cat([b[:, :1] + a[:, :1] * h0[:, None], b[:, 1:]], dim=1)
    s = a.shape[1]
    off = 1
    while off < s:
        a_prev, b_prev = a[:, :-off], b[:, :-off]
        b = torch.cat([b[:, :off], a[:, off:] * b_prev + b[:, off:]], dim=1)
        a = torch.cat([a[:, :off], a[:, off:] * a_prev], dim=1)
        off *= 2
    return b


def rglru_block(cfg: ModelConfig, p, x: torch.Tensor, cache=None,
                compute_dtype=torch.bfloat16):
    """Griffin recurrent block. x: (B,S,d)."""
    gate = gelu(torch.matmul(x, p["w_gate"].to(compute_dtype)))
    xr = constrain(torch.matmul(x, p["w_x"].to(compute_dtype)),
                   "batch", "seq", "lru")
    conv_state = cache["conv"] if cache is not None else None
    xc, conv_new = causal_conv1d(p["conv"], xr, conv_state)

    # the gates multiply into xc, laid out as it is
    r = torch.sigmoid(product_as(xc, torch.matmul, xc,
                                 p["w_a"].to(compute_dtype))
                      + p["b_a"].to(compute_dtype)).float()
    i = torch.sigmoid(product_as(xc, torch.matmul, xc,
                                 p["w_i"].to(compute_dtype))
                      + p["b_i"].to(compute_dtype)).float()
    log_a = -RGLRU_C * F.softplus(p["lam"].float()) * r
    a = torch.exp(log_a)
    gated_x = i * xc.float()
    bterm = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 1e-9)
                       ) * gated_x

    new_cache = None
    if cache is None:
        h = _rglru_scan(a, bterm)
    elif x.shape[1] > 1:  # prefill
        h = _rglru_scan(a, bterm, cache["h"].float())
        new_cache = {"h": h[:, -1], "conv": conv_new}
    else:                 # decode step
        h1 = a[:, 0] * cache["h"].float() + bterm[:, 0]
        h = h1[:, None, :]
        new_cache = {"h": h1, "conv": conv_new}

    y = h.to(compute_dtype) * gate
    y = torch.matmul(y, p["w_down"].to(compute_dtype))
    return constrain(y, "batch", "seq", "d_model"), new_cache


def rglru_cache_spec(cfg: ModelConfig, batch: int):
    lru = cfg.lru_width or cfg.d_model
    return {
        "h": Spec((batch, lru), ("batch", "lru"), "zeros", dtype="float32"),
        "conv": Spec((batch, cfg.conv_width - 1, lru),
                     ("batch", None, "lru"), "zeros"),
    }
