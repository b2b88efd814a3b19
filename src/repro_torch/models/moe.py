"""Mixture-of-Experts FFN (DeepSeek-V2/V3 style) — the reference's
``repro.models.moe`` on one card.

  * Routing: softmax top-k (+ load-balance aux loss) for V2, or sigmoid
    + aux-loss-free gate bias for V3.  Top-k breaks ties by the lower
    expert index, as ``jax.lax.top_k`` does.
  * Dispatch: sort-based capacity buckets built per row (a row = up to
    ``ROW_LEN`` contiguous tokens of one sequence).  The sort is stable,
    and a token over its expert's capacity loses that expert (the write
    is dropped, not clamped).
  * Combine: each token sums its expert outputs in a fixed order (by
    expert index), as gathers, so the result is the same on every run
    and on every device — no scatter-add with atomics.
  * Shared experts are a dense always-on FFN.

The module constants keep the reference's names: tests set them.  The
reference's shard_map MoE (``expert_sharding="ep_sm"``) needs a device
mesh; without one the reference takes ``_moe_chunked``, and so does the
port.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.common.config import ModelConfig
from repro_torch.models.layers import ffn, ffn_spec
from repro_torch.models.params import Spec
from repro_torch.parallel.sharding import active_mesh, constrain

ROW_LEN = 4096          # tokens per dispatch row (<= one sequence)
ROWS_PER_CHUNK = 16     # rows processed per step (1 per data shard)
CAPACITY_FACTOR = 1.25
FLAT_PATH_MAX_TOKENS = 8192   # decode: gather-all dispatch below this


def _eax(cfg: ModelConfig) -> str:
    """Logical mesh axis of the expert dim ('ep2d' shards experts over
    data x model jointly)."""
    return "expert2d" if cfg.expert_sharding == "ep2d" else "expert"


def moe_spec(cfg: ModelConfig):
    d, e, f = cfg.d_model, cfg.n_experts, cfg.moe_d_ff
    eax = _eax(cfg)
    ffax = None if cfg.expert_sharding == "ep2d" else "expert_ff"
    spec = {
        "w_router": Spec((d, e), ("embed", None)),
        "w1": Spec((e, d, f), (eax, None, ffax)),
        "w3": Spec((e, d, f), (eax, None, ffax)),
        "w2": Spec((e, f, d), (eax, ffax, None)),
    }
    if cfg.aux_free_bias:
        spec["gate_bias"] = Spec((e,), (None,), "zeros", dtype="float32")
    if cfg.n_shared_experts:
        spec["shared"] = ffn_spec(d, cfg.n_shared_experts * f)
    return spec


# ---------------------------------------------------------------------------
# Routing
# ---------------------------------------------------------------------------

def _top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k``: the k largest along the last dim, ties to the
    lower index."""
    vals, ids = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], ids[..., :k]


def route(cfg: ModelConfig, p, x: torch.Tensor):
    """x: (..., d) -> (ids (...,k), weights (...,k), aux_loss, load (E,))."""
    logits = torch.matmul(x.float(), p["w_router"].float())
    k, e = cfg.top_k, cfg.n_experts
    if cfg.gate_fn == "sigmoid":
        scores = torch.sigmoid(logits)
        sel = scores
        if cfg.aux_free_bias:
            sel = scores + p["gate_bias"].float().detach()
        _, ids = _top_k(sel, k)
        w = torch.gather(scores, -1, ids)
        w = w / torch.clamp_min(torch.sum(w, dim=-1, keepdim=True), 1e-9)
        w = w * cfg.routed_scaling
        probs = scores / torch.clamp_min(
            torch.sum(scores, dim=-1, keepdim=True), 1e-9)
    else:
        probs = torch.softmax(logits, dim=-1)
        w, ids = _top_k(probs, k)
        w = w * cfg.routed_scaling
    # load-balance statistics (flatten all token dims)
    load = torch.bincount(ids.reshape(-1), minlength=e).float()
    load = load / torch.clamp_min(torch.sum(load), 1.0)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.router_aux_coef:
        importance = torch.mean(probs.reshape(-1, e), dim=0)
        aux = cfg.router_aux_coef * e * torch.sum(load * importance)
    return ids, w.to(x.dtype), aux, load


# ---------------------------------------------------------------------------
# Sort-based capacity dispatch (per row)
# ---------------------------------------------------------------------------

def _dispatch_row(ids: torch.Tensor, w: torch.Tensor, n_tokens: int,
                  n_experts: int, capacity: int):
    """ids,w: (L, k) -> bucket token indices and weights (E, C).

    Sentinel index == L marks an empty slot (gathers a zero row)."""
    l, k = ids.shape
    dev = ids.device
    flat_e = ids.reshape(-1)
    flat_w = w.reshape(-1)
    flat_tok = torch.arange(l, dtype=torch.int64,
                            device=dev).repeat_interleave(k)
    order = torch.argsort(flat_e, stable=True)
    se, st, sw = flat_e[order], flat_tok[order], flat_w[order]
    group_start = torch.searchsorted(
        se, torch.arange(n_experts, dtype=se.dtype, device=dev), side="left")
    rank = torch.arange(l * k, device=dev) - group_start[se]
    # over capacity -> column ``capacity``, which is cut off: dropped
    slot = torch.where(rank < capacity, rank, capacity)
    buf_tok = torch.full((n_experts, capacity + 1), l, dtype=torch.int64,
                         device=dev)
    buf_tok[se, slot] = st
    buf_w = torch.zeros((n_experts, capacity + 1), dtype=w.dtype, device=dev)
    buf_w[se, slot] = sw
    return buf_tok[:, :capacity], buf_w[:, :capacity]


def _combine_row(buf_tok, buf_w, y_e, n_tokens: int, top_k: int):
    """Sum each token's expert outputs back in token order.  y_e: (E, C,
    d).  A token sits in at most ``top_k`` buckets (its experts are
    distinct); its contributions are added in bucket order (by expert),
    each as a gather, so the sum's order never depends on the device."""
    d = y_e.shape[-1]
    flat_tok = buf_tok.reshape(-1)
    contrib = torch.cat([(y_e * buf_w[..., None]).reshape(-1, d),
                         y_e.new_zeros((1, d))])          # last row: none
    order = torch.argsort(flat_tok, stable=True)
    st = flat_tok[order]
    start = torch.searchsorted(
        st, torch.arange(n_tokens + 1, dtype=st.dtype, device=st.device),
        side="left")
    rank = torch.arange(st.numel(), device=st.device) - start[st]
    # (n_tokens + 1, top_k + 1) slot table; the sentinel token's many
    # slots and rank >= top_k land in the cut-off row/column
    table = torch.full((n_tokens + 1, top_k + 1), flat_tok.numel(),
                       dtype=torch.int64, device=st.device)
    table[st, torch.clamp_max(rank, top_k)] = order
    table = table[:n_tokens, :top_k]
    y = contrib[table[:, 0]]
    for j in range(1, top_k):
        y = y + contrib[table[:, j]]
    return y


def _expert_ffn(cfg: ModelConfig, p, x_e: torch.Tensor,
                compute_dtype) -> torch.Tensor:
    """x_e: (..., E, C, d) expert buckets -> same shape."""
    w1 = p["w1"].to(compute_dtype)
    w3 = p["w3"].to(compute_dtype)
    w2 = p["w2"].to(compute_dtype)
    h1 = torch.einsum("...ecd,edf->...ecf", x_e, w1)
    h3 = torch.einsum("...ecd,edf->...ecf", x_e, w3)
    h = F.silu(h1) * h3
    return torch.einsum("...ecf,efd->...ecd", h, w2)


def moe_ffn(cfg: ModelConfig, p, x: torch.Tensor,
            compute_dtype=torch.bfloat16
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Routed + shared expert FFN.  x: (B, S, d).

    Returns (y, aux_loss, expert_load)."""
    b, s, d = x.shape
    if b * s <= FLAT_PATH_MAX_TOKENS:
        y, aux, load = _moe_flat(cfg, p, x, compute_dtype)
    elif cfg.expert_sharding == "ep_sm" and active_mesh() is not None:
        raise NotImplementedError(
            "the shard_map MoE needs a device mesh (multi-device placement "
            "is not ported yet)")
    else:
        y, aux, load = _moe_chunked(cfg, p, x, compute_dtype)
    if cfg.n_shared_experts:
        y = y + ffn(p["shared"], x, compute_dtype)
    return y, aux, load


def _moe_flat(cfg, p, x, compute_dtype):
    """Decode path: few tokens; gather-all, dispatch once."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    n = b * s
    xf = x.reshape(n, d)
    ids, w, aux, load = route(cfg, p, xf)
    # small-N floor: with few tokens, hot experts easily exceed the
    # proportional capacity — give decode enough headroom to avoid drops.
    cap = max(math.ceil(CAPACITY_FACTOR * n * k / e), min(n, 16))
    buf_tok, buf_w = _dispatch_row(ids, w, n, e, cap)
    x_pad = torch.cat([xf, xf.new_zeros((1, d))])
    x_e = constrain(x_pad[buf_tok], _eax(cfg), None, None)  # EP all-to-all
    y_e = _expert_ffn(cfg, p, x_e, compute_dtype)              # (E, C, d)
    y = _combine_row(buf_tok, buf_w, y_e, n, k)
    return y.reshape(b, s, d), aux, load


def _moe_chunked(cfg, p, x, compute_dtype):
    """Train/prefill path: rows of ROW_LEN tokens, chunks of
    ROWS_PER_CHUNK rows; chunk i takes one row from each block of rows."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    row_len = min(s, ROW_LEN)
    assert s % row_len == 0, (s, row_len)
    n_rows = b * (s // row_len)
    xr = x.reshape(n_rows, row_len, d)
    nc = max(1, n_rows // ROWS_PER_CHUNK)
    r = n_rows // nc
    assert r * nc == n_rows, (n_rows, nc)
    xrc = xr.reshape(r, nc, row_len, d)
    cap = max(1, math.ceil(CAPACITY_FACTOR * row_len * k / e))
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    load = torch.zeros((e,), dtype=torch.float32, device=x.device)
    ys = []
    for c in range(nc):
        x_c = xrc[:, c]                                    # (r, L, d)
        ids, w, a, l = route(cfg, p, x_c)
        aux, load = aux + a, load + l
        bufs = [_dispatch_row(ids[i], w[i], row_len, e, cap)
                for i in range(r)]
        buf_tok = torch.stack([bt for bt, _ in bufs])      # (r, E, C)
        buf_w = torch.stack([bw for _, bw in bufs])
        x_pad = torch.cat([x_c, x_c.new_zeros((r, 1, d))], dim=1)
        x_e = torch.stack([x_pad[i][buf_tok[i]] for i in range(r)])
        x_e = constrain(x_e, None, _eax(cfg), None, None)  # EP all-to-all
        y_e = _expert_ffn(cfg, p, x_e, compute_dtype)      # (r, E, C, d)
        ys.append(torch.stack([
            _combine_row(buf_tok[i], buf_w[i], y_e[i], row_len, k)
            for i in range(r)]))                           # (r, L, d)
    y = torch.stack(ys, dim=1).reshape(b, s, d)
    return y, aux / nc, load / nc
