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

The module constants keep the reference's names: tests set them.

``moe_ffn`` takes the reference's branch for every input, a plain tensor
or a ``DTensor`` (the dry run's placed step): at most
``FLAT_PATH_MAX_TOKENS`` tokens take ``_moe_flat``; else
``expert_sharding="ep_sm"`` under an active mesh takes the reference's
shard_map MoE (``_moe_chunked_shardmap``): each rank runs the body on
its block of the inputs (the reference's ``in_specs``) with the
collectives written out — the tiled all-to-all over "data" and its
inverse, one all-reduce of the combined token tensor over "model" —
and the rows come back by ``out_specs=P("data")``
(``sharding.ShardMap``: on a real mesh every rank holds the whole
tensors and cuts its block, each collective's backward written so that
every rank ends with the whole gradient of every global input; on a
``DTensor`` a rank holds its block already); else ``_moe_chunked``,
its chunks of rows a loop that the dry run walks once, counted as its
trip count, as the reference's ``lax.scan`` is compiled.  On a
``DTensor`` the ops of the flat and chunked branches are partitioned
as GSPMD partitions the reference's (``sharding.gspmd_partitioning``).
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.distributed as dist
import torch.distributed._functional_collectives as funcol
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.common.config import ModelConfig
from repro_torch.models.layers import ffn, ffn_spec
from repro_torch.models.params import Spec
from repro_torch.parallel.sharding import (PartitionSpec, ShardMap,
                                          active_mesh, constrain, gather_sum,
                                          grad_in_chunks, rows_in_chunks,
                                          rows_laid_out_as, take_rows)

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
    # the counts of torch.bincount, by an op that also runs on ``meta``
    flat = ids.reshape(-1)
    load = torch.zeros((e,), dtype=torch.int64, device=x.device).scatter_add(
        0, flat, torch.ones_like(flat)).float()
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
    """ids,w: (..., L, k) -> bucket token indices and weights (..., E, C),
    each row (the leading dims) on its own.

    Sentinel index == L marks an empty slot (gathers a zero row)."""
    *lead, l, k = ids.shape
    dev = ids.device
    flat_e = ids.reshape(*lead, l * k)
    flat_w = w.reshape(*lead, l * k)
    flat_tok = torch.arange(l, dtype=torch.int64,
                            device=dev).repeat_interleave(k)
    order = torch.argsort(flat_e, dim=-1, stable=True)
    se = torch.gather(flat_e, -1, order)
    sw = torch.gather(flat_w, -1, order)
    st = flat_tok[order]
    group_start = torch.searchsorted(
        se, torch.arange(n_experts, dtype=se.dtype, device=dev)
        .expand(*lead, n_experts).contiguous(), side="left")
    rank = torch.arange(l * k, device=dev) - torch.gather(group_start, -1, se)
    # over capacity -> column ``capacity``, which is cut off: dropped
    slot = se * (capacity + 1) + torch.where(rank < capacity, rank, capacity)
    size = n_experts * (capacity + 1)
    buf_tok = torch.scatter(torch.full((*lead, size), l, dtype=torch.int64,
                                       device=dev), -1, slot, st)
    buf_w = torch.scatter(torch.zeros((*lead, size), dtype=w.dtype,
                                      device=dev), -1, slot, sw)
    cut = (*lead, n_experts, capacity + 1)
    return (buf_tok.reshape(cut)[..., :capacity],
            buf_w.reshape(cut)[..., :capacity])


def _combine_row(buf_tok, buf_w, y_e, n_tokens: int, top_k: int):
    """Sum each token's expert outputs back in token order, each row
    (the leading dims) on its own.  y_e: (..., E, C, d).  A token sits
    in at most ``top_k`` buckets (its experts are distinct); its
    contributions are added in bucket order (by expert), each as a
    gather (``sharding.gather_sum``), so the sum's order never depends
    on the device — no scatter-add with atomics."""
    *lead, e, c, d = y_e.shape
    dev = buf_tok.device
    flat_tok = buf_tok.reshape(*lead, e * c)
    contrib = (y_e * buf_w[..., None]).reshape(*lead, e * c, d)
    order = torch.argsort(flat_tok, dim=-1, stable=True)
    st = torch.gather(flat_tok, -1, order)
    start = torch.searchsorted(
        st, torch.arange(n_tokens + 1, dtype=st.dtype, device=dev)
        .expand(*lead, n_tokens + 1).contiguous(), side="left")
    rank = torch.arange(e * c, device=dev) - torch.gather(start, -1, st)
    # (n_tokens + 1, top_k + 1) slot table a row (e * c: no slot); the
    # sentinel token's many slots and rank >= top_k land in its row and
    # the cut-off column, and its row is cut off from the sum
    slot = st * (top_k + 1) + torch.clamp_max(rank, top_k)
    table = torch.scatter(
        torch.full((*lead, (n_tokens + 1) * (top_k + 1)), e * c,
                   dtype=torch.int64, device=dev), -1, slot, order)
    table = table.reshape(*lead, n_tokens + 1, top_k + 1)[..., :top_k]
    return gather_sum(contrib, table)[..., :n_tokens, :]


def _expert_ffn(cfg: ModelConfig, p, x_e: torch.Tensor,
                compute_dtype) -> torch.Tensor:
    """x_e: (..., E, C, d) expert buckets -> same shape."""
    w1 = p["w1"].to(compute_dtype)
    w3 = p["w3"].to(compute_dtype)
    w2 = p["w2"].to(compute_dtype)
    h1 = torch.einsum("...ecd,edf->...ecf", x_e, w1)
    h3 = torch.einsum("...ecd,edf->...ecf", x_e, w3)
    h = F.silu(h1) * h3
    ffax = None if cfg.expert_sharding == "ep2d" else "expert_ff"
    if x_e.dim() == 4:
        h = constrain(h, None, _eax(cfg), None, ffax)
    else:
        h = constrain(h, _eax(cfg), None, ffax)
    return torch.einsum("...ecf,efd->...ecd", h, w2)


def moe_ffn(cfg: ModelConfig, p, x: torch.Tensor,
            compute_dtype=torch.bfloat16
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Routed + shared expert FFN.  x: (B, S, d).

    Returns (y, aux_loss, expert_load)."""
    b, s, d = x.shape
    x_shared = x
    if b * s <= FLAT_PATH_MAX_TOKENS:
        y, aux, load = _moe_flat(cfg, p, x, compute_dtype)
    elif cfg.expert_sharding == "ep_sm" and active_mesh() is not None:
        y, aux, load = _moe_chunked_shardmap(cfg, p, x, compute_dtype)
    else:
        y, aux, load, x_shared = _moe_chunked(cfg, p, x, compute_dtype)
    if cfg.n_shared_experts:
        y = y + ffn(p["shared"], x_shared, compute_dtype)
    return constrain(y, "batch", "seq", "d_model"), aux, load


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
    # the buckets gathered as the experts are split (the reference's
    # partition gives the dispatch's buckets the split of their use)
    x_e = take_rows(x_pad, constrain(buf_tok, _eax(cfg), None))
    x_e = constrain(x_e, _eax(cfg), None, None)               # EP
    y_e = _expert_ffn(cfg, p, x_e, compute_dtype)              # (E, C, d)
    y_e = constrain(y_e, _eax(cfg), None, None)
    y = _combine_row(buf_tok, buf_w, y_e, n, k)
    return constrain(y.reshape(b, s, d), "batch", "seq", "d_model"), aux, load


def _route_rows(cfg, p, x_c, cap: int):
    """Route a chunk of rows (r, L, d) and build each row's capacity
    buckets: (buf_tok, buf_w) (r, E, C), the aux loss, the load."""
    ids, w, aux, load = route(cfg, p, x_c)
    buf_tok, buf_w = _dispatch_row(ids, w, x_c.shape[1], cfg.n_experts, cap)
    return buf_tok, buf_w, aux, load


def _chunk_loop(nc: int, step, x: torch.Tensor, inputs):
    """``step(c)`` -> (y (r, L, d), aux, load) for each chunk ``c`` of
    ``nc``: y stacked on a new dim 1, aux and load summed.  On ``meta``
    tensors (the dry run) the chunks are alike, so one is run and counted
    as the ``nc`` it stands for, as the reference's ``lax.scan`` over
    them is compiled, its weights' reads hoisted out of the loop."""
    if x.is_meta:
        from repro_torch.launch.cost_analysis import count_as
        y, aux, load = count_as(nc, lambda: step(0), inputs, hoist=True)
        return (y[:, None].expand(y.shape[0], nc, *y.shape[1:]),
                aux * nc, load * nc)
    ys, aux, load = [], 0.0, 0.0
    for c in range(nc):
        y, a, l = step(c)
        ys.append(y)
        aux, load = aux + a, load + l
    return torch.stack(ys, dim=1), aux, load


# ---------------------------------------------------------------------------
# The shard_map MoE (expert_sharding="ep_sm") over explicit collectives
# ---------------------------------------------------------------------------

def _wait(t: torch.Tensor) -> torch.Tensor:
    return funcol.wait_tensor(t)


def _all_to_all(x: torch.Tensor, group, split: int, concat: int
                ) -> torch.Tensor:
    """``jax.lax.all_to_all(..., tiled=True)``: split ``x`` along
    ``split`` into one block a rank of ``group``, send block i to rank
    i, and concatenate the blocks received along ``concat`` in rank
    order."""
    n = dist.get_world_size(group)
    xs = x.movedim(split, 0).contiguous()
    out = _wait(funcol.all_to_all_single(xs, None, None, group))
    out = out.reshape(n, xs.shape[0] // n, *xs.shape[1:]).movedim(1, split + 1)
    out = out.movedim(0, concat)
    return out.reshape(*out.shape[:concat], -1, *out.shape[concat + 2:])


class _AllToAll(torch.autograd.Function):
    """The tiled all-to-all; its backward is the inverse all-to-all."""

    @staticmethod
    def forward(ctx, x, group, split, concat):
        ctx.args = (group, split, concat)
        return _all_to_all(x, group, split, concat)

    @staticmethod
    def backward(ctx, g):
        group, split, concat = ctx.args
        return _all_to_all(g, group, concat, split), None, None, None


class _SumReplicas(torch.autograd.Function):
    """``psum`` over ``group`` of partial sums whose total every rank then
    holds as its own replica: the cotangent each rank receives is the
    whole cotangent of the total, so the backward is the identity (an
    all-reduce here would count it once per rank)."""

    @staticmethod
    def forward(ctx, x, group):
        return _wait(funcol.all_reduce(x, "sum", group))

    @staticmethod
    def backward(ctx, g):
        return g, None


def _expert_shard_map_fn(cfg, row_len: int, ep=(), tp=()):
    """Per-rank body of the shard_map MoE: the expert FFN on this rank's
    expert and f shards, a tiled all-to-all over each group of ``ep``
    (the axes the experts are split on) to bring every expert its
    tokens and its inverse to take them back, and the partials of the
    f shards all-reduced over each group of ``tp`` once the token tensor
    is combined, instead of all-reducing the dispatched (tokens x k x
    capacity) buffer.

    Per-rank inputs:
      x_pad   (r_loc, L+1, d)   rows of this data shard (+ zero sentinel)
      buf_tok (r_loc, E, C)     dispatch buckets for those rows
      buf_w   (r_loc, E, C)
      w1/w3   (E_loc, d, f_loc) this rank's expert/f shards
      w2      (E_loc, f_loc, d)
    Output: y (r_loc, L, d) — fully reduced over ``tp``."""

    def body(x_pad, buf_tok, buf_w, w1, w3, w2):
        x_e = take_rows(x_pad, buf_tok)                  # (r, E, C, d)
        # EP all-to-all: split experts, concat rows -> (r_loc * n_ep,
        # E_loc, C, d): every row shard's tokens for this rank's experts
        for g in ep:
            x_e = _AllToAll.apply(x_e, g, 1, 0)
        h1 = torch.einsum("recd,edf->recf", x_e, w1)
        h3 = torch.einsum("recd,edf->recf", x_e, w3)
        y_e = torch.einsum("recf,efd->recd", F.silu(h1) * h3, w2)
        # partial over tp (f contracted locally); the inverse all-to-all
        # sends expert outputs back to their row shards
        for g in reversed(ep):
            y_e = _AllToAll.apply(y_e, g, 0, 1)           # (r_loc, E, C, d)
        # combine to tokens while still partial over tp ...
        y = _combine_row(buf_tok, buf_w, y_e, row_len, cfg.top_k)
        # ... then one reduction of the token tensor
        for g in tp:
            y = _SumReplicas.apply(y, g)
        return y
    return body


def _moe_chunked_shardmap(cfg, p, x, compute_dtype):
    """expert_sharding="ep_sm": the explicit-collective MoE (above), on
    the active mesh (``sharding.ShardMap``).  Routing and dispatch run
    outside the body on the whole chunk, as the reference's run outside
    its shard_map: on a real mesh every rank routes every token; in the
    dry run the chunk is a ``DTensor`` whose top-k takes the router's
    scores whole (``sharding._top_k_whole``), as the reference's
    partition all-gathers them."""
    sm = ShardMap(x)
    b, s, d = x.shape
    e = cfg.n_experts
    row_len = min(s, ROW_LEN)
    n_rows = b * (s // row_len)
    n_data, n_model = sm.size("data"), sm.size("model")
    nc = max(1, n_rows // max(n_data, ROWS_PER_CHUNK))
    r = n_rows // nc
    if r % n_data or e % n_data or cfg.moe_d_ff % n_model:
        raise ValueError(
            f"ep_sm: {r} rows a chunk and {e} experts must divide over "
            f"data={n_data}, moe_d_ff={cfg.moe_d_ff} over model={n_model}")
    xrc = x.reshape(n_rows, row_len, d).reshape(r, nc, row_len, d)
    cap = max(1, math.ceil(CAPACITY_FACTOR * row_len * cfg.top_k / e))
    # the reference's in_specs
    rows = PartitionSpec("data")
    w13 = PartitionSpec("data", None, "model")
    w1 = sm.block(p["w1"].to(compute_dtype), w13)
    w3 = sm.block(p["w3"].to(compute_dtype), w13)
    w2 = sm.block(p["w2"].to(compute_dtype),
                  PartitionSpec("data", "model", None))
    router = {key: p[key] for key in ("w_router", "gate_bias") if key in p}
    body = _expert_shard_map_fn(cfg, row_len, sm.groups(w13, 0),
                                sm.groups(w13, 2))

    def step(c):
        x_c = constrain(xrc[:, c], "batch", None, None)    # (r, L, d)
        buf_tok, buf_w, a, l = _route_rows(cfg, router, x_c, cap)
        x_pad = torch.cat([x_c.to(compute_dtype),
                           x_c.new_zeros((r, 1, d), dtype=compute_dtype)],
                          dim=1)
        # recompute the expert segment in the backward instead of keeping
        # its all-to-all and dispatch intermediates for every chunk
        y_c = checkpoint(
            body, sm.block(x_pad, rows, ("model",)),
            sm.block(buf_tok, rows, ("model",)),
            sm.block(buf_w.to(compute_dtype), rows, ("model",)), w1, w3, w2,
            use_reentrant=False)
        return sm.rows_out(y_c, rows, x_c), a, l

    ys, aux, load = _chunk_loop(nc, step, x, [xrc])
    y = rows_laid_out_as(ys.reshape(b, s, d), x)
    return y.to(x.dtype), aux / nc, load / nc


def _moe_chunked(cfg, p, x, compute_dtype):
    """Train/prefill path: rows of ROW_LEN tokens, chunks of
    ROWS_PER_CHUNK rows; chunk i takes one row from each block of rows.
    Returns (y, aux, load, x as the shared expert reads it:
    ``sharding.grad_in_chunks``, ``x`` itself but in the dry run)."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    row_len = min(s, ROW_LEN)
    assert s % row_len == 0, (s, row_len)
    n_rows = b * (s // row_len)
    xr = x.reshape(n_rows, row_len, d)
    nc = max(1, n_rows // ROWS_PER_CHUNK)
    r = n_rows // nc
    assert r * nc == n_rows, (n_rows, nc)
    xrc = rows_in_chunks(xr, r, nc)                      # (r, nc, L, d)
    cap = max(1, math.ceil(CAPACITY_FACTOR * row_len * k / e))

    def step(c):
        x_c = constrain(xrc[:, c], "batch", None, None)    # (r, L, d)
        buf_tok, buf_w, aux, load = _route_rows(cfg, p, x_c, cap)
        x_pad = torch.cat([x_c, x_c.new_zeros((r, 1, d))], dim=1)
        x_e = take_rows(x_pad, buf_tok)                   # (r, E, C, d)
        x_e = constrain(x_e, None, _eax(cfg), None, None)  # EP all-to-all
        y_e = _expert_ffn(cfg, p, x_e, compute_dtype)
        y_e = constrain(y_e, None, _eax(cfg), None, None)
        y_e = constrain(y_e, "batch", None, None, None)    # back to rows
        return _combine_row(buf_tok, buf_w, y_e, row_len, k), aux, load

    ys, aux, load = _chunk_loop(nc, step, x, [xrc])
    return (rows_laid_out_as(ys.reshape(b, s, d), x), aux / nc, load / nc,
            grad_in_chunks(x, xrc))
