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

``expert_sharding="ep_sm"`` under an active mesh takes the reference's
shard_map MoE (``_moe_chunked_shardmap``): each rank slices its block of
the global inputs by the reference's ``in_specs`` and runs the body with
the collectives written out — the tiled all-to-all over "data" and its
inverse, one all-reduce of the combined token tensor over "model" — then
all-gathers the rows (``out_specs=P("data")``).  Each collective's
backward is written so that every rank ends with the whole gradient of
every global input, the no-mesh path's.  Without a mesh the reference
takes ``_moe_chunked``, and so does the port.

On a ``DTensor`` (the dry run's step, placed on the production mesh)
every expert sharding takes ``_moe_spmd``: one rank's share of the
reference's partition, with its collectives written out.
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
from repro_torch.parallel.sharding import (NamedSharding, PartitionSpec,
                                          active_mesh, at_use, constrain,
                                          entry_axes, is_distributed)

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
    load = torch.zeros((e,), dtype=torch.int64, device=x.device).scatter_add_(
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
    if is_distributed(x):
        y, aux, load = _moe_spmd(cfg, p, x, compute_dtype)
    elif b * s <= FLAT_PATH_MAX_TOKENS:
        y, aux, load = _moe_flat(cfg, p, x, compute_dtype)
    elif cfg.expert_sharding == "ep_sm" and active_mesh() is not None:
        y, aux, load = _moe_chunked_shardmap(cfg, p, x, compute_dtype)
    else:
        y, aux, load = _moe_chunked(cfg, p, x, compute_dtype)
    if cfg.n_shared_experts:
        y = y + ffn(p["shared"], x, compute_dtype)
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
    x_e = constrain(x_pad[buf_tok], _eax(cfg), None, None)  # EP all-to-all
    y_e = _expert_ffn(cfg, p, x_e, compute_dtype)              # (E, C, d)
    y_e = constrain(y_e, _eax(cfg), None, None)
    y = _combine_row(buf_tok, buf_w, y_e, n, k)
    return constrain(y.reshape(b, s, d), "batch", "seq", "d_model"), aux, load


def _route_rows(cfg, p, x_c, cap: int):
    """Route a chunk of rows (r, L, d) and build each row's capacity
    buckets: (buf_tok, buf_w) (r, E, C), the aux loss, the load."""
    r, row_len, _ = x_c.shape
    ids, w, aux, load = route(cfg, p, x_c)
    bufs = [_dispatch_row(ids[i], w[i], row_len, cfg.n_experts, cap)
            for i in range(r)]
    return (torch.stack([bt for bt, _ in bufs]),
            torch.stack([bw for _, bw in bufs]), aux, load)


# ---------------------------------------------------------------------------
# The shard_map MoE (expert_sharding="ep_sm") over explicit collectives
# ---------------------------------------------------------------------------

def _wait(t: torch.Tensor) -> torch.Tensor:
    return funcol.wait_tensor(t)


# all_gather_single is the newer name of all_gather_tensor
_all_gather_dim0 = getattr(funcol, "all_gather_single",
                           funcol.all_gather_tensor)


def _all_gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The blocks of ``group``'s ranks concatenated along ``dim``, in rank
    order."""
    out = _wait(_all_gather_dim0(x.movedim(dim, 0).contiguous(), 0, group))
    return out.movedim(0, dim)


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


class _ShardIn(torch.autograd.Function):
    """This rank's block of a global (replicated) tensor by ``sharding``
    (a ``shard_map`` in_spec).  The backward assembles the global
    tensor's whole gradient on every rank: the blocks all-gathered along
    their dims, and the partial sums of ``partial_over`` (the axes whose
    ranks each computed a part of this block's gradient) all-reduced."""

    @staticmethod
    def forward(ctx, x, sharding, partial_over):
        ctx.args = (sharding, partial_over)
        return sharding.local_block(x).contiguous()

    @staticmethod
    def backward(ctx, g):
        sharding, partial_over = ctx.args
        mesh = sharding.mesh
        for dim, e in reversed(list(enumerate(sharding.spec))):
            for a in reversed(entry_axes(e)):
                g = _all_gather(g, dim, mesh.get_group(a))
        for a in partial_over:
            g = _wait(funcol.all_reduce(g, "sum", mesh.get_group(a)))
        return g, None, None


class _GatherRows(torch.autograd.Function):
    """``out_specs=P("data")`` (``rows``): every rank's rows all-gathered
    over "data" (dim 0); every rank then holds the global output and its
    whole cotangent, so the backward keeps this rank's block of it."""

    @staticmethod
    def forward(ctx, y, rows):
        ctx.rows = rows
        return _all_gather(y, 0, rows.mesh.get_group("data"))

    @staticmethod
    def backward(ctx, g):
        return ctx.rows.local_block(g), None


def _expert_shard_map_fn(cfg, row_len: int, ep=(), tp=(),
                         reduce_tokens: bool = True):
    """Per-rank body of the shard_map MoE: the expert FFN on this rank's
    expert and f shards, a tiled all-to-all over each group of ``ep``
    (the axes the experts are split on) to bring every expert its
    tokens and its inverse to take them back, and the partials of the
    f shards all-reduced over each group of ``tp`` — with
    ``reduce_tokens`` (``expert_sharding="ep_sm"``) once the token
    tensor is combined, instead of all-reducing the dispatched
    (tokens x k x capacity) buffer.

    Per-rank inputs:
      x_pad   (r_loc, L+1, d)   rows of this data shard (+ zero sentinel)
      buf_tok (r_loc, E, C)     dispatch buckets for those rows
      buf_w   (r_loc, E, C)
      w1/w3   (E_loc, d, f_loc) this rank's expert/f shards
      w2      (E_loc, f_loc, d)
    Output: y (r_loc, L, d) — fully reduced over ``tp``."""

    def body(x_pad, buf_tok, buf_w, w1, w3, w2):
        r_loc = x_pad.shape[0]
        rows = torch.arange(r_loc, device=x_pad.device)[:, None, None]
        x_e = x_pad[rows, buf_tok]                        # (r, E, C, d)
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
        if not reduce_tokens:
            for g in tp:
                y_e = _SumReplicas.apply(y_e, g)
        # combine to tokens (with reduce_tokens still partial over tp) ...
        y = torch.stack([_combine_row(buf_tok[i], buf_w[i], y_e[i], row_len,
                                      cfg.top_k) for i in range(r_loc)])
        # ... then one reduction of the token tensor
        if reduce_tokens:
            for g in tp:
                y = _SumReplicas.apply(y, g)
        return y
    return body


def _moe_chunked_shardmap(cfg, p, x, compute_dtype):
    """expert_sharding="ep_sm": the explicit-collective MoE (above), on
    the active mesh.  Routing and dispatch run on every rank over the
    global chunk, as the reference's run outside its shard_map."""
    mesh = active_mesh()
    b, s, d = x.shape
    e = cfg.n_experts
    row_len = min(s, ROW_LEN)
    n_rows = b * (s // row_len)
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    n_data = sizes.get("data", 1)
    n_model = sizes.get("model", 1)
    xr = x.reshape(n_rows, row_len, d)
    nc = max(1, n_rows // max(n_data, ROWS_PER_CHUNK))
    r = n_rows // nc
    if r % n_data or e % n_data or cfg.moe_d_ff % n_model:
        raise ValueError(
            f"ep_sm: {r} rows a chunk and {e} experts must divide over "
            f"data={n_data}, moe_d_ff={cfg.moe_d_ff} over model={n_model}")
    xrc = xr.reshape(r, nc, row_len, d)
    cap = max(1, math.ceil(CAPACITY_FACTOR * row_len * cfg.top_k / e))
    # the reference's in_specs
    rows = NamedSharding(mesh, PartitionSpec("data"))
    w13 = NamedSharding(mesh, PartitionSpec("data", None, "model"))
    w1 = _ShardIn.apply(p["w1"].to(compute_dtype), w13, ())
    w3 = _ShardIn.apply(p["w3"].to(compute_dtype), w13, ())
    w2 = _ShardIn.apply(p["w2"].to(compute_dtype), NamedSharding(
        mesh, PartitionSpec("data", "model", None)), ())
    body = _expert_shard_map_fn(cfg, row_len, [mesh.get_group("data")],
                                [mesh.get_group("model")])
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    load = torch.zeros((e,), dtype=torch.float32, device=x.device)
    ys = []
    for c in range(nc):
        x_c = constrain(xrc[:, c], "batch", None, None)    # (r, L, d)
        buf_tok, buf_w, a, l = _route_rows(cfg, p, x_c, cap)
        aux, load = aux + a, load + l
        buf_w = buf_w.to(compute_dtype)
        x_pad = torch.cat([x_c.to(compute_dtype),
                           x_c.new_zeros((r, 1, d), dtype=compute_dtype)],
                          dim=1)
        # recompute the expert segment in the backward instead of keeping
        # its all-to-all and dispatch intermediates for every chunk
        y_c = checkpoint(
            body, _ShardIn.apply(x_pad, rows, ("model",)),
            _ShardIn.apply(buf_tok, rows, ("model",)),
            _ShardIn.apply(buf_w, rows, ("model",)), w1, w3, w2,
            use_reentrant=False)
        ys.append(_GatherRows.apply(y_c, rows))            # (r, L, d)
    y = torch.stack(ys, dim=1).reshape(b, s, d)
    return y.to(x.dtype), aux / nc, load / nc


def _moe_spmd(cfg, p, x, compute_dtype):
    """``moe_ffn`` on a ``DTensor`` ``x`` as one rank's share of the
    reference's partition, its collectives written out: routing, the
    dispatch tables and the combine run on this rank's tokens (rows
    follow the batch's split, as "expert_rows" does), and the shard_map
    body (``_expert_shard_map_fn``) on this rank's blocks of w1/w3/w2,
    its all-to-alls over the mesh axes the experts are split on, its
    all-reduces over those ``expert_ff`` is split on.  The aux loss and
    the load are averaged over the token shards."""
    from torch.distributed.tensor import DTensor, Partial, Replicate
    mesh, names = x.device_mesh, x.device_mesh.mesh_dim_names
    tokens_split = [q.is_shard() for q in x.placements]

    def block(t):
        """This rank's block of a parameter as ops use it (``at_use``);
        its gradient is partial over the axes the tokens are split on and
        it is not."""
        t = at_use(t)
        grad = [Partial() if q.is_replicate() and split else q
                for q, split in zip(t.placements, tokens_split)]
        return t.to_local(grad_placements=grad)

    def whole(t):
        return DTensor.from_local(t, mesh, [Partial("avg") if split else
                                            Replicate()
                                            for split in tokens_split],
                                  run_check=False).redistribute(
            mesh, [Replicate()] * mesh.ndim)

    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    x_loc = x.to_local()
    n = x_loc.shape[0] * s
    if b * s <= FLAT_PATH_MAX_TOKENS:           # decode: one row
        row_len = n
        cap = max(math.ceil(CAPACITY_FACTOR * n * k / e), min(n, 16))
    else:
        row_len = min(s, ROW_LEN)
        cap = max(1, math.ceil(CAPACITY_FACTOR * row_len * k / e))
    xr = x_loc.reshape(n // row_len, row_len, d)
    r = xr.shape[0]
    router = {key: block(p[key]) for key in ("w_router", "gate_bias")
              if key in p}
    buf_tok, buf_w, aux, load = _route_rows(cfg, router, xr, cap)
    w1, w3, w2 = (block(p[key]).to(compute_dtype)
                  for key in ("w1", "w3", "w2"))
    split = p["w1"].placements
    body = _expert_shard_map_fn(
        cfg, row_len,
        [mesh.get_group(a) for a, q in zip(names, split) if q.is_shard(0)],
        [mesh.get_group(a) for a, q in zip(names, split) if q.is_shard(2)],
        reduce_tokens=cfg.expert_sharding == "ep_sm")
    x_pad = torch.cat([xr.to(compute_dtype),
                       xr.new_zeros((r, 1, d), dtype=compute_dtype)], dim=1)
    y = body(x_pad, buf_tok, buf_w.to(compute_dtype), w1, w3, w2)
    y = DTensor.from_local(y.reshape(x_loc.shape).to(x.dtype), mesh,
                           x.placements, run_check=False)
    return y, whole(aux), whole(load)


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
        x_c = constrain(xrc[:, c], "batch", None, None)    # (r, L, d)
        buf_tok, buf_w, a, l = _route_rows(cfg, p, x_c, cap)
        aux, load = aux + a, load + l
        x_pad = torch.cat([x_c, x_c.new_zeros((r, 1, d))], dim=1)
        x_e = torch.stack([x_pad[i][buf_tok[i]] for i in range(r)])
        x_e = constrain(x_e, None, _eax(cfg), None, None)  # EP all-to-all
        y_e = _expert_ffn(cfg, p, x_e, compute_dtype)      # (r, E, C, d)
        y_e = constrain(y_e, None, _eax(cfg), None, None)
        y_e = constrain(y_e, "batch", None, None, None)    # back to rows
        ys.append(torch.stack([
            _combine_row(buf_tok[i], buf_w[i], y_e[i], row_len, k)
            for i in range(r)]))                           # (r, L, d)
    y = torch.stack(ys, dim=1).reshape(b, s, d)
    return y, aux / nc, load / nc
