"""The rules by which ``sharding.gspmd_partitioning`` partitions the
long-context decode's attention and RG-LRU gates and the training
step's gate backward, norms and update as the reference's partitioner
does, each on a toy op on the 16x16 production mesh or the 2x16x16
one (one rank's share,
``launch.cost_analysis.count_step`` over DTensors of ``meta`` blocks):

  * ``_whole_over_free``: a product whose operands split different
    letters over "model" (the queries' heads, the cache's sequence)
    makes the smaller whole by way of the free "data";
  * ``product_as`` where "data" is free (``_split_partial``): the
    output's wanted letter split over "data", a block's partial sums
    all-reduced over "model", the split moved back to "model";
  * ``product_as`` where no axis is free (``_GatheredCotangent``): the
    forward as it was, the backward gathering the output's gradient
    for each transposed product;
  * ``_take_split``: an in-place update outside autograd takes its
    operand's split, a stacked leaf's layer with its stack;
  * ``set_slot``: the new entry gathered whole on every rank, whichever
    rank writes it;
  * ``split_kept`` and ``cat_kept``: a chunk of a dim split over
    "model" keeps each part split, its blocks fetched by
    collective-permutes as XLA groups them, the parts' gradients joined
    by all-to-alls;
  * ``gspmd_fallback``'s pad: along dims no mesh dim splits on the
    blocks, along a split dim gathered first;
  * ``gathered_on_blocks``: the cross-entropy's gold gather takes its
    gradient on the logits' blocks (split like the logits, no
    collective, no block of the global shape); on a 2 x 4 gloo world of
    real CPU blocks, that gradient assembled equals the unpartitioned
    one bit for bit;
  * on "model" cut 4 x 4 (``launch.mesh.factor_axis``):
    ``reduced_by_heads`` reduces a product's partial sums over the
    heads' factor, slices the head, then over the other factor (or over
    both at once, then slices), and asks an uncut mesh for the cut;
    ``_take_split`` leaves an update split over both factors;
  * ``reduced_product``: a norm's scale's and bias's gradients, sums
    over the tokens, are all-reduced once in the backward, over every
    axis that splits the tokens (on 16x16 and 2x16x16), and AdamW reads
    them without reducing them again;
  * on 2x16x16, ``_whole_by_free_dims``: the decode scores' queries
    gathered by way of "pod" x "data" together;
  * the xLSTM where "pod" x "data" outrank "model", on a small 3-D mesh:
    an up projection contracted, and an unembedding's input gathered,
    over both at once (``_input_whole_product``, ``_move_split``),
    the sLSTM state gathered over both (``_gathered_contraction``), the
    lookup's table gradient reduced once in the backward
    (``_table_for_lookup``), an up projection's weight gradient reduced
    over "data", then "pod" (``_reduced_in_stages``), and the sLSTM
    gates' gradients gathered where their rows cannot split
    (``cat_kept``);
  * the MoE with its batch over "pod" x "data", on a small 3-D mesh:
    the chunked MoE's rows taken into chunks as the reference's scan
    reads them (``rows_in_chunks``) and its output laid out as the
    batch (``rows_laid_out_as``), a sort over both axes gathered in
    one all-gather (``_whole_over``), the decode's join of its
    tokens and zero row (``uneven_cat``), its buckets, its combine on
    the blocks of both free axes (``_gather_sum_blocks``) and the cut
    to its tokens (``_recut``);
  * the chunked MoE's training step there, a chunk's rows over "data"
    alone: the router contracted over "pod" x "model"
    (``_contract_split`` with ``_free_for``'s group), the loop's output
    gradient taken back whole into the chunks and nothing moved in a
    recompute (``_RowsRegrouped``), the shared expert's input gradient
    made in the chunk loop's layout beside the chunks' own
    (``grad_in_chunks``, ``product_into_chunks``), and a norm whose
    output's gradient comes back in that layout: XLA's involuntary full
    rematerialization for its scale's gradient
    (``involuntary_full_remat``) and its statistic and gradients moved
    between the layouts (``rows_regrouped_pointwise``); a dense layer's
    norm takes neither;
  * an attention step there, its positions whole: the mask built on
    the rank's own rows (``rows_split_as``), a prefill's cache keeping
    its positions whole.

The production mesh lives on a dry-run world (the ``fake`` backend), so
every case runs in one subprocess (its results checked here); the gloo
world's 8 ranks are this file run as a script (spawn, ``FileStore``)."""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
DATA, MODEL = 2, 4                  # the gloo world's mesh
XENT_SHAPE = (4, 6, 16)             # (batch, seq, vocab)
XENT_RTOL = 1e-6

_CASES = r"""
import json
import torch
from torch.distributed.tensor import DTensor, Replicate, Shard
from repro_torch.launch import cost_analysis as ca
from repro_torch.launch import mesh as m
from repro_torch.parallel import sharding as sh

mesh = m.make_production_mesh()
R, S = Replicate(), Shard


def dt(shape, placements, grad=False, dtype=torch.float32):
    local = list(shape)
    for i, p in enumerate(placements):
        if p.is_shard():
            local[p.dim] //= mesh.size(i)
    stride = torch.empty(shape, device="meta").stride()
    t = DTensor.from_local(torch.empty(local, device="meta", dtype=dtype),
                           mesh,
                           placements, run_check=False,
                           shape=torch.Size(shape), stride=stride)
    return t.detach().requires_grad_(grad)


def cost(fn):
    c = ca.count_step(fn)
    return {"dot_flops": c.dot_flops, "elements": c.coll_elements}


def where(t):
    return {"placements": [str(p) for p in t.placements],
            "local": list(t.to_local().shape)}


out = {}
with sh.gspmd_partitioning():
    # decode attention over a sequence-split cache: q's 16 KV heads over
    # "model", the cache's 4096 positions over "model", "data" free
    q = dt((1, 1, 16, 2, 128), [R, S(2)])
    k = dt((1, 4096, 16, 128), [R, S(1)])
    res = {}
    out["scores"] = cost(lambda: res.setdefault("y", torch.einsum(
        "bsngd,btnd->bnsgt", q, k)))
    out["scores"].update(where(res["y"]))
    probs = dt((1, 16, 1, 2, 4096), [R, S(4)])
    v = dt((1, 4096, 16, 128), [R, S(1)])
    res = {}
    out["values"] = cost(lambda: res.setdefault("y", sh.product_as(
        q, torch.einsum, "bnsgt,btnd->bsngd", probs, v)))
    out["values"].update(where(res["y"]))
    whole = dt((1, 1, 16, 2, 128), [R, R])
    out["values whole"] = cost(lambda: sh.product_as(
        whole, torch.einsum, "bnsgt,btnd->bsngd", probs, v))
    # a training step's gate: tokens over "data", lru over "model"
    x = dt((256, 64, 512), [S(0), S(2)], grad=True)
    w = dt((512, 512), [R, S(0)], grad=True)
    dy = dt((256, 64, 512), [S(0), S(2)])
    out["gate"] = cost(lambda: sh.product_as(x, torch.matmul, x, w
                                             ).backward(dy))
    out["gate"]["grads"] = [where(x.grad), where(w.grad)]
    # the update of a whole parameter by a split gradient, in place
    p, g = dt((4096,), [R, R]), dt((4096,), [R, S(0)])
    stack = dt((3, 4096), [R, R])
    with torch.no_grad():
        layer = stack[1]
        out["update"] = cost(lambda: (p.add_(g), layer.mul_(0.9).add_(g)))
    out["update"].update({"param": where(p), "stack": where(stack),
                          "layer": where(layer)})
    # a decode step's write into a cache split along its sequence
    buf = dt((1, 4096, 16, 128), [R, S(1)])
    new = dt((1, 1, 16, 128), [R, S(2)])
    out["slot"] = cost(lambda: sh.set_slot(buf, 1, 4095, new))
    out["slot"]["coordinate"] = mesh.get_coordinate()
    # an xLSTM block's up projection, split 16 ways over "model", cut
    # into its halves (the mLSTM) and its four gates (the sLSTM)
    up = dt((128, 1, 3072), [S(0), S(2)], grad=True)
    res = {}
    out["halves"] = cost(lambda: res.setdefault("y", torch.chunk(up, 2, -1)))
    out["halves"].update(where(res["y"][1]))
    out["quarters"] = cost(lambda: torch.chunk(up, 4, -1))
    # ... and the halves' gradients joined again; and those of the halves
    # of a (256, 1, 3072), 16 rows a rank
    g = dt((128, 1, 1536), [S(0), S(2)])
    out["joined"] = cost(lambda: (res["y"][0] * res["y"][1]).backward(g))
    out["joined"].update(where(up.grad))
    up = dt((256, 1, 3072), [S(0), S(2)], grad=True)
    g = dt((256, 1, 1536), [S(0), S(2)])
    halves = torch.chunk(up, 2, -1)
    out["joined rows"] = cost(lambda: (halves[0] * halves[1]).backward(g))
    out["joined rows"].update(where(up.grad))
    # a causal conv's pad along the unsplit sequence, and a pad along the
    # split dim
    x = dt((16, 4096, 64), [S(0), S(2)])
    res = {}
    out["pad seq"] = cost(lambda: res.setdefault("y", torch.nn.functional.pad(
        x, (0, 0, 3, 0))))
    out["pad seq"].update(where(res["y"]))
    res = {}
    out["pad split"] = cost(lambda: res.setdefault(
        "y", torch.nn.functional.pad(x, (1, 1))))
    out["pad split"].update(where(res["y"]))
    # q's partial sums on "model" uncut: the walk asks for the heads' cut
    xc = dt((128, 1, 1536), [S(0), S(2)])
    wq = dt((1536, 1536), [R, S(0)])
    c = ca.count_step(lambda: sh.reduced_by_heads(torch.matmul, xc, wq,
                                                  heads=4, whole=True))
    out["cut"] = list(c.axis_cut)
    # the cross-entropy of (256, 16, 4096) logits, tokens over "data",
    # vocab over "model" (or whole), its backward alone; and the gold
    # gather's alone, as softmax_xent gathers and constrains it
    from repro_torch.models.model import softmax_xent
    for name, vocab in (("xent", [S(0), S(2)]), ("xent whole", [S(0), R])):
        for part in ("", " gold"):
            logits = dt((256, 16, 4096), vocab, grad=True)
            targets = dt((256, 16), [S(0), R], dtype=torch.long)
            with sh.activate(mesh, sh.make_rules("train")):
                if part:
                    loss = sh.constrain(torch.gather(
                        logits, -1, targets[..., None]),
                        "batch", "seq", None)[..., 0]
                    dy = dt((256, 16), [S(0), R])
                    c = ca.count_step(lambda: loss.backward(dy))
                else:
                    loss = softmax_xent(logits, targets)
                    c = ca.count_step(lambda: loss.backward())
            out[name + part] = {"elements": c.coll_elements,
                                "replicated": c.replicated_ops,
                                "peak": c.blocks.peak(),
                                **where(logits.grad)}

# "model" cut 4 x 4 by the heads
cut = m.factor_axis(mesh, "model", (4, 4))
mesh = cut


def dtc(shape, placements, grad=False):
    local = list(shape)
    for i, p in enumerate(placements):
        if p.is_shard():
            local[p.dim] //= cut.size(i)
    stride = torch.empty(shape, device="meta").stride()
    t = DTensor.from_local(torch.empty(local, device="meta"), cut,
                           placements, run_check=False,
                           shape=torch.Size(shape), stride=stride)
    return t.detach().requires_grad_(grad)


with sh.gspmd_partitioning():
    xc = dtc((128, 1, 1536), [S(0), S(2), S(2)])
    wq = dtc((1536, 1536), [R, S(0), S(0)])
    for whole in (True, False):
        res = {}
        key = f"heads whole={whole}"
        out[key] = cost(lambda: res.setdefault("y", sh.reduced_by_heads(
            torch.matmul, xc, wq, heads=4, whole=whole)))
        out[key].update(where(res["y"]))
    p = dtc((4096,), [R, R, R])
    gp = dtc((4096,), [R, S(0), S(0)])
    with torch.no_grad():
        out["update cut"] = cost(lambda: p.add_(gp))
    out["update cut"].update(where(p))

# a norm's (512,) parameters, their gradients summed over (256, 64)
# tokens; on 16x16 the tokens over "data", on 2x16x16 over "pod" x
# "data"; and AdamW's update reading the scale's gradient
from torch.distributed.tensor.experimental import implicit_replication
from repro_torch.models.layers import layer_norm, rms_norm
from repro_torch.optim.optimizers import AdamW, clip_by_global_norm
for pod in (False, True):
    mesh = m.make_production_mesh(multi_pod=pod)
    tag = " pod" if pod else ""
    tokens, whole = [S(0)] * (mesh.ndim - 1) + [R], [R] * mesh.ndim
    with sh.gspmd_partitioning(), implicit_replication():
        x = dt((256, 64, 512), tokens, grad=True)
        dy = dt((256, 64, 512), tokens)
        scale = dt((512,), whole, grad=True)
        out["rms norm" + tag] = cost(lambda: rms_norm(
            {"scale": scale}, x, 1e-6).backward(dy))
        out["rms norm" + tag].update(where(scale.grad))
        ln = {"scale": dt((512,), whole, grad=True),
              "bias": dt((512,), whole, grad=True)}
        out["layer norm" + tag] = cost(lambda: layer_norm(
            ln, x, 1e-6).backward(dy))
        out["layer norm" + tag]["grads"] = [where(ln["scale"].grad),
                                            where(ln["bias"].grad)]
        state = {"slots": {"scale": {"m": dt((512,), whole),
                                     "v": dt((512,), whole)}},
                 "count": dt((), whole, dtype=torch.int32)}

        def update():
            with torch.no_grad():
                grads, _ = clip_by_global_norm({"scale": scale.grad}, 1.0)
                AdamW().update(grads, state, {"scale": scale},
                               dt((), whole))
        out["adamw" + tag] = cost(update)
        if pod:
            # the long-context decode's scores: batch one, "pod" and
            # "data" free
            q = dt((1, 1, 16, 2, 128), [R, R, S(2)])
            k = dt((1, 4096, 16, 128), [R, R, S(1)])
            res = {}
            out["scores pod"] = cost(lambda: res.setdefault(
                "y", torch.einsum("bsngd,btnd->bnsgt", q, k)))
            out["scores pod"].update(where(res["y"]))

print("RESULT " + json.dumps(out))
"""


# the MoE on a small 3-D mesh ("pod" 2 x "data" 4 x "model" 4), its
# batch split over "pod" x "data"
_POD_CASES = r"""
import json
import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Replicate, Shard
from repro_torch.launch import cost_analysis as ca
from repro_torch.launch import mesh as m
from repro_torch.models import moe
from repro_torch.parallel import sharding as sh

m.init_dry_run_world()
mesh = DeviceMesh("cpu", torch.arange(32).reshape(2, 4, 4),
                  mesh_dim_names=("pod", "data", "model"))
R, S = Replicate(), Shard
BATCH = [S(0), S(0), R]
out = {}


def dt(shape, placements, dtype=torch.float32):
    local = list(shape)
    for i, p in enumerate(placements):
        if p.is_shard():
            local[p.dim] //= mesh.size(i)
    return DTensor.from_local(
        torch.empty(local, device="meta", dtype=dtype), mesh, placements,
        run_check=False, shape=torch.Size(shape),
        stride=torch.empty(shape, device="meta").stride())


def where(t):
    return {"placements": [str(p) for p in t.placements],
            "local": list(t.to_local().shape)}


def case(name, fn):
    res = {}
    c = ca.count_step(lambda: res.setdefault("y", fn()))
    out[name] = {"elements": c.coll_elements,
                 "replicated": c.replicated_ops}
    y = res["y"]
    out[name].update(where(y[0] if isinstance(y, tuple) else y))
    return y


with sh.gspmd_partitioning():
    # the chunked MoE's output, its (8, 16, 32) rows split over "data"
    # alone and replicated over "pod", laid out as the batch
    rows = dt((8, 16, 32), [R, S(0), R])
    case("pod rows back", lambda: moe.rows_laid_out_as(
        rows, dt((8, 16, 32), BATCH)))
    # 32 rows of (4, 8) taken into 4 chunk rows x 8 chunks
    case("pod chunks", lambda: sh.rows_in_chunks(
        dt((32, 4, 8), BATCH), 4, 8))
    # the top-k of (16, 32) scores, and the argsort of 64 expert ids,
    # over the tokens split over "pod" x "data"
    case("pod top-k", lambda: moe._top_k(dt((16, 32), BATCH), 4))
    case("pod argsort", lambda: torch.argsort(
        dt((64,), BATCH, dtype=torch.long), dim=-1, stable=True))
    # the decode's 16 tokens and the zero row joined, gathered into 8
    # experts' buckets of 4 split over "data"; 32 expert rows combined
    # into the 17 rows by a whole index, then cut to the 16 tokens
    xf = dt((16, 8), BATCH)
    x_pad = case("pod cat", lambda: torch.cat([xf, xf.new_zeros((1, 8))]))
    case("pod buckets", lambda: sh.take_rows(
        x_pad, dt((8, 4), [R, S(0), R], dtype=torch.long)))
    y = case("pod combine", lambda: sh.gather_sum(
        dt((32, 8), [R, S(0), R]), dt((17, 2), [R, R, R], dtype=torch.long)))
    case("pod cut", lambda: y[:16])

def grad_case(name, fn, t):
    c = ca.count_step(fn)
    out[name] = {"elements": c.coll_elements, "peak": c.blocks.peak(),
                 "replicated": c.replicated_ops, **where(t.grad)}


# the xLSTM's rules where "pod" x "data" (8 ranks) outrank "model" (4):
# a batch of one leaves both free (the long-context decode); a batch
# over both (the training step) splits the tokens over them
one = [R, R, S(2)]
with sh.gspmd_partitioning():
    # an up projection (64 -> 128, 32 columns a rank) and an unembedding
    # (64 -> 256, 64 columns a rank) of a residual split over "model"
    x = dt((1, 1, 64), one)
    case("pod up", lambda: torch.matmul(x, dt((64, 128), [R, R, S(1)])))
    case("pod unembed", lambda: torch.matmul(x, dt((64, 256), [R, R, S(1)])))
    # the sLSTM's recurrent product, its state's (1, 2, 32) heads over the
    # first factor of "model" cut 2 x 2, the head dim over the second
    cut = m.factor_axis(mesh, "model", (2, 2))
    h = DTensor.from_local(torch.empty((1, 1, 16), device="meta"), cut,
                           [R, R, S(1), S(2)], run_check=False,
                           shape=torch.Size((1, 2, 32)),
                           stride=(64, 32, 1))
    r = DTensor.from_local(torch.empty((2, 32, 128), device="meta"), cut,
                           [R] * 4, run_check=False,
                           shape=torch.Size((2, 32, 128)),
                           stride=(4096, 128, 1))
    like = DTensor.from_local(torch.empty((1, 1, 64), device="meta"), cut,
                              [R, R, S(1), S(2)], run_check=False,
                              shape=torch.Size((1, 2, 128)),
                              stride=(256, 128, 1))
    case("pod state", lambda: sh.product_as(like, torch.einsum,
                                            "bhd,hde->bhe", h, r))
    # an xLSTM embedding lookup: 16 x 8 tokens over "pod" x "data", the
    # (64, 16) table's vocab over "model", its d_model over "data" (the
    # FSDP split); and its gradient
    tokens = dt((16, 8), BATCH, dtype=torch.long)
    table = dt((64, 16), [R, S(1), S(0)]).requires_grad_()
    table.fsdp_dims = (1,)
    dy = dt((16, 8, 16), [S(0), S(0), S(2)])
    with sh.lookup_by_table():
        grad_case("pod lookup", lambda: torch.nn.functional.embedding(
            tokens, table).backward(dy), table)
    # an up projection in the training step: (16, 8, 64) tokens over
    # "pod" x "data", their d_model over "model", times a (64, 128)
    # weight stored split over "data" (its FSDP dim) and "model"; and the
    # sLSTM step's four gates' gradients joined, 2 rows a rank
    xt = dt((16, 8, 64), [S(0), S(0), S(2)]).requires_grad_()
    w = dt((64, 128), [R, S(0), S(1)]).requires_grad_()
    w.fsdp_dims = (0,)
    dy = dt((16, 8, 128), [S(0), S(0), S(2)])
    grad_case("pod up grad", lambda: torch.matmul(xt, w).backward(dy), w)
    pre = dt((16, 256), [S(0), S(0), S(1)]).requires_grad_()
    dys = [dt((16, 64), [S(0), S(0), S(1)]) for _ in range(4)]
    grad_case("pod gates", lambda: torch.autograd.backward(
        torch.chunk(pre, 4, -1), dys), pre)

# the chunked MoE's training step, its batch over "pod" x "data" (8
# ranks) and a chunk's rows over "data" alone (4), "pod" free
from torch.utils.checkpoint import checkpoint
from repro_torch.models import layers
CHUNKS = [R, S(0), R]
with sh.gspmd_partitioning():
    # the router in a chunk step: a chunk's (4, 16, 64) rows times the
    # (64, 32) router stored split over "data" (its FSDP dim), cast
    xc = dt((4, 16, 64), CHUNKS).requires_grad_()
    router = dt((64, 32), [R, S(0), R]).requires_grad_()
    router.fsdp_dims = (0,)
    dlogits = dt((4, 16, 32), CHUNKS)
    grad_case("pod router", lambda: ca.count_as(
        1, lambda: torch.matmul(xc, router.float()), [xc],
        hoist=True).backward(dlogits), router)
    # the chunk loop's (8, 16, 32) output laid out as the batch, and its
    # gradient; then the same in a rematerialized block, whose recompute
    # reads no gradient of it
    rows = dt((8, 16, 32), CHUNKS).requires_grad_()
    like = dt((8, 16, 32), BATCH)
    dy = dt((8, 16, 32), BATCH)
    grad_case("pod rows grad", lambda: moe.rows_laid_out_as(
        rows, like).backward(dy), rows)
    s = dt((8, 16, 32), BATCH).requires_grad_()
    grad_case("pod rows remat", lambda: checkpoint(
        lambda r, t: moe.rows_laid_out_as(r, like) + t.sin(), rows, s,
        use_reentrant=False).backward(dy), rows)
    # the MoE's input, (8, 16, 32) rows over "pod" x "data", into 4
    # chunk rows x 2 chunks, and the shared expert's up projection of it
    # (32 -> 16, its columns over "model"): the input's gradient
    xm = dt((8, 16, 32), BATCH).requires_grad_()
    dup = dt((8, 16, 16), [S(0), S(0), S(2)])
    drows = dt((4, 2, 16, 32), CHUNKS)
    w_up = dt((32, 16), [R, R, S(1)])

    def shared():
        rows = sh.rows_in_chunks(xm, 4, 2)
        up = torch.matmul(sh.grad_in_chunks(xm, rows), w_up)
        torch.autograd.backward([up, rows], [dup, drows])
    grad_case("pod shared grad", shared, xm)
    # an RMS norm of (8, 16, 32) rows over "pod" x "data", its output's
    # gradient in the chunk loop's layout (the MoE's norm) or in the
    # rows' own (a dense layer's)
    xn = dt((8, 16, 32), BATCH).requires_grad_()
    scale = dt((32,), [R, R, R]).requires_grad_()
    for name, dh in (("pod norm grad", dt((8, 16, 32), CHUNKS)),
                     ("pod norm grad dense", dt((8, 16, 32), BATCH))):
        grad_case(name, lambda: layers.rms_norm(
            {"scale": scale}, xn, 1e-6).backward(dh), xn)
        out[name]["scale"] = where(scale.grad)
        scale.grad = None

# an attention step on 16 x 32 tokens over "pod" x "data" (2 rows a
# rank), its positions made whole as the model makes them (an iota
# broadcast over the batch), without a cache (training) and filling one
# (a prefill)
from torch.distributed.tensor.experimental import implicit_replication
from repro_torch.configs import get_smoke_config
from repro_torch.models.attention import self_attention
acfg = get_smoke_config("gemma2-2b")
with sh.gspmd_partitioning(), implicit_replication():
    xa = dt((16, 32, 64), BATCH)
    pa = {"wq": dt((64, 4, 16), [R, R, R]), "wk": dt((64, 2, 16), [R, R, R]),
          "wv": dt((64, 2, 16), [R, R, R]), "wo": dt((4, 16, 64), [R, R, R])}
    pos = torch.arange(32, dtype=torch.int32, device="meta")[None].expand(
        16, 32)
    for name, cache in (("pod mask", None), ("pod mask prefill", {
            "k": dt((16, 32, 2, 16), BATCH), "v": dt((16, 32, 2, 16), BATCH),
            "pos": dt((16, 32), BATCH, dtype=torch.int32)})):
        res = {}
        c = ca.count_step(lambda: res.setdefault("y", self_attention(
            acfg, pa, xa, kind="global", positions=pos, cache=cache,
            compute_dtype=torch.float32)))
        y, new = res["y"]
        at = c.blocks.at_peak()
        out[name] = {"elements": c.coll_elements,
                     "replicated": c.replicated_ops, **where(y),
                     "masks": sorted({w[1] for w in c.blocks.what.values()
                                      if w[2] == "torch.bool"}),
                     "peak": c.blocks.peak(),
                     "at peak": [sum(b[0] for b in at), at[0]]}
        if new is not None:
            p_w = new["pos"]
            out[name]["cache pos"] = list(p_w.to_local().shape
                                          if sh.is_distributed(p_w)
                                          else p_w.shape)
print("RESULT " + json.dumps(out))
"""


def _run(snippet):
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    proc = subprocess.run([sys.executable, "-c", snippet], capture_output=True,
                          text=True, timeout=300, env=env, cwd=ROOT)
    line = [ln for ln in proc.stdout.splitlines() if ln.startswith("RESULT ")]
    assert line, proc.stderr[-3000:]
    return json.loads(line[0][len("RESULT "):])


@pytest.fixture(scope="module")
def cases():
    return _run(_CASES)


@pytest.fixture(scope="module")
def pod_cases():
    return _run(_POD_CASES)


def test_conflicting_splits_make_the_smaller_whole_by_the_free_axis(cases):
    """q's (1, 1, 1, 2, 128) block moves to "data" (one collective-permute)
    and is gathered there (16 x 256 elements); the keys keep their
    sequence split, so the scores are this rank's 256 positions of all
    16 x 2 heads."""
    c = cases["scores"]
    assert c["elements"] == {"collective-permute(g=256)": 256,
                             "all-gather(g=16)": 16 * 2 * 128}
    assert c["dot_flops"] == 2 * 16 * 2 * 128 * 256
    assert c["placements"] == ["R", "S(4)"]


def test_a_product_over_a_split_takes_the_free_axis_for_its_output(cases):
    """The value product contracts the split sequence; its output is
    wanted with q's heads over "model": this rank's head over "data"
    times its 256 positions, the (1, 1, 1, 2, 128) partial sum
    all-reduced over "model" and moved to "model"; with no split
    wanted, the whole head set is reduced."""
    c = cases["values"]
    assert c["dot_flops"] == 2 * 2 * 256 * 128
    assert c["elements"] == {"all-reduce(g=16)": 256,
                             "collective-permute(g=256)": 256}
    assert c["placements"] == ["R", "S(2)"] and c["local"] == [1, 1, 1, 2, 128]
    assert cases["values whole"]["elements"] == {
        "all-reduce(g=16)": 16 * 2 * 128}


def test_a_gate_backward_gathers_the_gradient_for_each_product(cases):
    """(256, 64, 512) tokens over "data" with their 512 over "model",
    times a (512, 512) gate split by rows over "model": forward, the
    product's partial sums all-reduced (the rank's 16 x 64 x 512);
    backward, the output's gradient gathered whole over "model" once
    for each operand's product (two all-gathers), the tokens' gradient
    split as they are with nothing reduced, the gate's summed over the
    rank's tokens and all-reduced over "data" (its 32 x 512 rows)."""
    c = cases["gate"]
    act = 16 * 64 * 512
    assert c["elements"] == {"all-reduce(g=16)": act + 32 * 512,
                             "all-gather(g=16)": 2 * act}
    assert c["dot_flops"] == 3 * 2 * 16 * 64 * 512 * 32
    assert c["grads"][0]["placements"] == ["S(0)", "S(2)"]
    assert c["grads"][1]["placements"] == ["R", "S(0)"]


def test_an_update_in_place_takes_its_operands_split(cases):
    """A whole (4096,) parameter plus a gradient split over "model"
    leaves the update split (this rank's 256), nothing moved; a layer
    of a stacked (3, 4096) moment takes the split with its stack."""
    c = cases["update"]
    assert c["elements"] == {}
    assert c["param"] == {"placements": ["R", "S(0)"], "local": [256]}
    assert c["stack"] == {"placements": ["R", "S(1)"], "local": [3, 256]}
    assert c["layer"] == {"placements": ["R", "S(0)"], "local": [256]}


def test_a_cache_write_gathers_the_entry_on_every_rank(cases):
    """Rank (0, 0) does not hold position 4095 of a cache split over
    "model" along its sequence, yet takes part in gathering the new
    (1, 1, 16, 128) entry split by its heads (the reference's SPMD
    all-gather before its dynamic-update-slice)."""
    c = cases["slot"]
    assert c["coordinate"] == [0, 0]
    assert c["elements"] == {"all-gather(g=16)": 16 * 128}


def test_a_chunk_of_a_split_dim_keeps_each_part_split(cases):
    """(128, 1, 3072) split 16 ways (this rank's 8 x 192): its halves
    keep the split (8 x 96 a rank), each rank's block fetched by XLA's
    four collective-permutes (192 + 3 x 96 wide, the reference's
    f32[8,1,192] and f32[8,1,96] of xlstm-125m decode_32k); its quarters
    by sixteen (ten 48 and six 96 wide)."""
    h = cases["halves"]
    assert h["elements"] == {"collective-permute(g=256)": 8 * (192 + 3 * 96)}
    assert h["placements"] == ["S(0)", "S(2)"] and h["local"] == [8, 1, 96]
    assert cases["quarters"]["elements"] == {
        "collective-permute(g=256)": 8 * (10 * 48 + 6 * 96)}


def test_the_halves_gradients_are_joined_by_all_to_alls(cases):
    """With 16 rows a rank, each half's (16, 1, 96) gradient block and the
    joined (16, 1, 192) go through an all-to-all over "model" (the
    reference's transposed concatenation: XLA moves the split to the
    rows, which "model"'s 16 ranks divide), and the gradient keeps the
    split.  With 8 rows a rank, which they do not divide, each half's
    gradient is gathered whole over "model" (XLA's partition of that
    concatenation: two f32[8,1,1536] all-gathers) and the joined block
    sliced to the split."""
    j = cases["joined rows"]
    assert j["elements"] == {"all-to-all(g=16)": 16 * (96 + 96 + 192)}
    assert j["placements"] == ["S(0)", "S(2)"] and j["local"] == [16, 1, 192]
    j = cases["joined"]
    assert j["elements"] == {"all-gather(g=16)": 2 * 8 * 1536}
    assert j["placements"] == ["S(0)", "S(2)"] and j["local"] == [8, 1, 192]


def test_a_pad_runs_on_the_blocks_along_unsplit_dims(cases):
    """The causal conv's pad of the sequence (unsplit) moves nothing and
    keeps the placements; a pad along the split dim gathers it first."""
    assert cases["pad seq"]["elements"] == {}
    assert cases["pad seq"]["placements"] == ["S(0)", "S(2)"]
    assert cases["pad seq"]["local"] == [1, 4099, 4]
    p = cases["pad split"]
    assert p["elements"] == {"all-gather(g=16)": 4096 * 64}
    assert p["placements"] == ["S(0)", "R"] and p["local"] == [1, 4096, 66]


def test_partial_sums_follow_the_heads_cut(cases):
    """q = xc @ wq, xc's 1536 split 16 ways over "model" cut 4 x 4: its
    (8, 1, 1536) partial sums all-reduced over the first factor, the
    head sliced, its (8, 1, 384) over the second (the reference's q and
    k); with the head dim split too, over all 16 at once, then sliced
    (its v).  On "model" uncut, the walk asks for the 4 x 4 cut."""
    q = cases["heads whole=True"]
    assert q["elements"] == {"all-reduce(g=4)": 8 * 1536 + 8 * 384}
    assert q["placements"] == ["S(0)", "S(2)", "R"]
    assert q["local"] == [8, 1, 384]
    assert q["dot_flops"] == 2 * 8 * 96 * 1536
    v = cases["heads whole=False"]
    assert v["elements"] == {"all-reduce(g=16)": 8 * 1536}
    assert v["placements"] == ["S(0)", "S(2)", "S(2)"]
    assert v["local"] == [8, 1, 96]
    assert cases["cut"] == ["model", [4, 4]]


def test_an_update_takes_its_operands_split_on_a_cut_mesh(cases):
    """On "model" cut 4 x 4, a whole (4096,) parameter plus a gradient
    split over both factors leaves the update split (this rank's 256)."""
    c = cases["update cut"]
    assert c["elements"] == {}
    assert c["placements"] == ["R", "S(0)", "S(0)"] and c["local"] == [256]


@pytest.mark.parametrize("tag,group", [("", 16), (" pod", 32)])
def test_a_norms_gradient_is_reduced_once_where_it_is_made(cases, tag, group):
    """A (512,) norm parameter over (256, 64, 512) tokens: its gradient,
    the sum over the tokens, is all-reduced in the backward, over every
    mesh axis that splits them at once ("data", or "pod" x "data" on
    the 2x16x16 mesh), and leaves it whole: ``rms_norm``'s (1 + scale)
    one vector, ``layer_norm``'s scale and bias two; the inputs'
    gradient moves nothing."""
    rms = cases["rms norm" + tag]
    assert rms["elements"] == {f"all-reduce(g={group})": 512}
    assert set(rms["placements"]) == {"R"} and rms["local"] == [512]
    ln = cases["layer norm" + tag]
    assert ln["elements"] == {f"all-reduce(g={group})": 2 * 512}
    for g in ln["grads"]:
        assert set(g["placements"]) == {"R"} and g["local"] == [512]


@pytest.mark.parametrize("tag", ["", " pod"])
def test_adamw_reads_a_norms_gradient_as_it_was_reduced(cases, tag):
    """The clip's norm and AdamW's two moments read the scale's gradient
    three times, and reduce none of it again (DTensor would all-reduce
    a gradient left partial at each read: 3 x 512 elements): the
    update's one collective is the global norm's scalar, over the
    whole mesh."""
    assert cases["adamw" + tag]["elements"] == {
        f"all-reduce(g={256 * (2 if tag else 1)})": 1}


def test_decode_scores_gather_the_queries_by_both_free_axes(cases):
    """On 2x16x16, with the batch of one leaving "pod" and "data" free,
    q's (1, 1, 1, 2, 128) block is regrouped over "model" (two
    collective-permutes), moved to the 32 ranks of "pod" x "data" (one
    more) and gathered there by an all-reduce of the 16 x 2 x 128
    queries over the 32 (the reference's gemma2-27b long_500k), not by
    an all-gather over "data" alone; the keys keep their sequence
    split."""
    c = cases["scores pod"]
    assert c["elements"] == {"collective-permute(g=512)": 3 * 256,
                             "all-reduce(g=32)": 16 * 2 * 128}
    assert c["dot_flops"] == 2 * 16 * 2 * 128 * 256
    assert c["placements"] == ["R", "R", "S(4)"]
    assert c["local"] == [1, 16, 1, 2, 256]


def test_an_up_projection_is_contracted_over_pod_and_data(pod_cases):
    """With a batch of one, "pod" x "data" (8 ranks) free and outranking
    "model" (4), a (1, 1, 64) residual split over "model" (16 a rank)
    into a (64, 128) up projection: each rank's block cut in two, one
    half moved to the rank of its index over the 8 (a collective-permute
    of 8), the product run on those 8 rows and its (1, 1, 32) partial
    sums all-reduced over the 8 at once (the reference's f32[1,1,192] of
    xlstm-125m long_500k on 2x16x16), not moved to "data" alone and
    reduced over its 4.  Into the (64, 256) unembedding, wider than the
    residual, the moved halves are gathered over the 8 instead."""
    c = pod_cases["pod up"]
    assert c["elements"] == {"collective-permute(g=32)": 8,
                             "all-reduce(g=8)": 32}
    assert c["placements"] == ["R", "R", "S(2)"] and c["local"] == [1, 1, 32]
    assert c["replicated"] == {}
    u = pod_cases["pod unembed"]
    assert u["elements"] == {"collective-permute(g=32)": 8,
                             "all-gather(g=8)": 64}
    assert u["local"] == [1, 1, 64]


def test_the_slstm_state_is_gathered_over_pod_and_data(pod_cases):
    """The sLSTM's recurrent product with "model" cut 2 x 2, its (1, 2,
    32) state's head dim split over the second factor (16 a rank): the
    state re-cut to the 8 ranks of "pod" x "data" (a collective-permute
    of 4) and all-gathered over the 8 at once (the reference's
    f32[1,1,6] and f32[1,1,192] of xlstm-125m long_500k on 2x16x16), the
    output split as the gates are."""
    c = pod_cases["pod state"]
    assert c["elements"] == {"collective-permute(g=32)": 4,
                             "all-gather(g=8)": 32}
    assert c["placements"] == ["R", "R", "S(1)", "S(2)"]
    assert c["replicated"] == {}


def test_the_lookups_table_gradient_is_reduced_once(pod_cases):
    """An xLSTM lookup of 16 x 8 tokens over "pod" x "data" in a (64, 16)
    table, vocab over "model", d_model over "data": the table's splits
    swapped (a collective-permute of its (16, 4) block) and its vocab
    gathered over "data" (256); in the backward, the table's gradient
    all-reduced over the 8 at once and moved back (the reference's
    all-reduce(g=32) and permute of xlstm-125m train_4k), left as the
    table is stored, partial over no axis, so that the optimizer reads
    it as it is."""
    c = pod_cases["pod lookup"]
    assert c["elements"] == {"collective-permute(g=32)": 2 * 16 * 4,
                             "all-gather(g=4)": 64 * 4,
                             "all-reduce(g=8)": 64 * 4}
    assert c["placements"] == ["R", "S(1)", "S(0)"] and c["local"] == [16, 4]
    assert c["replicated"] == {}


def test_an_up_projections_weight_gradient_is_reduced_in_stages(pod_cases):
    """A training step's up projection, tokens over "pod" x "data", the
    (64, 128) weight stored over "data" and "model": its gradient's
    (64, 32) partial sums all-reduced over "data", sliced to the stored
    (16, 32) block and that over "pod" (the reference's f32[768,192] and
    f32[48,192] of each xlstm-125m train_4k up projection on 2x16x16),
    not over the 8 at once; the input's gradient reduced over "model"."""
    c = pod_cases["pod up grad"]
    assert c["elements"] == {"all-gather(g=4)": 2 * 2 * 8 * 64 + 64 * 32,
                             "all-reduce(g=4)": 2 * 8 * 64 + 64 * 32,
                             "all-reduce(g=2)": 16 * 32}
    assert c["placements"] == ["R", "S(0)", "S(1)"] and c["local"] == [16, 32]


def test_the_slstm_gates_gradients_are_gathered_where_rows_are_few(
        pod_cases):
    """The sLSTM step's (16, 256) gate pre-activations over "pod" x "data"
    (2 rows a rank) and "model" chunked into four gates; their gradients
    joined: 2 rows cannot split 4 ways, so each gate's gradient is
    gathered whole over "model" (four all-gathers of 2 x 64) and the
    joined rows sliced to the split (the reference's four f32[8,768] a
    step of xlstm-125m train_4k on 2x16x16), not all-to-all'd."""
    c = pod_cases["pod gates"]
    assert c["elements"]["all-gather(g=4)"] == 4 * 2 * 64
    assert not any(k.startswith("all-to-all") for k in c["elements"])
    assert c["placements"] == ["S(0)", "S(0)", "S(1)"] and c["local"] == [2, 64]


@pytest.mark.parametrize("name", ["pod mask", "pod mask prefill"])
def test_the_attention_mask_holds_the_ranks_own_rows(pod_cases, name):
    """An attention step on (16, 32, 64) tokens over "pod" x "data" (2
    rows a rank), its positions an iota broadcast over the batch, whole
    on every rank: the mask's every block holds the rank's 2 rows, not
    the 16 of the whole batch (``sharding.rows_split_as``), with no
    collective and no op run replicated; a prefill's new cache keeps its
    positions whole, as the reference's output does.  The blocks live at
    the walk's peak (``Blocks.at_peak``) add up to it."""
    c = pod_cases[name]
    assert c["masks"] == [[2, 1, 32], [2, 32, 32]]
    assert c["elements"] == {} and c["replicated"] == {}
    assert c["placements"] == ["S(0)", "S(0)", "R"]
    assert c["local"] == [2, 32, 64]
    # the largest, the scores' (2, 2, 32, 2, 32) f32 block
    assert c["at peak"][0] == c["peak"]
    assert c["at peak"][1][0] == 2 * 2 * 32 * 2 * 32 * 4
    assert c["at peak"][1][2] == [2, 2, 32, 2, 32]
    if name.endswith("prefill"):
        assert c["cache pos"] == [16, 32]


def test_the_gold_gathers_gradient_is_a_block_of_the_logits(cases):
    """The gold logit gathered from (256, 16, 4096) f32 logits split
    (16 x 256) a rank and constrained as ``softmax_xent`` constrains it:
    its gradient is the logits' (16, 16, 256) block, in the logits'
    placements, with no collective and no op run replicated, and the
    backward holds that block and the rows (271,620 B), not the
    (256, 16, 4096) f32 zeros, 16 MiB, that DTensor's ``gather_backward``
    makes replicated.  With the vocab whole over "model" the block is
    (16, 16, 4096), split over "data" alone.  The whole cross-entropy's
    backward keeps the split too (its one all-reduce is the
    log-sum-exp's 256 rows, with or without the rule)."""
    block = 16 * 16 * 256 * 4
    gold = cases["xent gold"]
    assert gold["elements"] == {} and gold["replicated"] == {}
    assert gold["placements"] == ["S(0)", "S(2)"]
    assert gold["local"] == [16, 16, 256]
    assert block <= gold["peak"] < 2 * block
    whole = cases["xent whole gold"]
    assert whole["elements"] == {} and whole["replicated"] == {}
    assert whole["placements"] == ["S(0)", "R"]
    assert whole["local"] == [16, 16, 4096]
    assert 16 * block <= whole["peak"] < 2 * 16 * block
    xent = cases["xent"]
    assert xent["elements"] == {"all-reduce(g=16)": 16 * 16}
    assert xent["replicated"] == {} and xent["local"] == [16, 16, 256]
    assert xent["placements"] == ["S(0)", "S(2)"]
    assert xent["peak"] < 256 * 16 * 4096 * 4 // 16
    assert cases["xent whole"]["placements"] == ["S(0)", "R"]


def test_moe_rows_come_back_laid_out_as_the_batch(pod_cases):
    """On a small 3-D mesh ("pod" 2 x "data" 4 x "model" 4) the chunked
    MoE's output, (8, 16, 32) rows split over "data" alone and
    replicated over "pod", comes back laid out as the batch, over "pod"
    x "data", by the function ``models/moe.py`` calls
    (``moe.rows_laid_out_as``; the name once resolved to the mLSTM
    state's layout, which returned the rows as they were): each rank
    sends its whole (2, 16, 32) block to one rank, which keeps its half
    (one collective-permute, as the reference's chunk loop sends each
    chunk's combined rows)."""
    c = pod_cases["pod rows back"]
    assert c["placements"] == ["S(0)", "S(0)", "R"]
    assert c["local"] == [1, 16, 32]
    assert c["elements"] == {"collective-permute(g=32)": 2 * 16 * 32}
    assert c["replicated"] == {}


def test_rows_split_over_two_axes_are_placed_as_chunks(pod_cases):
    """32 rows split over "pod" x "data" (4 a rank) taken into 4 chunk
    rows x 8 chunks, fewer chunk rows than the 8 ranks: placed, not run
    replicated, as the reference's scan reads them — each chunk's rows
    over "data", the chunks whole — by one collective-permute of the
    rank's 4 rows and an all-gather of the 8 chunks over "pod"."""
    c = pod_cases["pod chunks"]
    assert c["replicated"] == {}
    assert c["placements"] == ["R", "S(0)", "R"]
    assert c["local"] == [1, 8, 4, 8]
    assert c["elements"] == {"collective-permute(g=32)": 4 * 4 * 8,
                             "all-gather(g=2)": 8 * 4 * 8}


@pytest.mark.parametrize("name,elements", [("pod top-k", 16 * 32),
                                           ("pod argsort", 64)])
def test_a_sort_over_two_axes_gathers_once(pod_cases, name, elements):
    """The top-k of (16, 32) scores, and the argsort of 64 expert ids,
    whose tokens split over "pod" x "data": the operand gathered over
    the 8 ranks in one all-gather (DTensor gathers over "data", then
    "pod")."""
    c = pod_cases[name]
    assert c["elements"] == {"all-gather(g=8)": elements}
    assert c["replicated"] == {}


def test_the_decode_join_and_buckets_go_over_both_axes(pod_cases):
    """The 16 tokens over "pod" x "data" joined with the zero row: moved
    to the feature dim by one all-to-all over the 8 (2 x 8), joined,
    moved back padded to 24 rows (3 x 8), 3 rows a rank.  Gathered into
    8 experts' buckets of 4 split over "data": the rows' "data" split
    moved to "model" (a collective-permute of the 3 rows), each rank's
    gathered rows all-reduced over "pod" x "model" at once (2 x 4 x 8),
    the product of the mesh dims that split the rows."""
    cat = pod_cases["pod cat"]
    assert cat["elements"] == {"all-to-all(g=8)": 2 * 8 + 3 * 8}
    assert cat["placements"] == ["S(0)", "S(0)", "R"]
    assert cat["local"] == [3, 8]
    b = pod_cases["pod buckets"]
    assert b["elements"] == {"collective-permute(g=32)": 3 * 8,
                             "all-reduce(g=8)": 2 * 4 * 8}
    assert b["placements"] == ["R", "S(0)", "R"]


def test_the_router_contracts_over_pod_and_model(pod_cases):
    """A chunk's (4, 16, 64) rows over "data" alone, "pod" free, times
    the (64, 32) router stored split over "data": the router's split
    moved to "pod" x "model" (8 ranks, twice "data"'s 4) in halves (8
    rows a rank, a collective-permute), the product contracted there
    and its logits all-reduced over the 8 at once; backward, the router
    moved again and gathered whole over the 8 for the rows' gradient,
    its own gradient made over "model" (16 rows a rank), all-reduced
    over "data" and moved back there (the reference's router of
    deepseek-v3-671b train_4k on the 2x16x16 mesh; over "model" alone,
    the logits were all-reduced over "model" on both pods)."""
    c = pod_cases["pod router"]
    assert c["elements"] == {"collective-permute(g=32)": 8 * 32 * 2
                             + 16 * 32,
                             "all-reduce(g=8)": 16 * 32,
                             "all-gather(g=8)": 64 * 32,
                             "all-reduce(g=4)": 16 * 32}
    assert c["placements"] == ["R", "S(0)", "R"] and c["local"] == [16, 32]
    assert c["replicated"] == {}


def test_the_rows_gradient_goes_back_into_chunks_whole(pod_cases):
    """The chunk loop's output laid out as the batch (one permute of
    each rank's (2, 16, 32) block); its gradient, (1, 16, 32) a rank,
    all-gathered over pairs of "data" ranks and sent back whole, so
    that both pods' copies of the rows take the whole gradient (the
    reference's all-gather and permutes of deepseek-v3-671b train_4k's
    backward; a zero-padded block sent back left it partial over
    "pod").  In a rematerialized block the recompute moves nothing: no
    gradient reads the regrouped rows."""
    c = pod_cases["pod rows grad"]
    assert c["elements"] == {"collective-permute(g=32)": 2 * 2 * 16 * 32,
                             "all-gather(g=2)": 2 * 16 * 32}
    assert c["placements"] == ["R", "S(0)", "R"] and c["local"] == [2, 16, 32]
    assert c["replicated"] == {}
    assert pod_cases["pod rows remat"]["elements"] == c["elements"]


def test_the_shared_experts_input_gradient_is_made_in_chunks(pod_cases):
    """The MoE's input into chunks (a permute of each rank's row, the
    chunks all-gathered over "pod") and the shared expert's up
    projection of it: the projection's input gradient made on 2 rows a
    rank — its output's gradient all-gathered over pairs of "data"
    ranks —, all-reduced over "model" and permuted into the chunk
    loop's layout, where the chunks' gradient stays (nothing moves),
    the input's gradient summed there: 2 rows a rank over "data",
    replicated over "pod" (``grad_in_chunks``, ``product_into_chunks``;
    the reference's shared expert of deepseek-v3-671b train_4k)."""
    c = pod_cases["pod shared grad"]
    assert c["elements"] == {"collective-permute(g=32)": 16 * 32
                             + 2 * 16 * 32,
                             "all-gather(g=2)": 2 * 16 * 32 + 2 * 16 * 4,
                             "all-reduce(g=4)": 2 * 16 * 32}
    assert c["placements"] == ["R", "S(0)", "R"] and c["local"] == [2, 16, 32]
    assert c["replicated"] == {}


def test_a_norms_gradient_from_chunks_rematerializes_whole(pod_cases):
    """An RMS norm of rows over "pod" x "data" whose output's gradient
    comes back in the chunk loop's layout (over "data", 2 rows a rank):
    XLA's involuntary full rematerialization for the scale's gradient —
    the normalized input gathered whole over the 8 and the gradient
    over "data", their product summed on every rank, no all-reduce
    (``involuntary_full_remat``) — and, for the input's gradient, the
    statistic permuted and all-gathered over "pod" into the chunks'
    layout, two gradients sliced and permuted out of it
    (``rows_regrouped_pointwise``).  A dense layer's norm, its output's
    gradient in the rows' own layout: no fallback, the scale's gradient
    all-reduced over "pod" x "data" once.  The step's working memory
    holds the two wholes (16 KiB each) beyond the dense layer's."""
    whole = 8 * 16 * 32 * 4
    c = pod_cases["pod norm grad"]
    assert c["elements"] == {"all-gather(g=8)": 8 * 16 * 32,
                             "all-gather(g=4)": 8 * 16 * 32,
                             "all-gather(g=2)": 2 * 16,
                             "collective-permute(g=32)": 16 + 2 * 16 * 32}
    assert c["placements"] == ["S(0)", "S(0)", "R"] and c["local"] == [1, 16, 32]
    assert c["scale"]["placements"] == ["R", "R", "R"]
    assert c["replicated"] == {}
    dense = pod_cases["pod norm grad dense"]
    assert dense["elements"] == {"all-reduce(g=8)": 32}
    assert c["peak"] - dense["peak"] >= 2 * whole
    assert dense["placements"] == c["placements"]
    assert dense["scale"]["placements"] == ["R", "R", "R"]


def test_the_decode_combine_reduces_on_blocks_over_both_free_axes(pod_cases):
    """32 expert rows split over "data" combined into 17 token rows by a
    whole index: the output's rows over "pod" x "model" (3 a rank of
    the 8 blocks), each block's partial sums all-reduced over "data"
    and moved to "pod" x "data" by one collective-permute; cut to the
    16 tokens, 2 a rank, by XLA's re-cut (``_recut_plan``: permutes of
    3, 1 and 1 rows)."""
    c = pod_cases["pod combine"]
    assert c["elements"] == {"all-reduce(g=4)": 3 * 8,
                             "collective-permute(g=32)": 3 * 8}
    assert c["placements"] == ["S(0)", "S(0)", "R"] and c["local"] == [3, 8]
    cut = pod_cases["pod cut"]
    assert cut["elements"] == {"collective-permute(g=32)": (3 + 1 + 1) * 8}
    assert cut["placements"] == ["S(0)", "S(0)", "R"]
    assert cut["local"] == [2, 8]


def _xent_inputs():
    """Logits, targets (some < 0) and a mask (one row masked), numpy,
    seeded."""
    rng = np.random.default_rng(0)
    logits = rng.standard_normal(XENT_SHAPE).astype(np.float32)
    targets = rng.integers(0, XENT_SHAPE[2], XENT_SHAPE[:2])
    targets[0, :2] = -1
    targets[3, 5] = -100
    mask = np.ones(XENT_SHAPE[:2], np.int32)
    mask[1] = 0
    return logits, targets, mask


def _gold_nll(logits, targets, mask):
    """``softmax_xent``'s gold term alone, as it computes it: the mean
    over the valid tokens of the gathered logit, negated."""
    from repro_torch.parallel.sharding import constrain
    valid = (targets >= 0) & (mask > 0)
    t = torch.clamp_min(targets, 0).long()
    gold = constrain(torch.gather(logits, -1, t[..., None]),
                     "batch", "seq", None)[..., 0]
    return -torch.sum(gold * valid) / torch.clamp_min(torch.sum(valid), 1)


def _xent_grads(logits, targets, mask):
    """The logits' gradients of ``softmax_xent`` and of its gold term."""
    from repro_torch.models.model import softmax_xent
    return [torch.autograd.grad(f(logits, targets, mask), logits)[0]
            for f in (softmax_xent, _gold_nll)]


def _worker(rank: int, store: str, out_dir: str):
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Replicate, Shard
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, DATA * MODEL),
                            rank=rank, world_size=DATA * MODEL)
    try:
        from repro_torch.launch.mesh import make_host_mesh
        from repro_torch.parallel import sharding as sh
        mesh = make_host_mesh(data=DATA, model=MODEL, device="cpu")
        logits, targets, mask = (torch.from_numpy(a) for a in _xent_inputs())
        rows = [Shard(0), Replicate()]
        x = DTensor.from_local(logits, mesh, [Replicate()] * 2).redistribute(
            mesh, [Shard(0), Shard(2)]).detach().requires_grad_()
        t, m = (DTensor.from_local(a, mesh, [Replicate()] * 2).redistribute(
            mesh, rows) for a in (targets, mask))
        with sh.activate(mesh, sh.make_rules("train")), \
                sh.gspmd_partitioning():
            grads = _xent_grads(x, t, m)
        for g in grads:
            assert list(g.placements) == [Shard(0), Shard(2)], g.placements
            assert tuple(g.to_local().shape) == (2, 6, 4)
        full = [g.full_tensor().numpy() for g in grads]
        np.savez(Path(out_dir) / f"rank{rank}.npz", xent=full[0],
                 gold=full[1])
    finally:
        dist.destroy_process_group()


def test_the_gold_gathers_gradient_on_a_gloo_world_is_bit_exact(tmp_path):
    """On a 2 x 4 ("data", "model") gloo world of real CPU blocks, (4, 6,
    16) f32 logits split over both: the gold term's gradient assembled
    from every rank's block equals ``torch.autograd.grad`` of the
    unpartitioned term bit for bit (targets < 0 and a masked row
    included), and the whole ``softmax_xent``'s within ``XENT_RTOL`` of
    its largest magnitude (its log-sum-exp is reduced over the vocab's
    blocks, in another order)."""
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src") + os.pathsep + str(ROOT / "tests")
    env.setdefault("GLOO_SOCKET_IFNAME", "lo")
    world = subprocess.run(
        [sys.executable, __file__, str(tmp_path / "store"), str(tmp_path)],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=300)
    assert world.returncode == 0, world.stderr[-3000:]
    logits, targets, mask = (torch.from_numpy(a) for a in _xent_inputs())
    want = _xent_grads(logits.requires_grad_(), targets, mask)
    want = [w.numpy() for w in want]
    # 24 tokens: row 1 masked (6), three targets < 0
    assert (want[1] != 0).sum() == 24 - 6 - 3
    for rank in range(DATA * MODEL):
        got = np.load(tmp_path / f"rank{rank}.npz")
        np.testing.assert_array_equal(got["gold"], want[1])
        err = np.abs(got["xent"] - want[0]).max() / np.abs(want[0]).max()
        assert err <= XENT_RTOL, (rank, err)


if __name__ == "__main__":
    import torch.multiprocessing as mp
    mp.start_processes(_worker, args=(sys.argv[1], sys.argv[2]),
                       nprocs=DATA * MODEL, start_method="spawn")
