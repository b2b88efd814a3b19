"""Each numeric function of the port's LM stack against its JAX
counterpart in the reference, on the CPU, on the same numpy-seeded
inputs (and, for the blocks, the reference's parameters carried across).

Tolerances, float32 throughout: ``ATOL = RTOL = 2e-5`` for the layers,
RoPE, attention and MoE; ``REC_TOL = 5e-5`` for the recurrences (the
mLSTM's chunkwise exponentials, the sLSTM and the RG-LRU, whose scan
adds in another tree order than ``lax.associative_scan``).  Index
outputs (top-k ids, dispatch buckets, int8 KV values) must be equal.
Every comparison prints its worst error.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jget
from repro.models import attention as jattn
from repro.models import layers as jl
from repro.models import moe as jmoe
from repro.models import params as JP
from repro.models import ssm as jssm
from repro.models import transformer as jT
from repro_torch.configs import get_smoke_config as tget
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tl
from repro_torch.models import moe as tmoe
from repro_torch.models import params as P
from repro_torch.models import ssm as tssm
from repro_torch.models import transformer as tT

torch.set_num_threads(1)

ATOL = RTOL = 2e-5
REC_TOL = 5e-5


def _rng(seed):
    return np.random.default_rng(seed)


def _n(rng, *shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, what, tol=ATOL):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.max(np.abs(got - want))) if got.size else 0.0
    print(f"{what}: max abs err {err:.3e}")
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol, err_msg=what)


def _params(spec, seed, cfg_dtype="float32"):
    """The reference's draw of ``spec`` (JAX arrays) and the same values
    as torch tensors (a plain dict tree)."""
    jp = JP.init(spec, jax.random.key(seed), cfg_dtype)
    return jp, jax.tree.map(lambda a: _t(np.asarray(a)), jp)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def test_norms_softcap_and_activations():
    r = _rng(0)
    x = _n(r, 2, 5, 16, scale=3.0)
    scale, bias = _n(r, 16), _n(r, 16)
    _close(tl.rms_norm({"scale": _t(scale)}, _t(x), 1e-6),
           jl.rms_norm({"scale": scale}, jnp.asarray(x), 1e-6), "rms_norm")
    _close(tl.layer_norm({"scale": _t(scale), "bias": _t(bias)}, _t(x), 1e-5),
           jl.layer_norm({"scale": scale, "bias": bias}, jnp.asarray(x),
                         1e-5), "layer_norm")
    _close(tl.softcap(_t(x), 2.5), jl.softcap(jnp.asarray(x), 2.5),
           "softcap")
    assert tl.softcap(_t(x), 0.0).equal(_t(x))
    g, u = _n(r, 3, 8), _n(r, 3, 8)
    _close(tl.swiglu(_t(g), _t(u)), jl.swiglu(g, u), "swiglu")
    _close(tl.geglu(_t(g), _t(u)), jl.geglu(g, u), "geglu (tanh gelu)")
    # bf16 rms norm: statistics in f32, result rounded to bf16 once
    xb = _t(x).to(torch.bfloat16)
    jb = jnp.asarray(x, jnp.bfloat16)
    _close(tl.rms_norm({"scale": _t(scale)}, xb, 1e-6),
           jl.rms_norm({"scale": scale}, jb, 1e-6), "rms_norm bf16",
           tol=1e-2)


@pytest.mark.parametrize("gated,bias,act", [(True, False, "silu"),
                                            (True, False, "gelu"),
                                            (False, True, "gelu"),
                                            (False, False, "silu")])
def test_ffn(gated, bias, act):
    spec = jl.ffn_spec(16, 40, gated, bias)
    assert {k: tuple(v) for k, v in P.leaves(tl.ffn_spec(16, 40, gated,
                                                         bias))} == \
        {k: tuple(v) for k, v in spec.items()}
    jp, tp = _params(spec, 1)
    if bias:   # non-zero biases, so that they count
        r = _rng(9)
        for k in ("b_up", "b_down"):
            v = _n(r, *jp[k].shape)
            jp[k], tp[k] = jnp.asarray(v), _t(v)
    x = _n(_rng(2), 2, 3, 16)
    _close(tl.ffn(tp, _t(x), torch.float32, act),
           jl.ffn(jp, jnp.asarray(x), jnp.float32, act), f"ffn {gated} "
           f"{bias} {act}")


def test_embed_unembed_linear():
    r = _rng(3)
    table = _n(r, 50, 16)
    toks = r.integers(0, 50, (2, 7)).astype(np.int32)
    _close(tl.embed({"table": _t(table)}, _t(toks), torch.float32),
           jl.embed({"table": table}, jnp.asarray(toks), jnp.float32),
           "embed")
    x = _n(r, 2, 7, 16)
    _close(tl.unembed({"table": _t(table)}, _t(x), torch.float32),
           jl.unembed({"table": table}, jnp.asarray(x), jnp.float32),
           "unembed")
    w, b = _n(r, 16, 9), _n(r, 9)
    _close(tl.linear({"w": _t(w), "b": _t(b)}, _t(x), torch.float32),
           jl.linear({"w": w, "b": b}, jnp.asarray(x), jnp.float32),
           "linear")


@pytest.mark.parametrize("theta", [10_000.0, 1_000_000.0])
def test_rope(theta):
    r = _rng(4)
    x = _n(r, 2, 9, 3, 16)
    pos = np.stack([np.arange(9), np.arange(40, 49)]).astype(np.int32)
    _close(tl.rope_freqs(16, theta), jl.rope_freqs(16, theta), "freqs")
    _close(tl.apply_rope(_t(x), _t(pos), theta),
           jl.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta),
           f"rope theta={theta}")


@pytest.mark.parametrize("sections", [(4, 2, 2), (2, 3, 3), (16, 24, 24)])
def test_mrope(sections):
    d = 2 * sum(sections)
    r = _rng(5)
    x = _n(r, 2, 6, 2, d)
    pos = r.integers(0, 50, (3, 2, 6)).astype(np.int32)
    _close(tl.apply_mrope(_t(x), _t(pos), 1e6, sections),
           jl.apply_mrope(jnp.asarray(x), jnp.asarray(pos), 1e6, sections),
           f"mrope {sections}")


# ---------------------------------------------------------------------------
# attention cores
# ---------------------------------------------------------------------------

def _qkv(seed, b, s, h, kv, d, t=None):
    r = _rng(seed)
    t = t or s
    return _n(r, b, s, h, d), _n(r, b, t, kv, d), _n(r, b, t, kv, d)


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 5), (False, 0)])
def test_build_mask(causal, window):
    qpos = np.array([[0, 1, 2, 3], [5, 6, 7, 8]], np.int32)
    kpos = np.array([[-1, 0, 1, 2, 3, 4], [3, 4, 5, 6, 7, -1]], np.int32)
    got = tattn._build_mask(_t(qpos), _t(kpos), causal, window).numpy()
    want = np.asarray(jattn._build_mask(jnp.asarray(qpos), jnp.asarray(kpos),
                                        causal, window))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("impl,cap,window", [
    ("naive", 0.0, 0), ("naive", 50.0, 0), ("naive", 5.0, 12),
    ("chunked", 0.0, 0), ("chunked", 30.0, 24)])
def test_dot_attention(impl, cap, window):
    b, s, h, kv, d = 2, 64, 4, 2, 16
    q, k, v = _qkv(6, b, s, h, kv, d)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32)[None], (b, s))
    jm = jattn._build_mask(jnp.asarray(pos), jnp.asarray(pos), True,
                           window)[:, None, None]
    tm = tattn._build_mask(_t(pos), _t(pos), True, window)[:, None, None]
    want = jattn._dot_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), jm, 0.25, cap, impl, 16)
    got = tattn._dot_attention(_t(q), _t(k), _t(v), tm, 0.25, cap, impl, 16)
    _close(got, want, f"_dot_attention {impl} cap={cap} window={window}")


def test_dot_attention_bf16_scores_are_f32():
    """bf16 q/k/v: the scores are float32 sums of bf16 products, the
    probabilities cast back to bf16 — as the reference's
    preferred_element_type=float32."""
    b, s, h, kv, d = 1, 32, 4, 1, 64
    q, k, v = (a * 4 for a in _qkv(7, b, s, h, kv, d))
    m = np.tril(np.ones((s, s), bool))[None, None, None]
    want = jattn._dot_attention(*(jnp.asarray(a, jnp.bfloat16)
                                  for a in (q, k, v)), jnp.asarray(m),
                                0.125, 50.0)
    got = tattn._dot_attention(*(_t(a).to(torch.bfloat16) for a in (q, k, v)),
                               _t(m), 0.125, 50.0)
    assert got.dtype == torch.bfloat16
    _close(got, want, "_dot_attention bf16", tol=2e-2)


@pytest.mark.parametrize("s,window,block_q", [(96, 32, 32), (80, 16, 64),
                                              (64, 64, 2048)])
def test_sliding_attention_blocked(s, window, block_q):
    b, h, kv, d = 2, 4, 2, 8
    q, k, v = _qkv(8, b, s, h, kv, d)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32)[None], (b, s)).copy()
    want = jattn._sliding_attention_blocked(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos),
        window, 0.3, 20.0, block_q)
    got = tattn._sliding_attention_blocked(_t(q), _t(k), _t(v), _t(pos),
                                           window, 0.3, 20.0, block_q)
    _close(got, want, f"blocked s={s} window={window}")


def test_quant_dequant_kv():
    x = _n(_rng(9), 2, 5, 3, 16, scale=2.0)
    x[0, 0, 0] = 0.0                        # all-zero row: scale floor
    jq, js = jattn._quant_kv(jnp.asarray(x))
    tq, ts = tattn._quant_kv(_t(x))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    _close(ts, js, "kv scales")
    _close(tattn._dequant_kv(tq, ts, torch.float32),
           jattn._dequant_kv(jq, js, jnp.float32), "dequant")


# ---------------------------------------------------------------------------
# self / cross attention with caches, and MLA
# ---------------------------------------------------------------------------

def _attn_case(arch, **over):
    jc = jget(arch).replace(compute_dtype="float32", **over)
    tc = tget(arch).replace(compute_dtype="float32", **over)
    return jc, tc


def _jcache(jc, kind, b, max_len):
    spec = jattn.cache_entry_spec(jc, kind, b, max_len)
    c = JP.init(spec, jax.random.key(0), "float32")
    c["pos"] = jnp.full_like(c["pos"], -1) if "pos" in c else None
    return {k: v for k, v in c.items() if v is not None}


def _tcache(tc, kind, b, max_len):
    spec = tattn.cache_entry_spec(tc, kind, b, max_len)
    return {k: torch.full(s.shape, -1 if k == "pos" else 0,
                          dtype=P.torch_dtype(s.dtype or "float32"))
            for k, s in spec.items()}


@pytest.mark.parametrize("arch,kind,over", [
    ("gemma2-2b", "local", {}),             # softcap, ring window 16
    ("gemma2-2b", "global", {}),
    ("gemma3-4b", "global", {}),            # qk-norm, global theta
    ("gemma2-2b", "local", {"kv_cache_quant": True}),
    ("gemma2-2b", "global", {"attn_impl": "chunked", "attn_chunk": 8}),
    ("gemma2-27b", "local", {"attn_impl": "blocked"}),
])
def test_self_attention_prefill_and_ring_decode(arch, kind, over):
    """Full-sequence attention, then a prefill of 20 tokens into a cache
    of 28 slots (a local layer's ring holds 16), then 8 decode steps
    that wrap the ring; outputs and the cache's positions against the
    reference at every step."""
    jc, tc = _attn_case(arch, **over)
    spec = jattn.attn_spec(jc, kind)
    jp, tp = _params(spec, 10)
    b, s0, total = 2, 20, 28
    x = _n(_rng(11), b, total, jc.d_model)
    pos = np.broadcast_to(np.arange(total, dtype=np.int32)[None],
                          (b, total)).copy()
    jy, _ = jattn.self_attention(jc, jp, jnp.asarray(x), kind=kind,
                                 positions=jnp.asarray(pos),
                                 compute_dtype=jnp.float32)
    ty, _ = tattn.self_attention(tc, tp, _t(x), kind=kind, positions=_t(pos),
                                 compute_dtype=torch.float32)
    _close(ty, jy, f"{arch} {kind} {over} full")
    jcache, tcache = _jcache(jc, kind, b, total), _tcache(tc, kind, b, total)
    jy, jcache = jattn.self_attention(
        jc, jp, jnp.asarray(x[:, :s0]), kind=kind,
        positions=jnp.asarray(pos[:, :s0]), cache=jcache,
        cache_index=jnp.asarray(0, jnp.int32), compute_dtype=jnp.float32)
    ty, tcache = tattn.self_attention(
        tc, tp, _t(x[:, :s0]), kind=kind, positions=_t(pos[:, :s0]),
        cache=tcache, cache_index=0, compute_dtype=torch.float32)
    _close(ty, jy, f"{arch} {kind} {over} prefill")
    np.testing.assert_array_equal(tcache["pos"].numpy(),
                                  np.asarray(jcache["pos"]))
    for t in range(s0, total):
        jy, jcache = jattn.self_attention(
            jc, jp, jnp.asarray(x[:, t:t + 1]), kind=kind,
            positions=jnp.asarray(pos[:, t:t + 1]), cache=jcache,
            cache_index=jnp.asarray(t, jnp.int32), compute_dtype=jnp.float32)
        ty, tcache = tattn.self_attention(
            tc, tp, _t(x[:, t:t + 1]), kind=kind, positions=_t(pos[:, t:t + 1]),
            cache=tcache, cache_index=t, compute_dtype=torch.float32)
        _close(ty, jy, f"{arch} {kind} {over} decode {t}")
        np.testing.assert_array_equal(tcache["pos"].numpy(),
                                      np.asarray(jcache["pos"]))
        if over.get("kv_cache_quant"):
            np.testing.assert_array_equal(tcache["k"].numpy(),
                                          np.asarray(jcache["k"]))


def test_cross_attention():
    jc, tc = _attn_case("whisper-base")
    jp, tp = _params(jattn.attn_spec(jc, "cross"), 12)
    r = _rng(13)
    x, src = _n(r, 2, 5, jc.d_model), _n(r, 2, 16, jc.d_model)
    _close(tattn.cross_attention(tc, tp, _t(x), _t(src), torch.float32),
           jattn.cross_attention(jc, jp, jnp.asarray(x), jnp.asarray(src),
                                 jnp.float32), "cross_attention")


@pytest.mark.parametrize("arch,q_lora", [("deepseek-v3-671b", 32),
                                         ("deepseek-v2-236b", 0)])
def test_mla_attention(arch, q_lora):
    jc, tc = _attn_case(arch, q_lora_rank=q_lora)
    jp, tp = _params(jattn.mla_spec(jc), 14)
    assert ("wq" in tp) == (q_lora == 0)
    b, s0, total = 2, 12, 16
    x = _n(_rng(15), b, total, jc.d_model)
    pos = np.broadcast_to(np.arange(total, dtype=np.int32)[None],
                          (b, total)).copy()
    jy, _ = jattn.mla_attention(jc, jp, jnp.asarray(x),
                                positions=jnp.asarray(pos),
                                compute_dtype=jnp.float32)
    ty, _ = tattn.mla_attention(tc, tp, _t(x), positions=_t(pos),
                                compute_dtype=torch.float32)
    _close(ty, jy, f"{arch} mla full")
    jcache, tcache = _jcache(jc, "mla", b, total), _tcache(tc, "mla", b, total)
    jy, jcache = jattn.mla_attention(
        jc, jp, jnp.asarray(x[:, :s0]), positions=jnp.asarray(pos[:, :s0]),
        cache=jcache, cache_index=jnp.asarray(0, jnp.int32),
        compute_dtype=jnp.float32)
    ty, tcache = tattn.mla_attention(
        tc, tp, _t(x[:, :s0]), positions=_t(pos[:, :s0]), cache=tcache,
        cache_index=0, compute_dtype=torch.float32)
    _close(ty, jy, f"{arch} mla prefill")
    for t in range(s0, total):
        jy, jcache = jattn.mla_attention(
            jc, jp, jnp.asarray(x[:, t:t + 1]),
            positions=jnp.asarray(pos[:, t:t + 1]), cache=jcache,
            cache_index=jnp.asarray(t, jnp.int32), compute_dtype=jnp.float32)
        ty, tcache = tattn.mla_attention(
            tc, tp, _t(x[:, t:t + 1]), positions=_t(pos[:, t:t + 1]),
            cache=tcache, cache_index=t, compute_dtype=torch.float32)
        _close(ty, jy, f"{arch} mla absorbed decode {t}")
        _close(tcache["ckv"], jcache["ckv"], f"{arch} latent cache {t}")


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["deepseek-v3-671b", "deepseek-v2-236b"])
def test_route(arch):
    jc, tc = _attn_case(arch)
    jp, tp = _params(jmoe.moe_spec(jc), 16)
    if "gate_bias" in jp:         # a non-zero bias, so that it selects
        gb = _n(_rng(17), jc.n_experts, scale=0.5)
        jp["gate_bias"], tp["gate_bias"] = jnp.asarray(gb), _t(gb)
    x = _n(_rng(18), 3, 11, jc.d_model)
    x[0, 0] = 0.0                 # all-equal logits: ties to the lower id
    ji, jw, ja, jload = jmoe.route(jc, jp, jnp.asarray(x))
    ti, tw, ta, tload = tmoe.route(tc, tp, _t(x))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    _close(tw, jw, f"{arch} route weights")
    _close(ta, ja, f"{arch} aux")
    _close(tload, jload, f"{arch} load")


@pytest.mark.parametrize("capacity", [2, 5, 40])
def test_dispatch_and_combine_row(capacity):
    """Buckets equal the reference's (drops past capacity, sentinel
    slots), and the combine equals its scatter-add."""
    r = _rng(19)
    l, k, e, d = 20, 3, 6, 8
    ids = np.stack([r.permutation(e)[:k] for _ in range(l)]).astype(np.int32)
    w = r.random((l, k)).astype(np.float32)
    jt, jw = jmoe._dispatch_row(jnp.asarray(ids), jnp.asarray(w), l, e,
                                capacity)
    tt, tw = tmoe._dispatch_row(_t(ids).long(), _t(w), l, e, capacity)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    y_e = _n(r, e, capacity, d)
    _close(tmoe._combine_row(tt, tw, _t(y_e), l, k),
           jmoe._combine_row(jt, jw, jnp.asarray(y_e), l), "combine")


@pytest.mark.parametrize("arch,row_len", [("deepseek-v3-671b", None),
                                          ("deepseek-v2-236b", None),
                                          ("deepseek-v3-671b", 8),
                                          ("deepseek-v2-236b", 4)])
def test_moe_ffn_flat_and_chunked(arch, row_len, monkeypatch):
    """``moe_ffn`` on 2 x 16 tokens: the flat (decode) path, and with
    ``FLAT_PATH_MAX_TOKENS`` and ``ROW_LEN`` set down in both packages
    the chunked path (rows of ``row_len`` tokens, chunks of rows, drops
    at capacity)."""
    jc, tc = _attn_case(arch)
    if row_len:
        for mod in (jmoe, tmoe):
            monkeypatch.setattr(mod, "FLAT_PATH_MAX_TOKENS", 0)
            monkeypatch.setattr(mod, "ROW_LEN", row_len)
            monkeypatch.setattr(mod, "ROWS_PER_CHUNK", 2)
    jp, tp = _params(jmoe.moe_spec(jc), 20)
    x = _n(_rng(21), 2, 16, jc.d_model, scale=0.5)
    jy, ja, jload = jmoe.moe_ffn(jc, jp, jnp.asarray(x), jnp.float32)
    ty, ta, tload = tmoe.moe_ffn(tc, tp, _t(x), torch.float32)
    path = f"chunked row_len={row_len}" if row_len else "flat"
    _close(ty, jy, f"{arch} moe_ffn {path}")
    _close(ta, ja, f"{arch} moe aux {path}")
    _close(tload, jload, f"{arch} moe load {path}")


# ---------------------------------------------------------------------------
# recurrent mixers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv1d(with_state):
    r = _rng(22)
    p = {"w": _n(r, 4, 12), "b": _n(r, 12)}
    x = _n(r, 2, 7, 12)
    st = _n(r, 2, 3, 12) if with_state else None
    jy, js = jssm.causal_conv1d(p, jnp.asarray(x),
                                None if st is None else jnp.asarray(st))
    ty, ts = tssm.causal_conv1d({k: _t(v) for k, v in p.items()}, _t(x),
                                None if st is None else _t(st))
    _close(ty, jy, f"conv1d state={with_state}")
    if with_state:
        _close(ts, js, "conv1d new state")
    else:
        assert ts is None and js is None


def _gates(seed, b, h, s, dh):
    r = _rng(seed)
    return (_n(r, b, h, s, dh), _n(r, b, h, s, dh), _n(r, b, h, s, dh),
            _n(r, b, h, s), _n(r, b, h, s) + 2.0)


@pytest.mark.parametrize("s,chunk", [(64, 16), (40, 16), (32, 32)])
def test_mlstm_chunkwise(s, chunk):
    q, k, v, ig, fg = _gates(23, 2, 2, s, 8)
    jh, jst = jssm._mlstm_chunkwise(*(jnp.asarray(a) for a in
                                      (q, k, v, ig, fg)), chunk)
    th, tst = tssm._mlstm_chunkwise(*(_t(a) for a in (q, k, v, ig, fg)),
                                    chunk)
    _close(th, jh, f"mlstm chunkwise s={s} chunk={chunk}", REC_TOL)
    for a, b_, n in zip(tst, jst, ("C", "n", "m")):
        _close(a, b_, f"mlstm final {n}", REC_TOL)


def test_mlstm_step():
    q, k, v, ig, fg = _gates(24, 2, 2, 3, 8)
    r = _rng(25)
    state = (_n(r, 2, 2, 8, 8), _n(r, 2, 2, 8), _n(r, 2, 2))
    jh, jst = jssm._mlstm_step(*(jnp.asarray(a[:, :, 0]) for a in
                                 (q, k, v, ig, fg)),
                               tuple(jnp.asarray(a) for a in state))
    th, tst = tssm._mlstm_step(*(_t(a[:, :, 0]) for a in (q, k, v, ig, fg)),
                               tuple(_t(a) for a in state))
    _close(th, jh, "mlstm step", REC_TOL)
    for a, b_ in zip(tst, jst):
        _close(a, b_, "mlstm step state", REC_TOL)


def test_group_rms():
    r = _rng(26)
    x, sc = _n(r, 2, 5, 32, scale=3.0), _n(r, 32)
    _close(tssm._group_rms(_t(x), _t(sc), 4, 1e-6),
           jssm._group_rms(jnp.asarray(x), jnp.asarray(sc), 4, 1e-6),
           "group rms")


def test_slstm_cell():
    jc = jget("xlstm-125m").replace(compute_dtype="float32")
    jp, tp = _params(jssm.slstm_block_spec(jc), 27)
    r = _rng(28)
    d = jc.d_model
    xg = _n(r, 2, 4 * d)
    state = (_n(r, 2, d), np.abs(_n(r, 2, d)) + 0.5, _n(r, 2, d),
             _n(r, 2, d, scale=0.5))
    jout = jssm._slstm_cell(jp, jnp.asarray(xg),
                            tuple(jnp.asarray(a) for a in state),
                            jc.n_heads)
    tout = tssm._slstm_cell(tp, _t(xg), tuple(_t(a) for a in state),
                            jc.n_heads)
    for a, b_, n in zip(tout, jout, "cnmh"):
        _close(a, b_, f"slstm cell {n}", REC_TOL)


@pytest.mark.parametrize("kind", ["mlstm", "slstm", "rglru"])
def test_recurrent_block_prefill_and_decode(kind):
    """Each recurrent block over a full sequence, as a prefill that keeps
    its state, and as decode steps from that state."""
    arch = "recurrentgemma-9b" if kind == "rglru" else "xlstm-125m"
    jc, tc = _attn_case(arch)
    spec = jT.block_spec(jc, kind, None)["mix"]
    jp, tp = _params(spec, 29)
    jfn = {"mlstm": jssm.mlstm_block, "slstm": jssm.slstm_block,
           "rglru": jssm.rglru_block}[kind]
    tfn = {"mlstm": tssm.mlstm_block, "slstm": tssm.slstm_block,
           "rglru": tssm.rglru_block}[kind]
    cspec = jT.block_cache_spec(jc, kind, 2, 0)["self"]
    b, s0, total = 2, 19, 23
    x = _n(_rng(30), b, total, jc.d_model)
    jy, _ = jfn(jc, jp, jnp.asarray(x), None, jnp.float32)
    ty, _ = tfn(tc, tp, _t(x), None, torch.float32)
    _close(ty, jy, f"{kind} full", REC_TOL)
    jcache = JP.init(cspec, jax.random.key(0), "float32")
    tcache = {k: _t(np.asarray(v)) for k, v in jcache.items()}
    jy, jcache = jfn(jc, jp, jnp.asarray(x[:, :s0]), jcache, jnp.float32)
    ty, tcache = tfn(tc, tp, _t(x[:, :s0]), tcache, torch.float32)
    _close(ty, jy, f"{kind} prefill", REC_TOL)
    for t in range(s0, total):
        jy, jcache = jfn(jc, jp, jnp.asarray(x[:, t:t + 1]), jcache,
                         jnp.float32)
        ty, tcache = tfn(tc, tp, _t(x[:, t:t + 1]), tcache, torch.float32)
        _close(ty, jy, f"{kind} decode {t}", REC_TOL)
    for key in jcache:
        _close(tcache[key], jcache[key], f"{kind} state {key}", REC_TOL)


@pytest.mark.parametrize("s,h0", [(37, False), (64, True), (1, True)])
def test_rglru_scan(s, h0):
    r = _rng(31)
    a = (1 / (1 + np.exp(-_n(r, 2, s, 16)))) * 0.98
    bb = _n(r, 2, s, 16)
    h = _n(r, 2, 16) if h0 else None
    want = jssm._rglru_scan(jnp.asarray(a), jnp.asarray(bb),
                            None if h is None else jnp.asarray(h))
    got = tssm._rglru_scan(_t(a), _t(bb), None if h is None else _t(h))
    _close(got, want, f"rglru scan s={s} h0={h0}", REC_TOL)


def test_sinusoids():
    _close(tT.sinusoidal_positions(33, 16), jT.sinusoidal_positions(33, 16),
           "sinusoidal positions")
    _close(tT.sinusoidal_at(21, 16), jT.sinusoidal_at(jnp.asarray(21), 16),
           "sinusoidal at 21")
    assert math.isclose(float(tT.sinusoidal_at(0, 16)[1]), 1.0)
