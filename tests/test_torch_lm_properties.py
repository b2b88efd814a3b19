"""The reference's pinned properties of its model substrate, held by the
port alone (no JAX here), on the CPU, with the port's own seeded
weights: the checks of ``tests/test_models.py`` and
``tests/test_perf_knobs.py``, one for one, at their bounds.

* prefill + decode reproduces the full forward, every smoke arch,
  float32, within 2e-3 (MoE capacity raised, as the reference does);
* chunked (online-softmax) attention equals naive, with and without
  softcap and window, within 2e-5;
* the mLSTM's chunkwise form equals its stepwise recurrence (hidden
  state and final C) within 2e-4;
* the RG-LRU's parallel scan equals the sequential recurrence within
  1e-5;
* the sort-based MoE equals its dense reference within 3e-4;
* the ring cache of a sliding-window layer holds over 24 decode steps
  past its 16-slot window, within 2e-3 of the full forward;
* blocked sliding attention equals naive within 2e-5 (and a blocked
  model's forward its naive one within 1e-4);
* the int8 KV cache tracks the float cache within 0.05, and is int8;
* the ep2d expert layout computes what ep_tp does, within 1e-5.
"""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import repro_torch.models.moe as moe
from _lm_batches import ENC_LEN, lm_batch, prompt_of
from repro_torch.configs import ALL_ARCHS, get_smoke_config
from repro_torch.models import params as P
from repro_torch.models import ssm
from repro_torch.models.attention import (_build_mask, _dot_attention,
                                          _sliding_attention_blocked)
from repro_torch.models.layers import ffn
from repro_torch.models.model import Model

torch.set_num_threads(1)

B, S = 2, 24


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _model(cfg, seed=0):
    return Model(cfg, device="cpu").init_params(seed)


def _tensors(batch):
    return {k: torch.from_numpy(v.copy()) for k, v in batch.items()}


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_decode_matches_full_forward(arch, monkeypatch):
    cfg = get_smoke_config(arch).replace(compute_dtype="float32")
    if cfg.n_experts:
        # no capacity drops, which differ between batched and one-token
        # routing
        monkeypatch.setattr(moe, "CAPACITY_FACTOR", 8.0)
    m = _model(cfg)
    full = lm_batch(cfg, B, S + 1, seed=0, vision=False)
    with torch.no_grad():
        logits_full = m.forward(_tensors(full), train=False)[0]
    cache = m.init_cache(B, S + 8, enc_len=ENC_LEN if cfg.is_encdec else 0)
    _, cache = m.prefill(_tensors(prompt_of(full, S)), cache)
    lg, _ = m.decode_step(cache, torch.from_numpy(full["tokens"][:, S:S + 1]
                                                  .copy()), S)
    err = float((lg[:, 0] - logits_full[:, S]).abs().max())
    print(f"{arch}: decode vs forward max abs err {err:.3e}")
    assert err < 2e-3, f"{arch}: decode diverges from forward by {err}"


@pytest.mark.parametrize("b,s,h,kv,d,cap,window,chunk,scale", [
    (2, 256, 4, 2, 16, 0.0, 0, 64, 0.25),
    (1, 128, 2, 2, 8, 50.0, 32, 32, 0.35)])
def test_chunked_attention_matches_naive(b, s, h, kv, d, cap, window, chunk,
                                         scale):
    g = _gen(0)
    q = torch.randn((b, s, h, d), generator=g)
    k = torch.randn((b, s, kv, d), generator=g)
    v = torch.randn((b, s, kv, d), generator=g)
    pos = torch.arange(s)[None].expand(b, s)
    mask = _build_mask(pos, pos, True, window)[:, None, None]
    naive = _dot_attention(q, k, v, mask, scale, cap, "naive")
    chunked = _dot_attention(q, k, v, mask, scale, cap, "chunked", chunk)
    print(f"chunked vs naive: {float((chunked - naive).abs().max()):.3e}")
    torch.testing.assert_close(chunked, naive, rtol=2e-5, atol=2e-5)


def test_mlstm_chunkwise_matches_stepwise():
    b, h, s, dh = 2, 2, 64, 8
    g = _gen(2)
    q, k, v = (torch.randn((b, h, s, dh), generator=g) for _ in range(3))
    ig = torch.randn((b, h, s), generator=g)
    fg = torch.randn((b, h, s), generator=g) + 2.0
    hc, state_c = ssm._mlstm_chunkwise(q, k, v, ig, fg, chunk=16)
    state = (torch.zeros((b, h, dh, dh)), torch.zeros((b, h, dh)),
             torch.full((b, h), -1e30))
    outs = []
    for t in range(s):
        o, state = ssm._mlstm_step(q[:, :, t], k[:, :, t], v[:, :, t],
                                   ig[:, :, t], fg[:, :, t], state)
        outs.append(o)
    hs = torch.stack(outs, dim=2)
    print(f"mLSTM chunkwise vs stepwise: "
          f"{float((hc - hs).abs().max()):.3e}")
    torch.testing.assert_close(hc, hs, rtol=2e-4, atol=2e-4)
    torch.testing.assert_close(state_c[0], state[0], rtol=2e-4, atol=2e-4)


def test_rglru_scan_matches_sequential():
    b, s, d = 2, 37, 16
    g = _gen(3)
    a = torch.sigmoid(torch.randn((b, s, d), generator=g)) * 0.98
    bb = torch.randn((b, s, d), generator=g)
    h_scan = ssm._rglru_scan(a, bb)
    h = torch.zeros((b, d))
    outs = []
    for t in range(s):
        h = a[:, t] * h + bb[:, t]
        outs.append(h)
    h_seq = torch.stack(outs, dim=1)
    print(f"RG-LRU scan vs sequential: "
          f"{float((h_scan - h_seq).abs().max()):.3e}")
    torch.testing.assert_close(h_scan, h_seq, rtol=1e-5, atol=1e-5)


def test_moe_matches_dense_reference(monkeypatch):
    """With ample capacity, the sort-based dispatch equals the dense
    weighted sum over the selected experts."""
    cfg = get_smoke_config("deepseek-v2-236b").replace(
        compute_dtype="float32")
    monkeypatch.setattr(moe, "CAPACITY_FACTOR", 8.0)
    p = P.init(moe.moe_spec(cfg), _gen(0), "float32")
    x = torch.randn((2, 16, cfg.d_model), generator=_gen(1)) * 0.1
    y, _, _ = moe.moe_ffn(cfg, p, x, torch.float32)
    ids, w, _, _ = moe.route(cfg, p, x)
    h1 = torch.einsum("bsd,edf->bsef", x, p["w1"])
    h3 = torch.einsum("bsd,edf->bsef", x, p["w3"])
    ye = torch.einsum("bsef,efd->bsed", F.silu(h1) * h3, p["w2"])
    sel = F.one_hot(ids, cfg.n_experts).float()               # (b,s,k,e)
    wk = torch.einsum("bske,bsk->bse", sel, w)
    ref = torch.einsum("bsed,bse->bsd", ye, wk) + ffn(p["shared"], x,
                                                      torch.float32)
    print(f"MoE vs dense: {float((y - ref).abs().max()):.3e}")
    torch.testing.assert_close(y, ref, rtol=3e-4, atol=3e-4)


def test_sliding_window_ring_cache_long_decode():
    """Decode far past the window: the ring cache must keep exactly the
    last ``window`` positions."""
    cfg = get_smoke_config("gemma3-4b").replace(compute_dtype="float32")
    m = _model(cfg)
    total = 40                      # window is 16
    toks = torch.randint(0, cfg.vocab, (1, total), generator=_gen(9),
                         dtype=torch.int32)
    with torch.no_grad():
        logits_full = m.forward({"tokens": toks}, train=False)[0]
    cache = m.init_cache(1, total)
    _, cache = m.prefill({"tokens": toks[:, :16]}, cache)
    for t in range(16, total):
        lg, cache = m.decode_step(cache, toks[:, t:t + 1], t)
    err = float((lg[:, 0] - logits_full[:, total - 1]).abs().max())
    print(f"ring cache, 24 steps past the window: {err:.3e}")
    assert err < 2e-3, f"ring cache diverged: {err}"


def test_blocked_sliding_attention_equals_naive():
    b, s, h, kv, d, w = 2, 384, 4, 2, 16, 96
    g = _gen(0)
    q = torch.randn((b, s, h, d), generator=g)
    k = torch.randn((b, s, kv, d), generator=g)
    v = torch.randn((b, s, kv, d), generator=g)
    pos = torch.arange(s)[None].expand(b, s)
    mask = _build_mask(pos, pos, True, w)[:, None, None]
    ref = _dot_attention(q, k, v, mask, 0.25, 30.0, "naive")
    blk = _sliding_attention_blocked(q, k, v, pos, w, 0.25, 30.0, block_q=96)
    torch.testing.assert_close(blk, ref, rtol=2e-5, atol=2e-5)


def test_blocked_model_forward_equals_naive():
    cfg = get_smoke_config("gemma2-27b").replace(compute_dtype="float32")
    m_naive = _model(cfg)
    m_blk = Model(cfg.replace(attn_impl="blocked"), device="cpu")
    m_blk.load_state_dict(m_naive.state_dict())
    toks = torch.randint(0, cfg.vocab, (2, 48), generator=_gen(1),
                         dtype=torch.int32)
    batch = {"tokens": toks, "targets": toks}
    with torch.no_grad():
        l1 = m_naive.forward(batch, train=False)[0]
        l2 = m_blk.forward(batch, train=False)[0]
    torch.testing.assert_close(l1, l2, rtol=1e-4, atol=1e-4)


def test_int8_kv_cache_decode_tracks_fp():
    cfg = get_smoke_config("gemma2-2b").replace(compute_dtype="float32")
    toks = torch.randint(0, cfg.vocab, (2, 25), generator=_gen(1),
                         dtype=torch.int32)
    outs = {}
    fp = _model(cfg)
    for name, c in (("fp", cfg), ("int8", cfg.replace(kv_cache_quant=True))):
        m = Model(c, device="cpu")
        m.load_state_dict(fp.state_dict())
        cache = m.init_cache(2, 32)
        _, cache = m.prefill({"tokens": toks[:, :24]}, cache)
        outs[name], _ = m.decode_step(cache, toks[:, 24:25], 24)
        if name == "int8":
            assert cache["blocks"][0]["sub0"]["self"]["k"].dtype == torch.int8
    err = float((outs["fp"] - outs["int8"]).abs().max())
    print(f"int8 KV cache vs fp: {err:.3e}")
    assert err < 0.05, f"int8 KV cache drifted: {err}"


def test_ep2d_moe_numerics_match_ep_tp():
    """Both expert layouts compute the same function."""
    cfg = get_smoke_config("deepseek-v3-671b").replace(
        compute_dtype="float32")
    p = P.init(moe.moe_spec(cfg), _gen(0), "float32")
    x = torch.randn((2, 16, cfg.d_model), generator=_gen(1)) * 0.1
    y1, _, _ = moe.moe_ffn(cfg, p, x, torch.float32)
    y2, _, _ = moe.moe_ffn(cfg.replace(expert_sharding="ep2d"), p, x,
                           torch.float32)
    torch.testing.assert_close(y1, y2, rtol=1e-5, atol=1e-5)


def test_moe_combine_is_run_to_run_equal():
    """The combine sums each token's experts in one fixed order, so two
    runs (and any device) give the same bits."""
    cfg = get_smoke_config("deepseek-v3-671b").replace(
        compute_dtype="float32")
    p = P.init(moe.moe_spec(cfg), _gen(0), "float32")
    x = torch.randn((4, 32, cfg.d_model), generator=_gen(2))
    a = moe.moe_ffn(cfg, p, x, torch.float32)[0]
    b = moe.moe_ffn(cfg, p, x, torch.float32)[0]
    assert torch.equal(a, b)
    np.testing.assert_array_equal(a.numpy(), b.numpy())
