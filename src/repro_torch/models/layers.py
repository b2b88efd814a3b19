"""Common layers of the LM stack, as functions on tensors.

``params`` is a dict-like of tensors (a ``ParamTree`` or a plain dict),
as in the reference's ``repro.models.layers``.  Every float parameter is
cast to the compute dtype at its use, as the reference casts it; norms,
softmax statistics and RoPE angles run in float32.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.params import Spec
from repro_torch.parallel.sharding import constrain


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def rms_norm_spec(dim: int):
    return {"scale": Spec((dim,), (None,), "zeros")}  # gemma-style (1+scale)


def rms_norm(params, x: torch.Tensor, eps: float) -> torch.Tensor:
    x32 = x.float()
    var = torch.mean(torch.square(x32), dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * (1.0 + params["scale"].float())).to(x.dtype)


def layer_norm_spec(dim: int):
    return {
        "scale": Spec((dim,), (None,), "ones"),
        "bias": Spec((dim,), (None,), "zeros"),
    }


def layer_norm(params, x: torch.Tensor, eps: float) -> torch.Tensor:
    x32 = x.float()
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.var(x32, dim=-1, keepdim=True, unbiased=False)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * params["scale"].float() + params["bias"].float()).to(x.dtype)


# ---------------------------------------------------------------------------
# Activations / softcap
# ---------------------------------------------------------------------------

def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    if not cap:
        return x
    return cap * torch.tanh(x / cap)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """The tanh approximation (``jax.nn.gelu(approximate=True)``)."""
    return F.gelu(x, approximate="tanh")


def swiglu(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    return F.silu(gate) * up


def geglu(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    return gelu(gate) * up


# ---------------------------------------------------------------------------
# Embedding + LM head
# ---------------------------------------------------------------------------

def embedding_spec(vocab: int, d_model: int):
    return {"table": Spec((vocab, d_model), ("vocab", "embed"), "embed")}


def embed(params, tokens: torch.Tensor, compute_dtype) -> torch.Tensor:
    # gather, then cast: the rows the reference takes from its cast table
    # (on a vocab-sharded DTensor table, each rank takes its rows, the
    # others masked, and the sum is all-reduced: DTensor's embedding)
    y = F.embedding(tokens.long(), params["table"]).to(compute_dtype)
    return constrain(y, "batch", "seq", "d_model")


def unembed(params, x: torch.Tensor, compute_dtype) -> torch.Tensor:
    """Tied LM head: logits = x @ table.T."""
    logits = torch.matmul(x, params["table"].to(compute_dtype).t())
    return constrain(logits, "batch", "seq", "vocab")


# ---------------------------------------------------------------------------
# Dense projections
# ---------------------------------------------------------------------------

def linear_spec(d_in: int, d_out: int, axes=("embed", "d_ff"),
                bias: bool = False):
    spec = {"w": Spec((d_in, d_out), axes)}
    if bias:
        spec["b"] = Spec((d_out,), (axes[1],), "zeros")
    return spec


def linear(params, x: torch.Tensor, compute_dtype) -> torch.Tensor:
    y = torch.matmul(x, params["w"].to(compute_dtype))
    if "b" in params:
        y = y + params["b"].to(compute_dtype)
    return y


def ffn_spec(d_model: int, d_ff: int, gated: bool = True,
             bias: bool = False):
    spec = {
        "w_up": Spec((d_model, d_ff), ("embed", "d_ff")),
        "w_down": Spec((d_ff, d_model), ("d_ff", "embed")),
    }
    if gated:
        spec["w_gate"] = Spec((d_model, d_ff), ("embed", "d_ff"))
    if bias:
        spec["b_up"] = Spec((d_ff,), ("d_ff",), "zeros")
        spec["b_down"] = Spec((d_model,), (None,), "zeros")
    return spec


def ffn(params, x: torch.Tensor, compute_dtype,
        act: str = "silu") -> torch.Tensor:
    up = torch.matmul(x, params["w_up"].to(compute_dtype))
    if "b_up" in params:
        up = up + params["b_up"].to(compute_dtype)
    if "w_gate" in params:
        gate = torch.matmul(x, params["w_gate"].to(compute_dtype))
        h = swiglu(gate, up) if act == "silu" else geglu(gate, up)
    else:
        h = gelu(up) if act == "gelu" else F.silu(up)
    h = constrain(h, "batch", "seq", "d_ff")
    y = torch.matmul(h, params["w_down"].to(compute_dtype))
    if "b_down" in params:
        y = y + params["b_down"].to(compute_dtype)
    return constrain(y, "batch", "seq", "d_model")


# ---------------------------------------------------------------------------
# RoPE (incl. per-layer-type theta and Qwen2-VL M-RoPE), in float32
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                         device=device) / half))


def _rotate(x: torch.Tensor, ang: torch.Tensor) -> torch.Tensor:
    """x: (B, S, H, D); ang: (B, S, D/2) float32."""
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def apply_rope(
    x: torch.Tensor,              # (B, S, H, D)
    positions: torch.Tensor,      # (B, S) int32
    theta: float,
) -> torch.Tensor:
    freqs = rope_freqs(x.shape[-1], theta, x.device)            # (D/2,)
    return _rotate(x, positions[..., None].float() * freqs)


def apply_mrope(
    x: torch.Tensor,              # (B, S, H, D)
    positions: torch.Tensor,      # (3, B, S) int32 — (t, h, w)
    theta: float,
    sections: Tuple[int, int, int],
) -> torch.Tensor:
    """Qwen2-VL multimodal RoPE: frequency bands split into (t, h, w)
    sections; each band rotates by its own position stream."""
    half = x.shape[-1] // 2
    assert sum(sections) == half, (sections, half)
    freqs = rope_freqs(x.shape[-1], theta, x.device)            # (half,)
    band = torch.tensor([i for i, n in enumerate(sections)
                         for _ in range(n)], device=x.device)    # (half,)
    pos = positions.float()[band]                               # (half, B, S)
    return _rotate(x, pos.permute(1, 2, 0) * freqs)
