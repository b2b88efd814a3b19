"""Configuration dataclasses of the port: copies of the reference's
``repro.common.config`` (the port imports nothing of ``repro``), field
for field and property for property.

``ModelConfig`` describes one LM architecture (the per-arch files in
``repro_torch.configs`` instantiate it with the reference's values),
``ShapeConfig`` one (seq_len, global_batch, kind) input-shape cell,
``DLRMConfig`` the paper's own workload and ``TrainConfig`` the
training loop's knobs (``train/step.py``, ``train/loop.py``).
"""
from __future__ import annotations

import dataclasses
import os
import tempfile
from dataclasses import dataclass
from typing import Tuple

# Layer kinds usable in ``ModelConfig.pattern``.
LAYER_KINDS = (
    "global",   # full causal attention
    "local",    # sliding-window causal attention
    "mla",      # multi-head latent attention (DeepSeek)
    "mlstm",    # xLSTM matrix-memory block
    "slstm",    # xLSTM scalar-memory block
    "rglru",    # Griffin / RecurrentGemma gated linear recurrent unit
)


@dataclass(frozen=True)
class ShapeConfig:
    """One input-shape cell from the assignment."""

    name: str                   # train_4k | prefill_32k | decode_32k | long_500k
    seq_len: int
    global_batch: int
    kind: str                   # "train" | "prefill" | "decode"

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


# The four LM shapes every assigned architecture is paired with.
LM_SHAPES: Tuple[ShapeConfig, ...] = (
    ShapeConfig("train_4k", seq_len=4096, global_batch=256, kind="train"),
    ShapeConfig("prefill_32k", seq_len=32768, global_batch=32, kind="prefill"),
    ShapeConfig("decode_32k", seq_len=32768, global_batch=128, kind="decode"),
    ShapeConfig("long_500k", seq_len=524288, global_batch=1, kind="decode"),
)
SHAPES_BY_NAME = {s.name: s for s in LM_SHAPES}


@dataclass(frozen=True)
class ModelConfig:
    """Architecture description (exact values from the assignment sheet)."""

    name: str
    family: str                     # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0               # 0 -> d_model // n_heads

    # ---- layer pattern -------------------------------------------------
    # The model is built as floor(n_layers/len(pattern)) scanned blocks of
    # ``pattern`` plus an unscanned tail of pattern[:n_layers % len].
    pattern: Tuple[str, ...] = ("global",)
    sliding_window: int = 4096
    attn_softcap: float = 0.0       # 0 disables (gemma2: 50.0)
    final_softcap: float = 0.0      # 0 disables (gemma2: 30.0)

    # ---- positional ----------------------------------------------------
    rope_theta: float = 10_000.0
    rope_theta_global: float = 0.0  # gemma3: separate theta for global layers
    mrope_sections: Tuple[int, int, int] = (0, 0, 0)  # qwen2-vl M-RoPE (t,h,w)

    # ---- MoE -----------------------------------------------------------
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0               # per-expert hidden dim (assignment d_ff)
    first_dense_layers: int = 0
    dense_d_ff: int = 0             # hidden dim of the leading dense layers
    aux_free_bias: bool = False     # DeepSeek-V3 aux-loss-free gate bias
    router_aux_coef: float = 0.0    # GShard-style load-balance loss coef
    routed_scaling: float = 1.0

    # ---- MLA (DeepSeek) -------------------------------------------------
    use_mla: bool = False
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0

    # ---- recurrent (xLSTM / Griffin) ------------------------------------
    lru_width: int = 0              # 0 -> d_model
    conv_width: int = 4
    mlstm_chunk: int = 256          # chunkwise-parallel mLSTM chunk size

    # ---- encoder-decoder (Whisper) ---------------------------------------
    n_encoder_layers: int = 0
    audio_stub: bool = False        # inputs are precomputed frame embeddings
    vision_stub: bool = False       # inputs include (vision_embed, vision_mask)

    # ---- extras ----------------------------------------------------------
    mtp: bool = False               # DeepSeek-V3 multi-token-prediction head
    tie_embeddings: bool = True
    norm_eps: float = 1e-6
    use_qk_norm: bool = False       # gemma3 per-head RMSNorm on q/k
    gate_fn: str = "softmax"        # MoE router: softmax (v2) | sigmoid (v3)
    attn_impl: str = "naive"        # naive | chunked (online-softmax flash)
    attn_chunk: int = 1024          # kv chunk for attn_impl="chunked"
    ffn_act: str = "silu"           # silu | gelu
    sandwich_norm: bool = False     # gemma2/3 pre+post norm around sublayers
    norm_type: str = "rms"          # rms | ln (whisper)
    ffn_gated: bool = True          # SwiGLU/GeGLU vs plain MLP
    ffn_bias: bool = False          # whisper-style biases
    pos_embed: str = "rope"         # rope | sinusoidal (whisper)
    scale_embed: bool = False       # gemma: embeddings * sqrt(d_model)

    # ---- numerics / training policy --------------------------------------
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    optimizer: str = "adamw"        # adamw | adafactor
    remat: bool = True
    remat_policy: str = "nothing"   # nothing | dots (save matmul outputs)
    scan_layers: bool = True
    # ---- perf knobs (hillclimbed in EXPERIMENTS.md §Perf) -----------------
    expert_sharding: str = "ep_tp"  # ep_tp: E->data, ff->model (TP psum)
                                    # ep2d:  E->(data,model), no expert TP
    kv_cache_quant: bool = False    # int8 KV cache w/ per-slot scales

    # shapes this arch is evaluated on; names from SHAPES_BY_NAME, with
    # skips applied per DESIGN.md §Arch-applicability.
    shape_names: Tuple[str, ...] = ("train_4k", "prefill_32k", "decode_32k", "long_500k")
    skip_shapes: Tuple[str, ...] = ()   # recorded skips (reason in DESIGN.md)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def n_blocks(self) -> int:
        return self.scanned_layers // len(self.pattern)

    @property
    def scanned_layers(self) -> int:
        body = self.n_layers - self.first_dense_layers
        return (body // len(self.pattern)) * len(self.pattern)

    @property
    def tail_pattern(self) -> Tuple[str, ...]:
        body = self.n_layers - self.first_dense_layers
        return self.pattern[: body % len(self.pattern)]

    @property
    def is_encdec(self) -> bool:
        return self.n_encoder_layers > 0

    def active_shapes(self) -> Tuple[ShapeConfig, ...]:
        return tuple(
            SHAPES_BY_NAME[n] for n in self.shape_names if n not in self.skip_shapes
        )

    def cell_status(self, shape_name: str) -> str:
        if shape_name in self.skip_shapes:
            return "skip"
        return "run"


@dataclass(frozen=True)
class DLRMConfig:
    """The paper's own workload (§8): DLRM behind the BALBOA service chain."""

    name: str = "dlrm"
    n_dense: int = 13               # Criteo-like dense feature count
    n_sparse: int = 26              # sparse (categorical) feature count
    embed_rows: int = 100_000       # rows per embedding table (after Modulus)
    embed_dim: int = 64
    bottom_mlp: Tuple[int, ...] = (512, 256, 64)
    top_mlp: Tuple[int, ...] = (512, 256, 1)
    modulus: int = 100_000          # paper §8.1 Modulus operator range
    param_dtype: str = "float32"
    compute_dtype: str = "float32"


@dataclass
class TrainConfig:
    """Training-loop knobs (launcher-level)."""

    steps: int = 100
    microbatches: int = 1           # gradient accumulation
    learning_rate: float = 3e-4
    warmup_steps: int = 20
    weight_decay: float = 0.01
    grad_clip: float = 1.0
    seed: int = 0
    checkpoint_every: int = 50
    # the reference's /tmp/repro_ckpt, under the temp directory (TMPDIR)
    checkpoint_dir: str = os.path.join(tempfile.gettempdir(), "repro_ckpt")
    # cross-pod gradient compression: none | bf16 | topk
    pod_grad_compression: str = "none"
    topk_fraction: float = 0.05
    log_every: int = 10
