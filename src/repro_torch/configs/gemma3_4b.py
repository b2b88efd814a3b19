"""gemma3-4b [dense] — 34L d_model=2560 8H (GQA kv=4) d_ff=10240
vocab=262144, 5:1 local:global, 128k context.
[hf:google/gemma-3-4b-pt; assignment sheet]"""
from repro_torch.common.config import ModelConfig

ARCH_ID = "gemma3-4b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="dense",
        n_layers=34,
        d_model=2560,
        n_heads=8,
        n_kv_heads=4,
        head_dim=256,
        d_ff=10240,
        vocab=262144,
        # 5 local : 1 global; 34 = 5*6 + 4 -> tail of 4 local layers
        pattern=("local", "local", "local", "local", "local", "global"),
        sliding_window=1024,
        rope_theta=10_000.0,          # local layers
        rope_theta_global=1_000_000.0,  # global layers
        use_qk_norm=True,
        sandwich_norm=True,
        scale_embed=True,
        norm_eps=1e-6,
        optimizer="adamw",
        # hybrid local/global: long_500k RUN (see DESIGN.md §Arch-applicability)
        skip_shapes=(),
    )


def smoke_config() -> ModelConfig:
    return config().replace(
        n_layers=7,                   # one pattern block + 1 tail local
        d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab=512, sliding_window=16,
    )
