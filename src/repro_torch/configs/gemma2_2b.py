"""gemma2-2b [dense] — 26L d_model=2304 8H (GQA kv=4) d_ff=9216
vocab=256000, local+global alternating, logit softcaps.
[arXiv:2408.00118; hf]"""
from repro_torch.common.config import ModelConfig

ARCH_ID = "gemma2-2b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="dense",
        n_layers=26,
        d_model=2304,
        n_heads=8,
        n_kv_heads=4,
        head_dim=256,
        d_ff=9216,
        vocab=256000,
        pattern=("local", "global"),
        sliding_window=4096,
        attn_softcap=50.0,
        final_softcap=30.0,
        rope_theta=10_000.0,
        sandwich_norm=True,
        scale_embed=True,
        optimizer="adamw",
        skip_shapes=(),               # hybrid local/global: long_500k RUN
    )


def smoke_config() -> ModelConfig:
    return config().replace(
        n_layers=4, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab=512, sliding_window=16,
    )
