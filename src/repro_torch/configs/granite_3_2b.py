"""granite-3-2b [dense] — 40L d_model=2048 32H (GQA kv=8) d_ff=8192
vocab=49155, plain GQA.  [hf:ibm-granite/granite-3.0-2b-base]"""
from repro_torch.common.config import ModelConfig

ARCH_ID = "granite-3-2b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="dense",
        n_layers=40,
        d_model=2048,
        n_heads=32,
        n_kv_heads=8,
        head_dim=64,
        d_ff=8192,
        vocab=49155,
        pattern=("global",),
        rope_theta=10_000.0,
        optimizer="adamw",
        # pure full attention -> long-context decode skipped (DESIGN.md)
        skip_shapes=("long_500k",),
    )


def smoke_config() -> ModelConfig:
    return config().replace(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab=512,
    )
