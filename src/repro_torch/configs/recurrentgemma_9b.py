"""recurrentgemma-9b [hybrid] — 38L d_model=4096 16H (MQA kv=1)
d_ff=12288 vocab=256000, RG-LRU + local attention 1:2 (Griffin).
[arXiv:2402.19427]

38 = 12 * (rglru, rglru, local) + tail (rglru, rglru)."""
from repro_torch.common.config import ModelConfig

ARCH_ID = "recurrentgemma-9b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="hybrid",
        n_layers=38,
        d_model=4096,
        n_heads=16,
        n_kv_heads=1,
        head_dim=256,
        d_ff=12288,
        vocab=256000,
        pattern=("rglru", "rglru", "local"),
        sliding_window=2048,
        lru_width=4096,
        conv_width=4,
        rope_theta=10_000.0,
        scale_embed=True,
        optimizer="adamw",
        skip_shapes=(),               # sub-quadratic: long_500k RUN
    )


def smoke_config() -> ModelConfig:
    return config().replace(
        n_layers=5,                   # one block + tail (rglru, rglru)
        d_model=64, n_heads=4, n_kv_heads=1, head_dim=16,
        d_ff=128, vocab=512, lru_width=64, sliding_window=16,
    )
