"""whisper-base [audio] — 6L d_model=512 8H d_ff=2048 vocab=51865,
encoder-decoder, conv frontend STUB (input_specs provides precomputed
frame embeddings).  [arXiv:2212.04356]

32k/500k shapes exceed Whisper's real max positions; they are exercised
structurally as assigned (DESIGN.md).  long_500k skipped (full attention).
"""
from repro_torch.common.config import ModelConfig

ARCH_ID = "whisper-base"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="audio",
        n_layers=6,                   # decoder layers
        n_encoder_layers=6,
        d_model=512,
        n_heads=8,
        n_kv_heads=8,
        head_dim=64,
        d_ff=2048,
        vocab=51865,
        pattern=("global",),
        norm_type="ln",
        ffn_gated=False,
        ffn_bias=True,
        ffn_act="gelu",
        pos_embed="sinusoidal",
        audio_stub=True,
        norm_eps=1e-5,
        optimizer="adamw",
        skip_shapes=("long_500k",),
    )


def smoke_config() -> ModelConfig:
    return config().replace(
        n_layers=2, n_encoder_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
        head_dim=16, d_ff=128, vocab=512,
    )
