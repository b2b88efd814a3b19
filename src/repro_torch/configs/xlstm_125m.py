"""xlstm-125m [ssm] — 12L d_model=768 4H d_ff=0 vocab=50304,
sLSTM + mLSTM blocks.  [arXiv:2405.04517]

d_ff=0: xLSTM blocks carry their own projections (mLSTM: pre-up-projection
factor 2; sLSTM: post-up-projection GeGLU factor 4/3).  The 125M block
ratio is not pinned in the paper — we alternate mLSTM/sLSTM 1:1 (recorded
assumption, DESIGN.md §Arch-applicability)."""
from repro_torch.common.config import ModelConfig

ARCH_ID = "xlstm-125m"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="ssm",
        n_layers=12,
        d_model=768,
        n_heads=4,
        n_kv_heads=4,
        d_ff=0,
        vocab=50304,
        pattern=("mlstm", "slstm"),
        conv_width=4,
        mlstm_chunk=256,
        optimizer="adamw",
        skip_shapes=(),               # sub-quadratic: long_500k RUN
    )


def smoke_config() -> ModelConfig:
    return config().replace(
        n_layers=2, d_model=64, n_heads=2, n_kv_heads=2, vocab=512,
        mlstm_chunk=16,
    )
