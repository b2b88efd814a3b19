"""qwen2-vl-72b [vlm] — 80L d_model=8192 64H (GQA kv=8) d_ff=29568
vocab=152064, M-RoPE, dynamic resolution (vision frontend STUB:
input_specs provides patch embeddings + vision mask).
[arXiv:2409.12191; hf]"""
from repro_torch.common.config import ModelConfig

ARCH_ID = "qwen2-vl-72b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="vlm",
        n_layers=80,
        d_model=8192,
        n_heads=64,
        n_kv_heads=8,
        head_dim=128,
        d_ff=29568,
        vocab=152064,
        pattern=("global",),
        rope_theta=1_000_000.0,
        mrope_sections=(16, 24, 24),  # t/h/w bands, sum = head_dim/2
        vision_stub=True,
        param_dtype="bfloat16",
        optimizer="adafactor",
        skip_shapes=("long_500k",),   # pure full attention
    )


def smoke_config() -> ModelConfig:
    return config().replace(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab=512, mrope_sections=(4, 2, 2),
        param_dtype="float32",
    )
