"""deepseek-v2-236b [moe] — 60L d_model=5120 128H d_ff=1536 (per expert)
vocab=102400, MLA kv_lora=512, 2 shared + 160 routed top-6.
[arXiv:2405.04434; hf]"""
from repro_torch.common.config import ModelConfig

ARCH_ID = "deepseek-v2-236b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="moe",
        n_layers=60,
        d_model=5120,
        n_heads=128,
        n_kv_heads=128,
        d_ff=1536,
        vocab=102400,
        pattern=("mla",),
        # MoE
        n_experts=160,
        n_shared_experts=2,
        top_k=6,
        moe_d_ff=1536,
        first_dense_layers=1,
        dense_d_ff=12288,
        gate_fn="softmax",
        router_aux_coef=0.003,
        routed_scaling=16.0,
        # MLA
        use_mla=True,
        q_lora_rank=1536,
        kv_lora_rank=512,
        qk_nope_head_dim=128,
        qk_rope_head_dim=64,
        v_head_dim=128,
        param_dtype="bfloat16",
        optimizer="adafactor",
        skip_shapes=("long_500k",),   # full attention (MLA)
    )


def smoke_config() -> ModelConfig:
    return config().replace(
        n_layers=3, first_dense_layers=1, d_model=64, n_heads=4,
        n_kv_heads=4, vocab=512, moe_d_ff=32, d_ff=32, dense_d_ff=64,
        n_experts=8, top_k=2, q_lora_rank=32, kv_lora_rank=16,
        qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16,
        param_dtype="float32",
    )
