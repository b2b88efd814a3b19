"""deepseek-v3-671b [moe] — 61L d_model=7168 128H d_ff=2048 (per expert)
vocab=129280, MoE 1 shared + 256 routed top-8, MLA, aux-loss-free bias,
MTP.  [arXiv:2412.19437; hf]"""
from repro_torch.common.config import ModelConfig

ARCH_ID = "deepseek-v3-671b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="moe",
        n_layers=61,
        d_model=7168,
        n_heads=128,
        n_kv_heads=128,
        d_ff=2048,
        vocab=129280,
        pattern=("mla",),
        # MoE
        n_experts=256,
        n_shared_experts=1,
        top_k=8,
        moe_d_ff=2048,
        first_dense_layers=3,
        dense_d_ff=18432,
        gate_fn="sigmoid",
        aux_free_bias=True,
        routed_scaling=2.5,
        # MLA
        use_mla=True,
        q_lora_rank=1536,
        kv_lora_rank=512,
        qk_nope_head_dim=128,
        qk_rope_head_dim=64,
        v_head_dim=128,
        mtp=True,
        # 671B: bf16 params + factored optimizer to fit the pod
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
