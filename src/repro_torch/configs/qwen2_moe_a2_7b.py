"""qwen2-moe-a2.7b [moe] — 24L d_model=2048 16H (GQA kv=16) d_ff=1408
vocab=151936, MoE 60e top-4 — 4 shared + 60 routed top-4.
[hf:Qwen/Qwen1.5-MoE-A2.7B; hf]
Copied from the reference ``repro/configs/qwen2_moe_a2_7b.py``."""

from repro_torch.configs.base import ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="qwen2-moe-a2.7b", family="moe",
        n_layers=24, d_model=2048, n_heads=16, n_kv_heads=16,
        d_ff=0, vocab_size=151936, head_dim=128,
        n_experts=60, experts_per_token=4, moe_d_ff=1408,
        n_shared_experts=4, qkv_bias=True, rope_theta=1_000_000.0,
    )


def smoke() -> ModelConfig:
    return full().replace(
        name="qwen2-moe-a2.7b-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=4, vocab_size=256, head_dim=16,
        n_experts=6, experts_per_token=2, moe_d_ff=32, n_shared_experts=2,
        moe_group_size=32,
        dtype="float32", param_dtype="float32", remat=False,
    )


register("qwen2-moe-a2.7b", full, smoke)
