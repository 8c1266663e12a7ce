"""granite-moe-1b-a400m [moe] — 24L d_model=1024 16H (GQA kv=8) d_ff=512
vocab=49155, MoE 32e top-8.  [hf:ibm-granite/granite-3.0-1b-a400m-base; hf]
Copied from the reference ``repro/configs/granite_moe_1b.py``."""

from repro_torch.configs.base import ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="granite-moe-1b-a400m", family="moe",
        n_layers=24, d_model=1024, n_heads=16, n_kv_heads=8,
        d_ff=0, vocab_size=49155, head_dim=64,
        n_experts=32, experts_per_token=8, moe_d_ff=512,
        rope_theta=10_000.0, tie_embeddings=True,
    )


def smoke() -> ModelConfig:
    return full().replace(
        name="granite-moe-1b-a400m-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, vocab_size=256, head_dim=16,
        n_experts=8, experts_per_token=2, moe_d_ff=32, moe_group_size=32,
        dtype="float32", param_dtype="float32", remat=False,
    )


register("granite-moe-1b-a400m", full, smoke)
