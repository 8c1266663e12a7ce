"""zamba2-1.2b [hybrid] — 38L d_model=2048 32H (kv=32) d_ff=8192
vocab=32000, ssm_state=64 — Mamba2 + one shared attention block,
copied from the reference ``repro/configs/zamba2_1_2b.py``.
[arXiv:2411.15242; hf]"""

from repro_torch.configs.base import ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="zamba2-1.2b", family="hybrid",
        n_layers=38, d_model=2048, n_heads=32, n_kv_heads=32,
        d_ff=8192, vocab_size=32000,
        ssm_state=64, ssm_headdim=64, ssm_expand=2, ssm_chunk=128,
        conv_kernel=4, shared_attn_every=6, attn_window=32_768,
        rope_theta=10_000.0, tie_embeddings=True,
    )


def smoke() -> ModelConfig:
    return full().replace(
        name="zamba2-1.2b-smoke", n_layers=5, d_model=64, n_heads=4,
        n_kv_heads=4, d_ff=128, vocab_size=256, ssm_state=16,
        ssm_headdim=16, ssm_chunk=8, shared_attn_every=2, attn_window=64,
        dtype="float32", param_dtype="float32", remat=False,
    )


register("zamba2-1.2b", full, smoke)
