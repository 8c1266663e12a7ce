"""qwen3-14b [dense] — 40L d_model=5120 40H (GQA kv=8) d_ff=17408
vocab=151936 — qk_norm, GQA.  [hf:Qwen/Qwen3-8B; hf]
Copied from the reference ``repro/configs/qwen3_14b.py``."""

from repro_torch.configs.base import ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="qwen3-14b", family="dense",
        n_layers=40, d_model=5120, n_heads=40, n_kv_heads=8,
        d_ff=17408, vocab_size=151936, head_dim=128,
        qkv_bias=False, qk_norm=True, rope_theta=1_000_000.0,
    )


def smoke() -> ModelConfig:
    return full().replace(
        name="qwen3-14b-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, d_ff=128, vocab_size=256, head_dim=16,
        dtype="float32", param_dtype="float32", remat=False,
    )


register("qwen3-14b", full, smoke)
