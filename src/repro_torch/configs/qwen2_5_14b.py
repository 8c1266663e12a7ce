"""qwen2.5-14b [dense] — 48L d_model=5120 40H (GQA kv=8) d_ff=13824
vocab=152064 — GQA, QKV bias.  [hf:Qwen/Qwen2.5-0.5B; hf]
Copied from the reference ``repro/configs/qwen2_5_14b.py``."""

from repro_torch.configs.base import ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="qwen2.5-14b", family="dense",
        n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8,
        d_ff=13824, vocab_size=152064, head_dim=128,
        qkv_bias=True, rope_theta=1_000_000.0,
    )


def smoke() -> ModelConfig:
    return full().replace(
        name="qwen2.5-14b-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, d_ff=128, vocab_size=256, head_dim=16,
        dtype="float32", param_dtype="float32", remat=False,
    )


register("qwen2.5-14b", full, smoke)
