"""granite-3-2b [dense] — 40L d_model=2048 32H (GQA kv=8) d_ff=8192
vocab=49155 — GQA.  [hf:ibm-granite/granite-3.0-2b-base; hf]
Copied from the reference ``repro/configs/granite_3_2b.py``."""

from repro_torch.configs.base import ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="granite-3-2b", family="dense",
        n_layers=40, d_model=2048, n_heads=32, n_kv_heads=8,
        d_ff=8192, vocab_size=49155, head_dim=64,
        qkv_bias=False, rope_theta=10_000.0, tie_embeddings=True,
    )


def smoke() -> ModelConfig:
    return full().replace(
        name="granite-3-2b-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, d_ff=128, vocab_size=256, head_dim=16,
        dtype="float32", param_dtype="float32", remat=False,
    )


register("granite-3-2b", full, smoke)
