"""qwen1.5-110b [dense] — 80L d_model=8192 64H (GQA kv=8) d_ff=49152
vocab=152064 — QKV bias.  [hf:Qwen/Qwen1.5-0.5B; hf]
Copied from the reference ``repro/configs/qwen1_5_110b.py``.
About 111 B parameters, 222 GB in bf16: more than one 80 GB card
holds, so the port runs it only in the smoke parity tests."""

from repro_torch.configs.base import ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="qwen1.5-110b", family="dense",
        n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8,
        d_ff=49152, vocab_size=152064, head_dim=128,
        qkv_bias=True, rope_theta=1_000_000.0,
    )


def smoke() -> ModelConfig:
    return full().replace(
        name="qwen1.5-110b-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, d_ff=192, vocab_size=256, head_dim=16,
        dtype="float32", param_dtype="float32", remat=False,
    )


register("qwen1.5-110b", full, smoke)
