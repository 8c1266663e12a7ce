"""qwen2-vl-72b [vlm] — 80L d_model=8192 64H (GQA kv=8) d_ff=29568
vocab=152064 — M-RoPE, dynamic resolution, copied from the reference
``repro/configs/qwen2_vl_72b.py``.  [arXiv:2409.12191; hf]

The vision frontend (ViT, dynamic resolution) is a stub, as in the
reference: a batch carries precomputed patch/text embeddings plus a
(3, B, S) position tensor for M-RoPE (sections 16/24/24 over
head_dim/2)."""

from repro_torch.configs.base import ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="qwen2-vl-72b", family="vlm",
        n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8,
        d_ff=29568, vocab_size=152064, head_dim=128,
        qkv_bias=True, rope_theta=1_000_000.0,
        mrope_sections=(16, 24, 24),
    )


def smoke() -> ModelConfig:
    return full().replace(
        name="qwen2-vl-72b-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, d_ff=128, vocab_size=256, head_dim=16,
        mrope_sections=(2, 3, 3),
        dtype="float32", param_dtype="float32", remat=False,
    )


register("qwen2-vl-72b", full, smoke)
