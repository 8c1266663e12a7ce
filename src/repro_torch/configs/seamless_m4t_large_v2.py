"""seamless-m4t-large-v2 [audio] — 24L d_model=1024 16H (GQA kv=16)
d_ff=8192 vocab=256206 — enc-dec, multimodal, copied from the reference
``repro/configs/seamless_m4t_large_v2.py``.  [arXiv:2308.11596; hf]

The audio frontend (conformer feature extractor) is a stub, as in the
reference: a batch carries precomputed frame embeddings (B, S_enc,
d_model).  24 encoder + 24 decoder layers."""

from repro_torch.configs.base import ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="seamless-m4t-large-v2", family="encdec",
        n_layers=24, n_encoder_layers=24,
        d_model=1024, n_heads=16, n_kv_heads=16,
        d_ff=8192, vocab_size=256206, head_dim=64,
        rope_theta=10_000.0,
    )


def smoke() -> ModelConfig:
    return full().replace(
        name="seamless-m4t-large-v2-smoke", n_layers=2, n_encoder_layers=2,
        d_model=64, n_heads=4, n_kv_heads=4, d_ff=128, vocab_size=256,
        head_dim=16, dtype="float32", param_dtype="float32", remat=False,
    )


register("seamless-m4t-large-v2", full, smoke)
