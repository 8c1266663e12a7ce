"""mamba2-2.7b [ssm] — 64L d_model=2560 (attn-free) vocab=50280,
ssm_state=128 — SSD (state-space duality), copied from the reference
``repro/configs/mamba2_2_7b.py``.  [arXiv:2405.21060; unverified]"""

from repro_torch.configs.base import ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="mamba2-2.7b", family="ssm",
        n_layers=64, d_model=2560, n_heads=0, n_kv_heads=0,
        d_ff=0, vocab_size=50280,
        ssm_state=128, ssm_headdim=64, ssm_expand=2, ssm_chunk=128,
        ssm_groups=1, conv_kernel=4, tie_embeddings=True,
    )


def smoke() -> ModelConfig:
    return full().replace(
        name="mamba2-2.7b-smoke", n_layers=2, d_model=64, vocab_size=256,
        ssm_state=16, ssm_headdim=16, ssm_chunk=8,
        dtype="float32", param_dtype="float32", remat=False,
    )


register("mamba2-2.7b", full, smoke)
