"""The model configuration dataclass, the dry-run's input shapes and the
architecture registry, copied from the reference ``repro/configs/base.py``
(``ModelConfig`` with every field, ``ShapeSpec``, ``SHAPES``,
``LONG_CONTEXT_FAMILIES``, ``shape_cells`` and the registry functions).
Only the architectures the port runs register here
(``configs/__init__.py``): the hybrid
``zamba2-1.2b``, the dense ``granite-3-2b``, ``qwen3-14b``,
``qwen2.5-14b`` and ``qwen1.5-110b``, and the MoE
``granite-moe-1b-a400m`` and ``qwen2-moe-a2.7b``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

__all__ = ["ModelConfig", "ShapeSpec", "SHAPES", "LONG_CONTEXT_FAMILIES",
           "shape_cells", "register", "get_config", "list_archs",
           "smoke_config"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0              # 0 -> d_model // n_heads
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 1_000_000.0
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    # --- MoE ---
    n_experts: int = 0
    experts_per_token: int = 0
    moe_d_ff: int = 0              # per-expert hidden dim
    n_shared_experts: int = 0
    router_aux_coef: float = 0.01
    capacity_factor: float = 1.25
    moe_group_size: int = 512      # tokens per dispatch group
    # --- SSM (Mamba2/SSD) ---
    ssm_state: int = 0
    ssm_headdim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 128
    ssm_groups: int = 1
    conv_kernel: int = 4
    # --- hybrid (zamba2) ---
    shared_attn_every: int = 0     # apply the shared attention block every k layers
    # --- enc-dec (seamless) ---
    n_encoder_layers: int = 0
    # --- vlm (qwen2-vl) ---
    mrope_sections: tuple[int, ...] = ()
    # --- numerics / execution ---
    dtype: str = "bfloat16"
    param_dtype: str = "bfloat16"
    remat: bool = True
    remat_policy: str = "full"
    accum_dtype: str = "float32"
    scan_layers: bool = True
    probe_unroll: bool = False
    # long-context decode: cap attention window for hybrid archs (0 = full)
    attn_window: int = 0
    attn_chunk_threshold: int = 4096 * 4096
    fused_ce: bool = False
    embed_onehot: bool = False
    # embedding tables are padded to a multiple of this many rows
    vocab_pad_multiple: int = 256

    @property
    def padded_vocab(self) -> int:
        m = self.vocab_pad_multiple
        return ((self.vocab_size + m - 1) // m) * m

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_headdim

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str                      # "train" | "prefill" | "decode"

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}

# long_500k needs sub-quadratic attention: only SSM/hybrid run it.
LONG_CONTEXT_FAMILIES = ("ssm", "hybrid")


def shape_cells(cfg: "ModelConfig") -> list[tuple[str, bool, str]]:
    """All four shape cells for an arch: (shape_name, runnable, reason)."""
    out = []
    for s in SHAPES.values():
        if s.name == "long_500k" and cfg.family not in LONG_CONTEXT_FAMILIES:
            out.append((s.name, False, "full-attention arch: 500k KV cache "
                        "out of HBM budget; skip sanctioned by assignment"))
        else:
            out.append((s.name, True, ""))
    return out


_REGISTRY: dict[str, Callable[[], ModelConfig]] = {}
_SMOKE: dict[str, Callable[[], ModelConfig]] = {}


def register(name: str, full: Callable[[], ModelConfig],
             smoke: Callable[[], ModelConfig]) -> None:
    _REGISTRY[name] = full
    _SMOKE[name] = smoke


def get_config(name: str) -> ModelConfig:
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]()


def smoke_config(name: str) -> ModelConfig:
    if name not in _SMOKE:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_SMOKE)}")
    return _SMOKE[name]()


def list_archs() -> list[str]:
    return sorted(_REGISTRY)
