"""PyTorch model backend for the serving engine, counterpart of the
reference ``repro/serve/runner.py``.

  * prefill runs batch-1 at the request's own (bucketed) prompt length —
    the prompt lengths come from the traffic generator's small bucket
    list, snapped to the SSM chunk by ``snap_prompt_buckets`` for the
    hybrid (dense and MoE buckets pass through);
  * admission merges the batch-1 prefill cache into the batch cache at the
    target slot only: for each leaf, the rows of ``slot`` along the leaf's
    ``cache_batch`` axis (``model.cache_axes()``) are overwritten in place
    (``narrow(...).copy_``), so no other slot's rows can be touched;
  * decode is one batched greedy step over every slot against the
    ``max_len``-deep cache, which it updates in place.

Per-slot ``len`` rows make in-flight sequences independent, and greedy
argmax decode is row-wise deterministic, so a request's stream is a pure
function of its prompt.  Everything runs eagerly under
``torch.inference_mode``; on CUDA every prefill goes through the flash
kernel (and, for the hybrid, the SSD kernel).

The runner holds a logical ring of ``n_devices`` devices on one card, as
the executor's virtual ring does (``exec/runtime.py``): the count is what
the autoscaler prices (``serve.elastic``), and the parameters and the
cache live on the one card whatever it is.  The default is 1, what the
reference's ``jax.devices()`` gives on a one-card host.  ``rebuild`` is
the elastic path: it sets the new device count, keeps the parameters where
they are, rebuilds the cache (all cache state discarded) for the new slot
count, and the engine restarts in-flight requests from their prompts.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models.api import get_model

__all__ = ["TorchModelRunner", "snap_prompt_buckets"]


def snap_prompt_buckets(cfg: ModelConfig,
                        buckets: tuple[int, ...]) -> tuple[int, ...]:
    """SSM/hybrid chunked prefill wants seq % ssm_chunk == 0: round each
    bucket up to the chunk.  Other families pass through (deduped,
    sorted)."""
    if cfg.family in ("ssm", "hybrid") and cfg.ssm_chunk > 1:
        c = cfg.ssm_chunk
        buckets = tuple(-(-b // c) * c for b in buckets)
    return tuple(sorted(set(buckets)))


def _check_devices(n_devices: int) -> None:
    if n_devices < 1:
        raise ValueError(f"the ring needs at least one device, got "
                         f"{n_devices}")


class TorchModelRunner:
    """``ModelRunner`` over the port's model on one card, as a logical ring
    of ``n_devices`` devices.

    ``params``, when given, is the reference's parameter pytree as numpy
    arrays (``params_from_numpy``); otherwise the parameters are drawn from
    a generator on the device seeded with ``seed``."""

    def __init__(self, cfg: ModelConfig, n_slots: int, max_len: int,
                 device: str | torch.device | None = None, seed: int = 0,
                 params: dict[str, Any] | None = None, n_devices: int = 1):
        _check_devices(n_devices)
        if cfg.family in ("vlm", "encdec"):
            raise ValueError("the serving runner drives token-LM archs "
                             f"(got family {cfg.family!r})")
        self.cfg = cfg
        self.vocab = cfg.vocab_size
        self.max_len = max_len
        self.device = resolve_device(device)
        self.model = get_model(cfg)
        with torch.inference_mode():
            if params is not None:
                self.params = self.model.params_from_numpy(params, self.device)
            else:
                gen = torch.Generator(device=self.device).manual_seed(seed)
                self.params = self.model.init(gen, self.device)
        self.n_devices = n_devices
        self._build(n_slots)

    def _build(self, n_slots: int) -> None:
        self.n_slots = n_slots
        self.cache = self.model.init_cache(n_slots, self.max_len, self.device)

    def rebuild(self, n_devices: int | None = None,
                n_slots: int | None = None) -> None:
        """Elastic transition: the ring becomes ``n_devices`` logical
        devices (the survivors), the parameters stay on the card, and the
        cache is rebuilt (all cache state discarded) for ``n_slots``."""
        if n_devices is not None:
            _check_devices(n_devices)
            self.n_devices = n_devices
        self._build(n_slots if n_slots is not None else self.n_slots)

    # -- serving steps -------------------------------------------------------

    def _tokens(self, tokens: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.asarray(tokens, np.int64)).to(self.device)

    def _merge(self, one: dict[str, torch.Tensor], slot: int) -> None:
        for key, axes in self.model.cache_axes().items():
            dst = self.cache[key]
            dst.narrow(axes.index("cache_batch"), slot, 1).copy_(one[key])

    @torch.inference_mode()
    def prefill(self, slot: int, prompt: np.ndarray) -> int:
        if not 0 <= slot < self.n_slots:
            raise IndexError(f"slot {slot} out of range [0, {self.n_slots})")
        if len(prompt) + 1 > self.max_len:
            raise ValueError(
                f"prompt of {len(prompt)} tokens cannot decode into a "
                f"max_len={self.max_len} cache")
        logits, one = self.model.prefill(
            self.params, {"tokens": self._tokens(prompt)[None, :]},
            self.max_len)
        self._merge(one, slot)
        return int(torch.argmax(logits[0, -1]))

    @torch.inference_mode()
    def decode(self, last_tokens: np.ndarray) -> np.ndarray:
        logits, self.cache = self.model.decode_step(
            self.params, self.cache,
            {"tokens": self._tokens(last_tokens)[:, None]})
        return torch.argmax(logits[:, -1, :], dim=-1).to(
            torch.int32).cpu().numpy()

    # -- warmup --------------------------------------------------------------

    @torch.inference_mode()
    def warmup(self, prompt_buckets: tuple[int, ...]) -> None:
        """Run one prefill per bucket and one decode step up front, so
        measured latencies are serving work, not the kernels' build and
        the libraries' first-call set-up.  The cache is reset afterwards."""
        for b in prompt_buckets:
            self.model.prefill(
                self.params,
                {"tokens": torch.zeros((1, b), dtype=torch.int64,
                                       device=self.device)},
                self.max_len)
        self.decode(np.zeros(self.n_slots, np.int32))
        self._build(self.n_slots)
