"""Deterministic synthetic dataset and a resumable batcher.

``fcnn_classification_dataset`` and ``token_stream`` are copies of the
reference's numpy generators (``repro/data/pipeline.py``) and yield
bit-identical arrays for the same arguments.  ``Batcher`` yields the same batches as the
reference's: batch ``s`` holds rows ``(s·B + arange(B)) mod n``.  It
moves the dataset to the device once, at construction, and cuts each
batch there, so a training step copies nothing from the host.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np
import torch

__all__ = ["fcnn_classification_dataset", "token_stream", "Batcher"]


def fcnn_classification_dataset(
    n_samples: int, input_dim: int = 784, n_classes: int = 10, seed: int = 0,
    class_sep: float = 2.0,
) -> tuple[np.ndarray, np.ndarray]:
    """Gaussian-mixture stand-in for fashion-mnist/cifar (shapes match):
    x (n_samples, input_dim) float32, y (n_samples,) int32."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(n_classes, input_dim)).astype(np.float32)
    centers *= class_sep / np.linalg.norm(centers, axis=1, keepdims=True)
    y = rng.integers(0, n_classes, size=n_samples)
    x = centers[y] + rng.normal(size=(n_samples, input_dim)).astype(np.float32)
    return x.astype(np.float32), y.astype(np.int32)


def token_stream(
    n_tokens: int, vocab: int, seed: int = 0, zipf_a: float = 1.2,
) -> np.ndarray:
    """Zipf unigrams + deterministic bigram structure (v -> (v*7+3) % vocab
    with prob .5) so an LM can reduce loss: (n_tokens,) int32."""
    rng = np.random.default_rng(seed)
    base = rng.zipf(zipf_a, size=n_tokens).astype(np.int64) % vocab
    out = base.copy()
    follow = rng.random(n_tokens) < 0.5
    out[1:][follow[1:]] = (out[:-1][follow[1:]] * 7 + 3) % vocab
    return out.astype(np.int32)


class Batcher:
    """Iterates batches of ``data`` on ``device``; resumable via
    ``state``/``restore`` (the step counter)."""

    def __init__(self, data: dict[str, np.ndarray], batch_size: int,
                 device: torch.device | str, step: int = 0):
        self.data = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
                     for k, v in data.items()}
        self.n = len(next(iter(data.values())))
        if batch_size > self.n:
            raise ValueError(f"batch_size {batch_size} > {self.n} samples")
        self.batch_size = batch_size
        self.step = step

    def __iter__(self) -> Iterator[dict[str, torch.Tensor]]:
        return self

    def __next__(self) -> dict[str, torch.Tensor]:
        start = (self.step * self.batch_size) % self.n
        stop = start + self.batch_size
        self.step += 1
        if stop <= self.n:
            return {k: v[start:stop] for k, v in self.data.items()}
        return {k: torch.cat([v[start:], v[:stop - self.n]])
                for k, v in self.data.items()}

    # --- checkpointable state ---
    def state(self) -> dict:
        return {"step": self.step}

    def restore(self, state: dict) -> None:
        self.step = int(state["step"])
