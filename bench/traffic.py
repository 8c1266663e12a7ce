"""The one generator of training traffic: token batches drawn from
``--seed`` by the parameters of a traffic file.

``token_stream`` is a copy of the program's ``data.token_stream``: Zipf
unigrams with a deterministic bigram structure (token v followed by
(7v + 3) mod vocab with probability ``follow``), so a language model's loss
can fall.  ``batches`` cuts the stream into ``pool`` batches of ``batch``
rows of ``seq`` tokens, the labels the next token (the program's
``launch.train.make_lm_data``), every row of every batch a different slice.
The steps take the batches in turn and wrap around after ``pool``.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["token_stream", "batches"]


def token_stream(n_tokens: int, vocab: int, seed: int, zipf_a: float = 1.2,
                 follow: float = 0.5) -> np.ndarray:
    """(n_tokens,) int32."""
    rng = np.random.default_rng(seed % 2**64)
    base = rng.zipf(zipf_a, size=n_tokens).astype(np.int64) % vocab
    out = base.copy()
    nxt = rng.random(n_tokens) < follow
    out[1:][nxt[1:]] = (out[:-1][nxt[1:]] * 7 + 3) % vocab
    return out.astype(np.int32)


def batches(traffic: dict, vocab: int, seed: int,
            device: torch.device | str) -> list[dict[str, torch.Tensor]]:
    """The traffic's ``pool`` batches of ``tokens`` and ``labels`` (batch,
    seq) int32 on ``device``, moved there in one copy."""
    pool = traffic["pool"]
    b, s = traffic["batch"], traffic["seq"]
    n = pool * b * s
    stream = token_stream(n + 1, vocab, seed, traffic["zipf_a"],
                          traffic["follow"])
    both = torch.from_numpy(np.stack([stream[:n], stream[1:]])).to(device)
    both = both.view(2, pool, b, s)
    return [{"tokens": both[0, i], "labels": both[1, i]} for i in range(pool)]
