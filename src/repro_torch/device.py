"""Device selection for the port's entry points: the card unless the
caller asks for the CPU, and never a quiet fallback."""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``torch.device`` an entry point should run on.

    ``None`` means ``cuda``.  Asking for ``cuda`` (explicitly or by
    default) on a machine without a usable GPU raises ``RuntimeError``;
    only an explicit ``"cpu"`` runs on the host, with the kernels' plain
    PyTorch versions, and only an explicit ``"meta"`` runs shapes alone
    (the dry-run, ``launch/dryrun.py``).
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions on the host")
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"unsupported device {dev}")
    return dev
