"""Atomic, optionally async checkpointing of trees of tensors, on the
reference's on-disk format (``repro/checkpoint/checkpointer.py``), so a
checkpoint written by either package restores in the other.

A tree is nested dicts, lists and tuples whose leaves are tensors (a
``None`` is an empty subtree).  The format:

  * ``<dir>/step_<n>/`` holds one ``.npy`` per leaf and ``manifest.json``;
    a leaf's key joins its path with ``::`` (a dict key as itself, a
    sequence index as ``[i]``: ``params::layers::[0]::w``), and its file
    name is the key with ``::`` as ``__`` (``_fname``).
  * atomic: a save writes ``<dir>/tmp.<n>`` and then ``os.replace``s it
    into ``step_<n>``, so a crash mid-save leaves the latest complete
    checkpoint as it was; ``latest_step`` sees complete steps only.
  * async: ``save(..., blocking=False)`` copies every leaf to host memory
    first and hands the write to a background thread; ``wait()`` joins it,
    and every save waits for the one before.  The copy matters here: the
    port's optimizer and train steps update tensors in place, and a CPU
    tensor's ``numpy()`` shares its memory, so a write still in flight
    would otherwise store values of a later step.
  * ``keep`` complete checkpoints are kept; older ones are removed after
    each write.
  * ``manifest.json`` holds the step, the sorted keys, any extra metadata
    (the supervisor's ``data_state``) and ``treedef``, a description of
    the tree that neither package reads back: the reference writes jax's
    own string there, the port a JSON skeleton of the tree.

``restore(step, like)`` rebuilds ``like``'s structure and puts each leaf
on ``like``'s device with ``like``'s dtype (and its ``requires_grad``);
it takes the place of the reference's ``shardings`` argument, since the
port's logical ring lives on one device.

A bfloat16 leaf is written as the reference writes one (``np.save`` of
an ``ml_dtypes.bfloat16`` array): a ``.npy`` of descr ``'<V2'`` holding
the raw two bytes of each value.  numpy has no bfloat16 and the port does
not need ``ml_dtypes``, so the leaf goes out through an int16 view, under
that header; a two-byte void array read back is viewed as int16 and then
as ``torch.bfloat16`` before it takes the target leaf's dtype.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import threading
from typing import Any, Iterator

import numpy as np
import torch

__all__ = ["Checkpointer", "latest_step"]

_SEP = "::"


def _items(tree: Any, path: tuple[str, ...] = ()) -> Iterator[tuple]:
    """(path, leaf) pairs of ``tree``: dict keys in sorted order, as jax
    flattens them; ``None`` is an empty subtree."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _items(tree[k], path + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _items(v, path + (f"[{i}]",))
    elif tree is not None:
        yield path, tree


def _flatten(tree: Any) -> dict[str, Any]:
    return {_SEP.join(path): leaf for path, leaf in _items(tree)}


def _rebuild(like: Any, leaves: dict[str, Any],
             path: tuple[str, ...] = ()) -> Any:
    """``like``'s structure with the leaf at each path from ``leaves``."""
    if isinstance(like, dict):
        return {k: _rebuild(v, leaves, path + (str(k),))
                for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        return type(like)(_rebuild(v, leaves, path + (f"[{i}]",))
                          for i, v in enumerate(like))
    if like is None:
        return None
    return leaves[_SEP.join(path)]


def _skeleton(tree: Any) -> Any:
    if isinstance(tree, dict):
        return {str(k): _skeleton(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_skeleton(v) for v in tree]
    return None if tree is None else "*"


_BF16 = np.dtype("V2")        # a bfloat16 leaf's raw bytes in numpy


def _to_host(leaf: torch.Tensor) -> np.ndarray:
    """A copy of ``leaf`` in host memory, which later in-place updates of
    the leaf cannot reach; a bfloat16 leaf as its raw bytes (``_BF16``)."""
    host = leaf.detach().to("cpu", copy=True)
    if host.dtype == torch.bfloat16:
        return host.view(torch.int16).numpy().view(_BF16)
    return host.numpy()


def _save(path: str, arr: np.ndarray) -> None:
    """``np.save``; raw bfloat16 bytes under the header ``np.save`` of an
    ``ml_dtypes.bfloat16`` array writes (descr ``'<V2'``)."""
    if arr.dtype != _BF16:
        np.save(path, arr)
        return
    with open(path, "wb") as f:
        np.lib.format.write_array_header_1_0(
            f, {"descr": "<V2", "fortran_order": False, "shape": arr.shape})
        np.ascontiguousarray(arr).view(np.int16).tofile(f)


def _like(arr: np.ndarray, leaf: torch.Tensor) -> torch.Tensor:
    """``arr`` on ``leaf``'s device with its dtype and ``requires_grad``;
    two-byte void data is bfloat16."""
    if arr.dtype == _BF16:
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    t = t.to(device=leaf.device, dtype=leaf.dtype)
    return t.requires_grad_(leaf.requires_grad)


def latest_step(directory: str) -> int | None:
    if not os.path.isdir(directory):
        return None
    steps = [int(m.group(1)) for d in os.listdir(directory)
             if (m := re.fullmatch(r"step_(\d+)", d))]
    return max(steps) if steps else None


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        self._thread: threading.Thread | None = None
        os.makedirs(directory, exist_ok=True)

    # ------------------------------------------------------------------ save
    def save(self, step: int, state: Any, blocking: bool = True,
             extra_meta: dict | None = None) -> None:
        self.wait()
        host = {k: _to_host(v) for k, v in _flatten(state).items()}
        meta = {
            "step": step,
            "treedef": json.dumps(_skeleton(state), sort_keys=True),
            "keys": sorted(host),
            **(extra_meta or {}),
        }

        def _write():
            tmp = os.path.join(self.directory, f"tmp.{step}")
            final = os.path.join(self.directory, f"step_{step}")
            shutil.rmtree(tmp, ignore_errors=True)
            os.makedirs(tmp)
            for k, v in host.items():
                _save(os.path.join(tmp, _fname(k)), v)
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(meta, f)
            shutil.rmtree(final, ignore_errors=True)
            os.replace(tmp, final)
            self._gc()

        if blocking:
            _write()
        else:
            self._thread = threading.Thread(target=_write, daemon=True)
            self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self) -> None:
        steps = sorted(
            int(m.group(1)) for d in os.listdir(self.directory)
            if (m := re.fullmatch(r"step_(\d+)", d)))
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s}"),
                          ignore_errors=True)

    # --------------------------------------------------------------- restore
    def restore(self, step: int, like: Any) -> Any:
        """The checkpoint of ``step`` in the structure of ``like``, each
        leaf on ``like``'s leaf's device with its dtype."""
        d = os.path.join(self.directory, f"step_{step}")
        if not os.path.isdir(d):
            raise FileNotFoundError(d)
        leaves = {k: _like(np.load(os.path.join(d, _fname(k))), leaf)
                  for k, leaf in _flatten(like).items()}
        return _rebuild(like, leaves)

    def meta(self, step: int) -> dict:
        with open(os.path.join(self.directory, f"step_{step}",
                               "manifest.json")) as f:
            return json.load(f)


def _fname(key: str) -> str:
    return key.replace(_SEP, "__").replace("/", "_") + ".npy"
