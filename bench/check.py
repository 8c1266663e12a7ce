"""The comparison that decides ``correct`` for a training cell.

Three numbers compare what the program's first steps produced with the
reference's run of the same steps from the same parameters and batches:

``loss_gap``    the largest relative gap of a step's loss;
``grad_gap``    the first step's gradient as the optimizer took it: over the
                leaves, the largest gap between the program's norm and the
                reference's, relative to the larger of the reference's norm of
                that leaf and its median leaf's;
``change_gap``  the parameters' change over the steps, measured so, over the
                leaves whose reference gradient is at least a thousandth of
                the median leaf's (a gradient nought to rounding moves a leaf
                by round-off alone).

A leaf is one layer of a stacked parameter (``leaf_norms``).  Each number
has a limit of its own in the cell's file under ``bench/cells/``; the run is
correct when no number is past its limit.
"""

from __future__ import annotations

import math
import statistics

import torch

__all__ = ["NUMBERS", "leaf_names", "leaf_norms", "left_out", "gaps",
           "worst_leaves", "judge"]

NUMBERS = ("loss_gap", "grad_gap", "change_gap")
MOVED_SHARE = 1e-3      # a leaf's reference gradient under this share of the
                        # median leaf's is left out of change_gap


def leaf_names(path: str, shape: tuple[int, ...]) -> list[str]:
    """The leaves a parameter is compared as: one a layer of a stacked
    ("layers/...") parameter, else the whole parameter."""
    if path.startswith("layers/"):
        return [f"{path}[{i}]" for i in range(shape[0])]
    return [path]


@torch.no_grad()
def leaf_norms(path: str, t: torch.Tensor) -> dict[str, float]:
    """The fp32 norm of each leaf of parameter ``path``."""
    names = leaf_names(path, tuple(t.shape))
    if len(names) == 1:
        return {names[0]: float(torch.linalg.vector_norm(t, dtype=torch.float32))}
    norms = torch.linalg.vector_norm(t.flatten(1), dim=1, dtype=torch.float32)
    return dict(zip(names, norms.tolist()))


def _by_leaf(prog: dict[str, float], ref: dict[str, float],
             leaves: list[str]) -> dict[str, float]:
    floor = statistics.median(ref[k] for k in leaves)
    out = {}
    for k in leaves:
        gap = abs(prog[k] - ref[k]) / max(ref[k], floor)
        out[k] = gap if math.isfinite(gap) else math.inf
    return out


def worst_leaves(prog: dict, ref: dict, n: int = 3) -> dict[str, list]:
    """The ``n`` leaves with the largest gaps of each per-leaf number, as
    (leaf, gap, program's norm, reference's norm): what a run prints
    beside the numbers."""
    out = {}
    for key, number in (("grad", "grad_gap"), ("change", "change_gap")):
        gaps_ = _by_leaf(prog[key], ref[key], sorted(ref[key]))
        top = sorted(gaps_, key=lambda k: -gaps_[k])[:n]
        out[number] = [(k, gaps_[k], prog[key][k], ref[key][k]) for k in top]
    return out


def left_out(ref: dict) -> list[str]:
    """The leaves ``change_gap`` leaves out: reference gradient under
    ``MOVED_SHARE`` of the median leaf's."""
    floor = statistics.median(ref["grad"].values())
    return sorted(k for k, g in ref["grad"].items() if g < MOVED_SHARE * floor)


def gaps(prog: dict, ref: dict) -> dict[str, float]:
    """The three numbers of ``prog`` against ``ref``, each a dict of
    ``losses`` (per step), ``grad`` and ``change`` (per leaf)."""
    if len(prog["losses"]) != len(ref["losses"]) or \
            prog["grad"].keys() != ref["grad"].keys():
        raise ValueError("the program's and the reference's readings differ "
                         "in steps or leaves")
    steps = [abs(p - r) / abs(r) if math.isfinite(p) else math.inf
             for p, r in zip(prog["losses"], ref["losses"])]
    leaves = sorted(ref["grad"])
    moved = sorted(set(leaves) - set(left_out(ref)))
    return {"loss_gap": max(steps),
            "grad_gap": max(_by_leaf(prog["grad"], ref["grad"],
                                     leaves).values()),
            "change_gap": max(_by_leaf(prog["change"], ref["change"],
                                       moved).values())}


def judge(numbers: dict[str, float], limits: dict[str, float]) -> dict:
    """Each number beside its limit, and whether all are within."""
    rows = {k: {"value": numbers[k], "limit": limits[k]} for k in NUMBERS}
    ok = all(r["value"] <= r["limit"] for r in rows.values())
    return {"ok": ok, "rows": rows}
