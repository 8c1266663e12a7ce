"""The ONoC allocator carried onto a device mesh, copied from the
reference ``repro/core/planner.py`` (``feasible_degrees``,
``ring_mesh_axes``, ``plan_fcnn``): per-period Lemma-1 core counts
snapped to mesh-feasible sharding degrees, with the chosen mapping
strategy determining the ring order.  ``H100Target`` is the port's
counterpart of the reference's ``TPUTarget``: the data-sheet figures of
the one card the dry-run (``launch/dryrun.py``) prices.  ``TPUTarget``
and the transformer GEMM planner ``plan_gemm_period`` price a TPU mesh
and are not copied.
"""

from __future__ import annotations

import dataclasses
import itertools
import math

from .allocation import Mapping, MappingStrategy, map_cores
from .onoc_model import (
    FCNNWorkload,
    ONoCConfig,
    comm_time,
    compute_time,
    optimal_cores,
)

__all__ = ["H100Target", "PeriodPlan", "FCNNPlan", "plan_fcnn",
           "feasible_degrees", "ring_mesh_axes"]


@dataclasses.dataclass(frozen=True)
class H100Target:
    """NVIDIA H100 SXM data-sheet figures (dense rates, 700 W): HBM
    bandwidth, bf16 on the tensor cores, fp32 outside them (the port runs
    with TF32 off), TF32 on the tensor cores (the products of the fp32
    backwards of K6 and K7, each split into three TF32 products), and HBM
    capacity."""

    hbm_bw: float = 3.35e12           # bytes/s
    peak_flops: float = 989e12        # bf16
    fp32_flops: float = 67e12
    tf32_flops: float = 495e12
    hbm_bytes: float = 80e9

    def flop_rate(self, dtype: str) -> float:
        """Peak FLOP/s of products whose operands are ``dtype``."""
        rates = {"bfloat16": self.peak_flops, "float32": self.fp32_flops,
                 "tfloat32": self.tf32_flops}
        if dtype not in rates:
            raise ValueError(f"no H100 peak for {dtype} operations; "
                             f"known: {sorted(rates)}")
        return rates[dtype]


@dataclasses.dataclass(frozen=True)
class PeriodPlan:
    period: int
    onoc_cores: int          # Lemma-1 m_i* (the paper's answer)
    degree: int              # mesh-feasible sharding degree
    axes: tuple[str, ...]    # mesh axes realizing the degree
    compute_s: float
    comm_s: float


@dataclasses.dataclass(frozen=True)
class FCNNPlan:
    periods: tuple[PeriodPlan, ...]
    mapping: Mapping
    strategy: str

    @property
    def degrees(self) -> list[int]:
        return [p.degree for p in self.periods]


def feasible_degrees(mesh_axes: dict[str, int]) -> dict[int, tuple[str, ...]]:
    """All sharding degrees expressible as a product of any subset of mesh
    axes.  When several subsets give the same degree, the recorded axes
    prefer fewer axes, then the canonical order "model", "data", "pod"."""
    order = [a for a in ("model", "data", "pod") if a in mesh_axes]
    order += [a for a in mesh_axes if a not in order]
    out: dict[int, tuple[str, ...]] = {1: ()}
    for size in range(1, len(order) + 1):
        for axes in itertools.combinations(order, size):
            prod = math.prod(mesh_axes[a] for a in axes)
            out.setdefault(prod, axes)
    return out


def ring_mesh_axes(n_devices: int, prefix: str = "ring") -> dict[str, int]:
    """Mesh axes whose subset products cover every divisor of n_devices:
    one axis per prime factor (with multiplicity)."""
    if n_devices < 1:
        raise ValueError("n_devices >= 1")
    axes: dict[str, int] = {}
    rem, p, k = n_devices, 2, 0
    while rem > 1:
        while rem % p == 0:
            axes[f"{prefix}{k}"] = p
            rem //= p
            k += 1
        p += 1 if p == 2 else 2
    return axes or {f"{prefix}0": 1}


def plan_fcnn(
    workload: FCNNWorkload,
    onoc_cfg: ONoCConfig,
    mesh_axes: dict[str, int],
    strategy: MappingStrategy | str = MappingStrategy.ORRM,
    refine_plateau: bool = True,
) -> FCNNPlan:
    """Paper-faithful plan: Lemma-1 core counts snapped to the mesh."""
    stars = optimal_cores(workload, onoc_cfg, refine_plateau=refine_plateau)
    feas = feasible_degrees(mesh_axes)
    n_dev = math.prod(mesh_axes.values())

    periods = []
    for i, m_star in enumerate(stars, start=1):
        n_i = workload.n(i)
        cap = min(n_i, n_dev)
        # the paper's even-mapping constraint: only degrees dividing n_i
        eligible = {d: ax for d, ax in feas.items()
                    if d <= cap and n_i % d == 0}
        if not eligible:
            eligible = {1: ()}
        deg = min(eligible,
                  key=lambda d: abs(math.log(d / max(min(m_star, cap), 1))))
        periods.append(PeriodPlan(
            period=i, onoc_cores=m_star, degree=deg, axes=feas.get(deg, ()),
            compute_s=compute_time(workload, onoc_cfg, i, m_star),
            comm_s=comm_time(workload, onoc_cfg, i, m_star),
        ))
    mapping = map_cores(workload, onoc_cfg, strategy, stars)
    return FCNNPlan(periods=tuple(periods), mapping=mapping,
                    strategy=MappingStrategy(strategy).value)
