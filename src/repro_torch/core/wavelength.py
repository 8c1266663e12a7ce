"""Routing and Wavelength Assignment (RWA) — paper Section 4.6 / Fig. 6.

Copied from the reference ``repro/core/wavelength.py``, unchanged.

The manager core computes the optimal core counts; the RWA turns each
period transition into a *wavelength matrix* WM where WM[s, d] = k means
sender core s talks to receiver core d on wavelength λ_k.  With m_i senders
and λ_max wavelengths, senders are batched into ceil(m_i / λ_max) TDM time
slots; within a slot every sender broadcasts on its own wavelength to all
receivers (the ring drop-filters tap a fraction of the signal, Fig. 3).

Transmission direction is clockwise in FP and counter-clockwise in BP
(paper Section 4.6).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from .allocation import Mapping

__all__ = ["TimeSlot", "WavelengthSchedule", "assign_wavelengths", "schedule_epoch"]

UNASSIGNED = -1


@dataclasses.dataclass(frozen=True)
class TimeSlot:
    """One TDM slot: senders transmit concurrently on distinct wavelengths."""

    senders: tuple[int, ...]          # core ids
    wavelengths: tuple[int, ...]      # λ index per sender, same order
    receivers: tuple[int, ...]        # all receivers (broadcast)


@dataclasses.dataclass(frozen=True)
class WavelengthSchedule:
    """All TDM slots of one period transition + the dense WM matrix."""

    period: int                       # sending period
    direction: str                    # "cw" (FP) or "ccw" (BP)
    slots: tuple[TimeSlot, ...]
    wm: np.ndarray                    # (m, m) int matrix, UNASSIGNED where none

    @property
    def n_slots(self) -> int:
        return len(self.slots)


def assign_wavelengths(
    senders: Sequence[int],
    receivers: Sequence[int],
    lambda_max: int,
    m: int,
    period: int = 0,
    direction: str = "cw",
) -> WavelengthSchedule:
    """Build the WM matrix and TDM slots for one period transition.

    Wavelengths are assigned round-robin (sender j in a slot gets λ_j), the
    schedule Fig. 6 shows: λ_1..λ_k for the k concurrent senders of a slot,
    wavelengths reused across slots.
    """
    if lambda_max < 1:
        raise ValueError("lambda_max >= 1")
    senders = list(dict.fromkeys(int(s) for s in senders))   # stable unique
    receivers = tuple(dict.fromkeys(int(r) for r in receivers))
    wm = np.full((m, m), UNASSIGNED, dtype=np.int32)
    slots: list[TimeSlot] = []
    for off in range(0, len(senders), lambda_max):
        batch = senders[off : off + lambda_max]
        lams = tuple(range(len(batch)))
        for s, lam in zip(batch, lams):
            for r in receivers:
                if r != s:
                    wm[s, r] = lam
        slots.append(TimeSlot(senders=tuple(batch), wavelengths=lams,
                              receivers=receivers))
    return WavelengthSchedule(
        period=period, direction=direction, slots=tuple(slots), wm=wm
    )


def schedule_epoch(mapping: Mapping, lambda_max: int) -> list[WavelengthSchedule]:
    """RWA schedules for every communicating period transition of one epoch.

    Communicating transitions (see onoc_model.comm_time): FP periods
    2..l-1 send to the next FP period; BP periods l+1..2l-1 send to the next
    BP period.  Periods 1, l and 2l send nothing (Eq. 6); the period-1 ->
    period-2 hand-off is folded into Period 0/1 loading in the paper's model,
    but the physical broadcast still needs wavelengths, so we emit its
    schedule too, tagged period=1 (benchmarks may exclude it to match
    Eq. (6) exactly).
    """
    l = mapping.l
    out: list[WavelengthSchedule] = []
    for i in range(1, 2 * l):
        senders = mapping.window(i)
        receivers = mapping.window(i + 1)
        if i in (l, 2 * l):
            continue  # no send out of period l (loss is local) per Eq. (6)
        direction = "cw" if i < l else "ccw"
        out.append(
            assign_wavelengths(
                senders, receivers, lambda_max, mapping.m, period=i,
                direction=direction,
            )
        )
    return out
