"""Seeded corruption corpus: programs the validator passes but the
analyzer must reject.

Each corruption targets a blind spot of ``validate_program``'s SPMD-level
set/ledger checks (which are order-insensitive within a period and never
read ``sources``, ``batch_size`` or ``activation``):

  * ``deadlocked-send-cycle``   — swap a transition period's SEND and
    RECV in the instruction stream.  Any device in both windows then
    posts its blocking RECV (which waits on *all* senders, itself
    included) before its own SEND: a happens-before cycle, i.e. a
    communication deadlock.
  * ``swapped-recv-source``     — rotate a RECV's chunk-ordered
    ``sources``: every chunk is still supplied by a legitimate sender
    (the multiset matches, so nothing hangs), but each receiver gathers
    the *wrong device's* chunk — silent wrong numerics at run time.
  * ``free-before-last-use``    — move one leaving device's window FREE
    before the same period's SEND, on that device only: its stream frees
    the activation chunk the SEND is about to read (use-after-FREE).
  * ``shape-mismatched-run``    — corrupt ``batch_size`` (the validator
    prices costs from the workload argument, never from the program's
    own batch) and, separately, flip a hidden-layer RUN's activation
    annotation — both caught only by the shape abstract interpreter.

``corruption_corpus`` derives all of them from one valid program with a
seeded RNG (reproducible; the seed picks among eligible periods), and
every entry records the regex its ``ProgramAnalysisError`` must match.
"""

from __future__ import annotations

import dataclasses
import random

from repro_torch.exec.program import Instruction, Opcode, PeriodProgram

__all__ = ["CorruptedProgram", "corruption_corpus"]


@dataclasses.dataclass(frozen=True)
class CorruptedProgram:
    """One corpus entry: a corrupted program plus the expected rejection."""

    name: str
    description: str
    program: PeriodProgram
    match: str          # regex the ProgramAnalysisError message must match


def _with_instrs(program: PeriodProgram, instrs) -> PeriodProgram:
    return dataclasses.replace(program, instructions=tuple(instrs))


def _deadlocked_send_cycle(program, rng) -> CorruptedProgram | None:
    instrs = list(program.instructions)
    sends = {i.period: idx for idx, i in enumerate(instrs)
             if i.opcode is Opcode.SEND}
    recvs = {i.period: idx for idx, i in enumerate(instrs)
             if i.opcode is Opcode.RECV}
    eligible = [p for p in sends if p in recvs and
                set(instrs[sends[p]].devices)
                & set(instrs[recvs[p]].devices)]
    if not eligible:
        return None
    p = rng.choice(sorted(eligible))
    si, ri = sends[p], recvs[p]
    instrs[si], instrs[ri] = instrs[ri], instrs[si]
    overlap = sorted(set(program.instructions[si].devices)
                     & set(program.instructions[ri].devices))
    return CorruptedProgram(
        name="deadlocked-send-cycle",
        description=(f"period-{p} RECV scheduled before its SEND; devices "
                     f"{overlap} are in both windows, so each waits on its "
                     f"own later SEND"),
        program=_with_instrs(program, instrs),
        match="deadlock",
    )


def _swapped_recv_source(program, rng) -> CorruptedProgram | None:
    instrs = list(program.instructions)
    eligible = [idx for idx, i in enumerate(instrs)
                if i.opcode is Opcode.RECV and len(set(i.sources)) > 1]
    if not eligible:
        return None
    idx = rng.choice(eligible)
    ins = instrs[idx]
    k = rng.randrange(1, len(ins.sources))
    rotated = ins.sources[k:] + ins.sources[:k]
    instrs[idx] = dataclasses.replace(ins, sources=rotated)
    return CorruptedProgram(
        name="swapped-recv-source",
        description=(f"period-{ins.period} RECV sources rotated by {k}: "
                     f"{list(ins.sources)} -> {list(rotated)}; every chunk "
                     f"still has a sender, but the wrong one"),
        program=_with_instrs(program, instrs),
        match="swapped RECV source",
    )


def _free_before_last_use(program, rng) -> CorruptedProgram | None:
    instrs = list(program.instructions)
    sends = {i.period: idx for idx, i in enumerate(instrs)
             if i.opcode is Opcode.SEND}
    eligible = [idx for idx, i in enumerate(instrs)
                if i.opcode is Opcode.FREE and i.layer is None
                and i.period in sends
                and set(i.devices) <= set(instrs[sends[i.period]].devices)]
    if not eligible:
        return None
    idx = rng.choice(eligible)
    free = instrs[idx]
    victim = rng.choice(sorted(free.devices))
    # split the FREE: the victim's half moves before the SEND, the rest
    # (if any) stays in place — the corruption is on one device only
    rest = tuple(d for d in free.devices if d != victim)
    del instrs[idx]
    if rest:
        instrs.insert(idx, dataclasses.replace(free, devices=rest))
    instrs.insert(sends[free.period],
                  dataclasses.replace(free, devices=(victim,)))
    return CorruptedProgram(
        name="free-before-last-use",
        description=(f"device {victim}'s window FREE at period "
                     f"{free.period} moved before the SEND that still "
                     f"reads its activation chunk"),
        program=_with_instrs(program, instrs),
        match="use-after-FREE",
    )


def _shape_mismatched_batch(program, rng) -> CorruptedProgram:
    factor = rng.choice([2, 3, 5])
    return CorruptedProgram(
        name="shape-mismatched-run-batch",
        description=(f"batch_size corrupted {program.batch_size} -> "
                     f"{program.batch_size * factor}; the validator prices "
                     f"costs from the workload argument and never reads it"),
        program=dataclasses.replace(
            program, batch_size=program.batch_size * factor),
        match="batch",
    )


def _shape_mismatched_activation(program, rng) -> CorruptedProgram | None:
    instrs = list(program.instructions)
    eligible = [idx for idx, i in enumerate(instrs)
                if i.opcode is Opcode.RUN and i.phase == "fp"
                and i.activation == "sigmoid"]
    if not eligible:
        return None
    idx = rng.choice(eligible)
    ins = instrs[idx]
    wrong = rng.choice(["none", "relu", "tanh"])
    instrs[idx] = dataclasses.replace(ins, activation=wrong)
    return CorruptedProgram(
        name="shape-mismatched-run-activation",
        description=(f"period-{ins.period} RUN activation flipped "
                     f"'sigmoid' -> {wrong!r}"),
        program=_with_instrs(program, instrs),
        match="activation mismatch",
    )


_BUILDERS = (
    _deadlocked_send_cycle,
    _swapped_recv_source,
    _free_before_last_use,
    _shape_mismatched_batch,
    _shape_mismatched_activation,
)


def corruption_corpus(program: PeriodProgram,
                      seed: int = 0) -> tuple[CorruptedProgram, ...]:
    """Derive the corpus from one valid ``program``.

    Raises ``ValueError`` when the program offers no eligible site for
    some corruption (e.g. a schedule with no window overlap anywhere) —
    tests should feed a program where all entries are constructible.
    """
    out = []
    for builder in _BUILDERS:
        entry = builder(program, random.Random(seed))
        if entry is None:
            raise ValueError(
                f"program offers no eligible corruption site for "
                f"{builder.__name__}")
        out.append(entry)
    return tuple(out)
