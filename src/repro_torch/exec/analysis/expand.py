"""Per-device expansion: one concrete instruction stream per device.

A ``PeriodProgram`` is a single SPMD program whose device-dependent
behaviour the executor resolves at run time with ``axis_index`` (see
exec/runtime.py).  That is exactly the resolution a static checker needs
to do *ahead* of time: which chunk a device computes, who it sends to,
whose chunk it expects at each RECV, which FREE drops which resident
chunk.  ``expand_program`` performs it, lowering the program into one
``DeviceOp`` stream per device on the ring:

  * window membership — a device appears in a period's stream iff the
    instruction's device set contains it;
  * chunk geometry — chunk index = the device's position in the RUN
    window (the executor's ``gathered[lay.window]`` selection: chunk j
    of a period's activation is computed by ``window[j]``);
  * SEND/RECV endpoints — a SEND's peers are the matching RECV's
    receivers; a RECV's peers are its chunk-ordered ``sources``
    (falling back to the same-period SEND's sender window for programs
    serialized before the annotation existed).

The expansion itself is deliberately mechanical — all judgement lives in
the checkers (``hb``: deadlocks/endpoints/memory, ``shapes``: abstract
interpretation) that consume the streams.
"""

from __future__ import annotations

import dataclasses

from repro_torch.exec.program import Opcode, PeriodProgram

__all__ = ["DeviceOp", "expand_program", "n_device_ops"]


@dataclasses.dataclass(frozen=True)
class DeviceOp:
    """One device's view of one program instruction.

    ``index`` is the instruction's position in ``program.instructions``
    so every diagnostic can point back at the SPMD source.  ``chunk`` is
    the device's column-chunk index within the period window (RUN/SEND).
    ``peers`` is the resolved endpoint set: receivers for a SEND, the
    chunk-ordered source devices for a RECV.
    """

    device: int
    index: int
    op: str                             # "run" | "send" | "recv" | "free"
    period: int
    layer: int | None = None
    phase: str | None = None            # "fp" | "bp" (RUN)
    chunk: int | None = None
    chunk_width: int | None = None
    activation: str | None = None
    peers: tuple[int, ...] = ()
    free_kind: str | None = None        # "window" | "param" (FREE)
    param_bytes: float = 0.0

    def describe(self) -> str:
        tag = f"{self.op.upper()} period {self.period}"
        if self.op == "free" and self.free_kind == "param":
            tag += f" (param, layer {self.layer})"
        return f"device {self.device} {tag}"


def expand_program(program: PeriodProgram) -> dict[int, tuple[DeviceOp, ...]]:
    """Lower ``program`` into per-device streams, program order preserved.

    Every device on the ring gets a stream (idle devices an empty one),
    so downstream checks can reason about the whole mesh.
    """
    sends = {i.period: i for i in program.instructions
             if i.opcode is Opcode.SEND}
    recvs = {i.period: i for i in program.instructions
             if i.opcode is Opcode.RECV}
    streams: dict[int, list[DeviceOp]] = {
        d: [] for d in range(program.n_devices)}

    for idx, ins in enumerate(program.instructions):
        if ins.opcode is Opcode.RUN:
            for j, d in enumerate(ins.devices):
                streams[d].append(DeviceOp(
                    device=d, index=idx, op="run", period=ins.period,
                    layer=ins.layer, phase=ins.phase, chunk=j,
                    chunk_width=ins.chunk_width,
                    activation=ins.activation,
                    param_bytes=ins.param_bytes))
        elif ins.opcode is Opcode.SEND:
            recv = recvs.get(ins.period)
            peers = tuple(recv.devices) if recv is not None else ()
            for j, d in enumerate(ins.devices):
                streams[d].append(DeviceOp(
                    device=d, index=idx, op="send", period=ins.period,
                    chunk=j, peers=peers))
        elif ins.opcode is Opcode.RECV:
            send = sends.get(ins.period)
            sources = tuple(ins.sources) or (
                tuple(send.devices) if send is not None else ())
            for d in ins.devices:
                streams[d].append(DeviceOp(
                    device=d, index=idx, op="recv", period=ins.period,
                    peers=sources))
        elif ins.opcode is Opcode.FREE:
            kind = "window" if ins.layer is None else "param"
            for d in ins.devices:
                streams[d].append(DeviceOp(
                    device=d, index=idx, op="free", period=ins.period,
                    layer=ins.layer, free_kind=kind,
                    param_bytes=ins.param_bytes))
    return {d: tuple(ops) for d, ops in streams.items()}


def n_device_ops(streams: dict[int, tuple[DeviceOp, ...]]) -> int:
    return sum(len(ops) for ops in streams.values())
