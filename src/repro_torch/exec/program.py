"""Schedule compiler: planner plan + mapping -> static instruction program,
copied from the reference ``repro/exec/program.py``: the port's programs
are the reference's, string for string (``to_json``).

A ``PeriodProgram`` is the executable form of one training epoch of the
paper's fine-grained model: for each of the 2l periods, a RUN instruction
(the fused per-shard math), and between consecutive periods the SEND/RECV
pair that moves activations from one period's core window to the next's,
plus FREE for cores that leave the active window.  The instruction set
follows alpa's decentralized static runtime (RUN/SEND/RECV/FREE), with one
difference: alpa compiles a per-worker program, while we compile a single
SPMD program whose device-dependent behaviour the executor resolves per
device of its ring (see exec/runtime.py).

Two levels of placement coexist in one program:

  * the **paper level** — the Lemma-1 core counts m_i* on the cfg.m-core
    ring, placed by the chosen mapping strategy.  All cost annotations
    (``cost_s`` on RUN and SEND) are priced at this level with exactly the
    conventions of ``core.simulator.simulate_epoch``: 2l-2 transitions, at
    periods {1..2l-1} minus {l}; on ONoC the period-1 hand-off costs zero
    (Eq. 6 folds it into Period-0 loading) though its traffic is recorded.
    Every RUN and SEND cost equals the simulator's for its period, so the
    closed-form model becomes an executable contract.  The totals
    ``program.compute_s``/``comm_s`` sum with builtin ``sum()``, which is
    compensated on Python 3.12, while ``simulate_epoch`` adds with ``+=``:
    they can differ in the last bit, as the reference's do, so compare
    them per transition (tests/test_torch_exec_program.py).

  * the **device level** — the same schedule re-placed on the executor's
    n-device ring: per FP period a mesh-feasible degree d_i (a divisor of
    both n_devices and the layer width n_i, log-closest to the planner's
    degree), and a device window produced by running the *same* mapping
    strategy (Algorithm 1 et al.) on the n-device ring.  RUN carries the
    window and column-chunk geometry the executor needs; FREE lists the
    devices whose chunks are dropped at each transition.

Programs are plain data: serializable via ``to_json``/``from_json`` so a
compiled schedule can be shipped to workers or diffed across PRs.

Schema v2 makes parameter **residency** explicit (the weight-sharded
executor, exec/runtime.py): every RUN carries ``param_bytes`` — the bytes
of the (n_{i-1}+1) x (n_i/d_i) weight+bias column chunk each window device
holds for that period — and each layer's chunks are released by a *param*
FREE (``layer`` set, ``param_bytes`` set) scheduled immediately after the
chunk's last use, the layer's BP mirror period 2l-i+1 (Eq. 11).  The
original window FREEs (``layer`` is None) keep their schema-v1 meaning:
a device leaving the *active* window drops its activations but keeps its
weight chunks for BP.  ``exec.validate`` checks the byte ledger drains to
exactly zero and that no RUN executes on freed chunks;
``exec.residency.ResidencyTracker`` turns the annotations into a
per-device live-bytes timeline.
"""

from __future__ import annotations

import dataclasses
import enum
import json
import math

from repro_torch.core.allocation import Mapping, MappingStrategy, map_cores
from repro_torch.core.onoc_model import (
    FCNNWorkload,
    ONoCConfig,
    compute_time,
    period_layer,
)
from repro_torch.core.planner import FCNNPlan, plan_fcnn, ring_mesh_axes
from repro_torch.core.simulator import ONoCBackend
from repro_torch.models.fcnn import period_activation

__all__ = [
    "Opcode",
    "Instruction",
    "PeriodProgram",
    "compile_program",
    "compile_fcnn_program",
    "snap_to_ring_degree",
]

_JSON_VERSION = 2        # v2: residency annotations (param_bytes, param FREEs)


class Opcode(str, enum.Enum):
    RUN = "run"
    SEND = "send"
    RECV = "recv"
    FREE = "free"


@dataclasses.dataclass(frozen=True)
class Instruction:
    """One static instruction of the per-period program.

    ``devices`` is the instruction's device set on the executor ring: the
    active window for RUN, senders for SEND, receivers for RECV, released
    devices for FREE.  ``cost_s`` is the paper-level cost annotation
    (compute_time for RUN, the backend transition time for SEND; RECV and
    FREE are free — the transition is charged once, on the sender side,
    matching the simulator's one-comm_s-per-transition convention).
    """

    opcode: Opcode
    period: int
    devices: tuple[int, ...] = ()
    cost_s: float = 0.0
    # RUN fields (``layer`` is also set on param FREEs, see below)
    layer: int | None = None
    phase: str | None = None            # "fp" | "bp"
    activation: str | None = None
    onoc_cores: int | None = None       # paper-level m_i*
    degree: int | None = None           # device-level d_i
    chunk_width: int | None = None      # n_layer // d_i output columns
    # SEND annotations (from the backend's TransitionTraffic)
    bytes_per_sender: float = 0.0
    slots: int = 0
    hop_bytes: float = 0.0
    # residency annotation (schema v2): per-device bytes of the layer's
    # weight+bias column chunk — held by each window device for a RUN,
    # released by a param FREE (opcode FREE with ``layer`` set)
    param_bytes: float = 0.0
    # RECV endpoint annotation: chunk j of the gathered activation comes
    # from device ``sources[j]`` — the chunk-ordered sender window of the
    # matching SEND.  Empty on pre-analysis programs (the analyzer then
    # derives it from the SEND at the same period).
    sources: tuple[int, ...] = ()

    @classmethod
    def RUN(cls, period, layer, phase, activation, onoc_cores, degree,
            chunk_width, window, cost_s, param_bytes=0.0):
        return cls(opcode=Opcode.RUN, period=period, devices=tuple(window),
                   cost_s=cost_s, layer=layer, phase=phase,
                   activation=activation, onoc_cores=onoc_cores,
                   degree=degree, chunk_width=chunk_width,
                   param_bytes=param_bytes)

    @classmethod
    def SEND(cls, period, senders, cost_s, bytes_per_sender, slots,
             hop_bytes):
        return cls(opcode=Opcode.SEND, period=period, devices=tuple(senders),
                   cost_s=cost_s, bytes_per_sender=bytes_per_sender,
                   slots=slots, hop_bytes=hop_bytes)

    @classmethod
    def RECV(cls, period, receivers, sources=()):
        return cls(opcode=Opcode.RECV, period=period,
                   devices=tuple(receivers), sources=tuple(sources))

    @classmethod
    def FREE(cls, period, released, layer=None, param_bytes=0.0):
        """``layer`` is None for a window FREE (a device leaves the active
        window, dropping activations); set for a param FREE (the released
        devices drop their ``param_bytes`` chunk of that layer)."""
        return cls(opcode=Opcode.FREE, period=period,
                   devices=tuple(released), layer=layer,
                   param_bytes=param_bytes)


@dataclasses.dataclass(frozen=True)
class PeriodProgram:
    """A compiled epoch schedule: static instructions + cost annotations."""

    layer_sizes: tuple[int, ...]
    batch_size: int
    strategy: str
    backend: str
    n_devices: int
    onoc_cores: tuple[int, ...]         # paper m_i*, FP periods 1..l
    degrees: tuple[int, ...]            # executor degree d_i, FP periods
    instructions: tuple[Instruction, ...]
    version: int = _JSON_VERSION        # schema version (v2: residency)

    @property
    def l(self) -> int:  # noqa: E743 — paper notation
        return len(self.layer_sizes) - 1

    def runs(self, phase: str | None = None) -> list[Instruction]:
        return [i for i in self.instructions if i.opcode is Opcode.RUN
                and (phase is None or i.phase == phase)]

    def sends(self) -> list[Instruction]:
        return [i for i in self.instructions if i.opcode is Opcode.SEND]

    def frees(self, kind: str | None = None) -> list[Instruction]:
        """FREE instructions: all (None), only window FREEs (``"window"``,
        layer is None) or only param FREEs (``"param"``, layer set)."""
        fs = [i for i in self.instructions if i.opcode is Opcode.FREE]
        if kind == "window":
            return [f for f in fs if f.layer is None]
        if kind == "param":
            return [f for f in fs if f.layer is not None]
        if kind is not None:
            raise ValueError(f"kind must be None, 'window' or 'param', "
                             f"got {kind!r}")
        return fs

    @property
    def compute_s(self) -> float:
        """Paper-level epoch compute — equals EpochTrace.compute_s."""
        return float(sum(i.cost_s for i in self.runs()))

    @property
    def comm_s(self) -> float:
        """Paper-level epoch comm — EpochTrace.comm_s, transition for
        transition.  Builtin ``sum()`` is kept as the reference has it, so
        the port's totals equal the reference's; it may differ from the
        simulator's ``+=`` total in the last bit."""
        return float(sum(i.cost_s for i in self.sends()))

    @property
    def total_s(self) -> float:
        return self.compute_s + self.comm_s

    def transition_schedule(self) -> list[int]:
        """Periods that send — must be {1..2l-1} \\ {l} (2l-2 of them)."""
        return [i.period for i in self.sends()]

    def param_bytes_per_device(self) -> dict[int, float]:
        """Per-device resident chunk bytes of each FP layer (1-based)."""
        return {r.layer: r.param_bytes for r in self.runs(phase="fp")}

    def device_stream(self, device: int) -> tuple[Instruction, ...]:
        """The instructions that involve ``device``, in program order.

        This is the raw per-device *view* (the SPMD instruction filtered
        by membership in ``devices``); ``exec.analysis.expand_program``
        lowers it further into concrete per-device ops with resolved
        chunk indices and SEND/RECV endpoints.
        """
        if not 0 <= device < self.n_devices:
            raise ValueError(
                f"device {device} out of range 0..{self.n_devices - 1}")
        return tuple(i for i in self.instructions if device in i.devices)

    def device_streams(self) -> dict[int, tuple[Instruction, ...]]:
        """``device_stream`` for every device on the ring (idle devices
        map to an empty stream)."""
        return {d: self.device_stream(d) for d in range(self.n_devices)}

    def to_json(self) -> str:
        d = {
            "version": self.version,
            "layer_sizes": list(self.layer_sizes),
            "batch_size": self.batch_size,
            "strategy": self.strategy,
            "backend": self.backend,
            "n_devices": self.n_devices,
            "onoc_cores": list(self.onoc_cores),
            "degrees": list(self.degrees),
            "instructions": [
                {**dataclasses.asdict(ins), "opcode": ins.opcode.value,
                 "devices": list(ins.devices)}
                for ins in self.instructions
            ],
        }
        return json.dumps(d)

    @classmethod
    def from_json(cls, s: str) -> "PeriodProgram":
        """Load a serialized program.  v1 (no residency annotations) loads
        with zeroed ``param_bytes`` and no param FREEs — the validator skips the residency ledger for version < 2, and the
        sharded executor refuses such programs (recompile to upgrade)."""
        d = json.loads(s)
        version = d.get("version")
        if version not in (1, _JSON_VERSION):
            raise ValueError(f"unsupported program version {version}")
        instrs = tuple(
            Instruction(**{**i, "opcode": Opcode(i["opcode"]),
                           "devices": tuple(i["devices"]),
                           "sources": tuple(i.get("sources", ()))})
            for i in d["instructions"]
        )
        return cls(
            layer_sizes=tuple(d["layer_sizes"]),
            batch_size=int(d["batch_size"]),
            strategy=d["strategy"],
            backend=d["backend"],
            n_devices=int(d["n_devices"]),
            onoc_cores=tuple(d["onoc_cores"]),
            degrees=tuple(d["degrees"]),
            instructions=instrs,
            version=int(version),
        )


def snap_to_ring_degree(target: int, n_devices: int, layer_width: int) -> int:
    """Largest-feasibility snap of a planner degree onto an n-device ring.

    Feasible executor degrees divide both ``n_devices`` (so the all-gather
    chunk layout is uniform) and ``layer_width`` (the paper's even-mapping
    constraint, Eq. 4 with an exact ceiling).  Picks the feasible degree
    log-closest to ``target`` (ratio-symmetric, like planner._snap_degree),
    preferring the larger on ties.
    """
    cands = [d for d in range(1, n_devices + 1)
             if n_devices % d == 0 and layer_width % d == 0]
    return min(cands, key=lambda d: (abs(math.log(d / max(target, 1))), -d))


def compile_program(
    plan: FCNNPlan,
    workload: FCNNWorkload,
    cfg: ONoCConfig,
    n_devices: int,
    backend=None,
    validate: bool = True,
) -> PeriodProgram:
    """Lower a planner plan + its mapping into a PeriodProgram.

    ``plan.mapping`` supplies the paper-level windows (m_i* cores placed on
    the cfg.m ring by the chosen strategy) that price every instruction;
    the same strategy re-run on the n-device ring (``map_cores`` with
    m=n_devices) supplies the executor windows, so FM/RRM/ORRM remapping is
    *executed*, not just priced.

    Every emitted program is statically verified (``exec.validate``) before
    it is returned — schedule invariants plus the cost contract against the
    simulator — so a miscompiled or corrupted schedule is a hard error at
    compile time, never silent wrong numerics at execution time.  Pass
    ``validate=False`` only to construct intentionally-broken programs
    (validator tests).
    """
    backend = backend or ONoCBackend()
    l = workload.l
    if len(plan.periods) != l:
        raise ValueError(f"plan has {len(plan.periods)} periods, need {l}")
    if n_devices < 1:
        raise ValueError("n_devices >= 1")

    paper_mapping: Mapping = plan.mapping
    stars = tuple(p.onoc_cores for p in plan.periods)

    degrees = tuple(
        snap_to_ring_degree(p.degree, n_devices, workload.n(i))
        for i, p in enumerate(plan.periods, start=1)
    )
    exec_mapping = map_cores(
        workload, dataclasses.replace(cfg, m=n_devices),
        plan.strategy, list(degrees))

    instrs: list[Instruction] = []
    for i in range(1, 2 * l + 1):
        layer = period_layer(workload, i)
        phase = "fp" if i <= l else "bp"
        window = exec_mapping.window(i)
        d_i = len(window)
        m_star = len(paper_mapping.window(i))
        chunk_width = workload.n(layer) // d_i
        # per-device residency: the (n_{layer-1}+1) x chunk_width
        # weight+bias column chunk each window device holds (schema v2)
        chunk_bytes = float(
            (workload.n(layer - 1) + 1) * chunk_width * cfg.bytes_per_value)
        instrs.append(Instruction.RUN(
            period=i, layer=layer, phase=phase,
            activation=period_activation(layer, l),
            onoc_cores=m_star, degree=d_i,
            chunk_width=chunk_width, window=window,
            cost_s=compute_time(workload, cfg, i, m_star),
            param_bytes=chunk_bytes,
        ))
        if i == 2 * l:
            instrs.append(Instruction.FREE(period=i, released=window))
            instrs.append(Instruction.FREE(
                period=i, released=window, layer=layer,
                param_bytes=chunk_bytes))
            break
        if i != l:  # period l is the FP->BP turnaround: data stays in place
            tr = backend.transition_time(workload, cfg, i, paper_mapping)
            comm_s = tr.comm_s
            if backend.name == "onoc" and i == 1:
                comm_s = 0.0  # Eq. (6): g(m_1)=0, folded into Period-0 load
            instrs.append(Instruction.SEND(
                period=i, senders=window, cost_s=comm_s,
                bytes_per_sender=tr.bytes_per_sender, slots=tr.slots,
                hop_bytes=tr.hop_bytes,
            ))
            instrs.append(Instruction.RECV(
                period=i, receivers=exec_mapping.window(i + 1),
                sources=window))
        released = tuple(sorted(
            set(window) - set(exec_mapping.window(i + 1))))
        if released:
            instrs.append(Instruction.FREE(period=i, released=released))
        if phase == "bp":
            # the BP mirror period 2l-layer+1 is the chunk's last use
            # (Eq. 11): wgrad done, the layer's params are dead this epoch
            instrs.append(Instruction.FREE(
                period=i, released=window, layer=layer,
                param_bytes=chunk_bytes))

    program = PeriodProgram(
        layer_sizes=tuple(int(n) for n in workload.layer_sizes),
        batch_size=workload.batch_size,
        strategy=MappingStrategy(plan.strategy).value,
        backend=backend.name,
        n_devices=n_devices,
        onoc_cores=stars,
        degrees=degrees,
        instructions=tuple(instrs),
    )
    if validate:
        from repro_torch.exec.validate import validate_program
        validate_program(program, workload, cfg, backend=backend)
    return program


def compile_fcnn_program(
    workload: FCNNWorkload,
    cfg: ONoCConfig,
    n_devices: int,
    strategy: MappingStrategy | str = MappingStrategy.ORRM,
    backend=None,
) -> PeriodProgram:
    """Plan + compile in one call, on the divisor-complete ring mesh.

    ``ring_mesh_axes(n_devices)`` exposes every divisor of n_devices as a
    feasible planning degree, so the planner's snap and the compiler's
    ring snap agree.
    """
    plan = plan_fcnn(workload, cfg, ring_mesh_axes(n_devices),
                     strategy=strategy)
    return compile_program(plan, workload, cfg, n_devices, backend=backend)
