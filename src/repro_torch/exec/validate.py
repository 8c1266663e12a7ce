"""Static verification of compiled period programs, copied from the
reference ``repro/exec/validate.py``.

A ``PeriodProgram`` is plain data that gets shipped to workers and
re-generated on every replan — a silently corrupted schedule (a RECV whose
SEND was dropped, a window pointing off the mesh, a FREE that releases a
chunk the next period still needs) would execute as wrong numerics or a
deadlocked collective, not as an error.  ``validate_program`` turns every
such corruption into a hard, precisely-worded ``ProgramValidationError``.

It runs at compile time: ``exec.program.compile_program`` validates every
program it emits (including the cost contract against the simulator).  In
the reference it also runs after every replan; the port's replan is still
to come.

Checks, in order:

  structure     exactly one RUN per period 1..2l, periods non-decreasing,
                RUN geometry consistent (chunk_width · degree = n_layer,
                window length = degree, BP windows mirror FP via Eq. 11);
  mesh          every device id of every instruction lies in
                [0, n_devices);
  degrees       every RUN degree divides both the device count (uniform
                all-gather chunk layout) and its layer width (the paper's
                even-mapping constraint, Eq. 4 exact);
  SEND/RECV     transitions exactly at {1..2l-1} \\ {l}; every RECV has a
                matching SEND and vice versa; senders are the current RUN
                window and receivers the next RUN window;
  FREE          (window FREEs, ``layer`` is None) only devices held at the
                period are freed, never a device the next period's window
                still needs (free-before-last-use), each window exit freed
                exactly once, and the final window freed wholesale at
                period 2l;
  residency     (schema v2) every RUN carries positive ``param_bytes``
                agreeing between a layer's FP run and its BP mirror; each
                layer's chunks are released by exactly one param FREE
                (``layer`` set), at exactly the BP mirror period 2l-i+1
                (Eq. 11 — the chunk's last use), over exactly the layer's
                window, for exactly the RUN's bytes; no RUN executes on
                non-resident (already freed) chunks; the byte ledger
                drains to exactly zero on every device;
  costs         (with workload + cfg) RUN costs equal the paper-level
                ``compute_time`` and SEND costs the backend transition
                time under the simulator's conventions — the program's
                compute_s/comm_s must equal ``simulate_epoch`` exactly.
"""

from __future__ import annotations

import math

from repro_torch.core.allocation import map_cores
from repro_torch.core.onoc_model import (
    FCNNWorkload,
    ONoCConfig,
    compute_time,
    period_layer,
)
from repro_torch.core.simulator import ONoCBackend, ENoCBackend

__all__ = ["ProgramValidationError", "validate_program"]
# ProgramAnalysisError (exec.analysis.errors) subclasses
# ProgramValidationError: importing either module gives one taxonomy.

_REL_TOL = 1e-9


class ProgramValidationError(ValueError):
    """A compiled program violates the schedule invariants."""


def _fail(msg: str) -> None:
    raise ProgramValidationError(msg)


def validate_program(
    program,
    workload: FCNNWorkload | None = None,
    cfg: ONoCConfig | None = None,
    backend=None,
    analyze: str | None = None,
) -> None:
    """Raise ``ProgramValidationError`` on the first violated invariant.

    Structural checks always run.  The cost contract is checked only when
    ``workload`` and ``cfg`` are provided (the compile-time path); pass the
    ``backend`` the program was compiled against to price SENDs with a
    non-default configuration.

    ``analyze`` optionally delegates to the per-device static analyzer
    (``exec.analysis.analyze_program``) after these SPMD-level checks:
    ``"fast"`` adds the happens-before/endpoint/memory checks, ``"full"``
    also the shape abstract interpreter.  Analyzer rejections raise
    ``ProgramAnalysisError``, a subclass of this module's
    ``ProgramValidationError`` — one error taxonomy for both layers.
    """
    if analyze is not None and analyze != "off":
        # the analyzer runs this validator as its own pre-pass, so the
        # delegation replaces (not duplicates) the checks below
        from repro_torch.exec.analysis import analyze_program
        analyze_program(program, workload, cfg, backend=backend,
                        level=analyze)
        return

    from repro_torch.exec.program import Opcode

    l = program.l
    n_dev = program.n_devices
    instrs = list(program.instructions)

    # ---------------------------------------------------------- structure
    runs = {i.period: i for i in instrs if i.opcode is Opcode.RUN}
    if sorted(runs) != list(range(1, 2 * l + 1)):
        missing = sorted(set(range(1, 2 * l + 1)) - set(runs))
        _fail(f"program must have one RUN per period 1..{2 * l}; "
              f"missing periods {missing}" if missing else
              f"program has RUNs at unexpected periods {sorted(runs)}")
    n_runs = sum(1 for i in instrs if i.opcode is Opcode.RUN)
    if n_runs != 2 * l:
        _fail(f"expected {2 * l} RUN instructions, found {n_runs}")
    periods = [i.period for i in instrs]
    if periods != sorted(periods):
        _fail(f"instructions out of period order: {periods}")

    for p, run in runs.items():
        layer = run.layer
        if workload is not None and layer != period_layer(workload, p):
            _fail(f"RUN period {p}: layer {layer} != paper period-layer "
                  f"{period_layer(workload, p)}")
        n_layer = program.layer_sizes[layer]
        d = run.degree
        if d != len(run.devices):
            _fail(f"RUN period {p}: degree {d} != window size "
                  f"{len(run.devices)}")
        if len(set(run.devices)) != len(run.devices):
            _fail(f"RUN period {p}: window has duplicate devices "
                  f"{list(run.devices)}")
        if d < 1 or n_dev % d != 0:
            _fail(f"RUN period {p}: degree {d} does not divide the device "
                  f"count {n_dev} (non-uniform all-gather chunk layout)")
        if n_layer % d != 0:
            _fail(f"RUN period {p}: degree {d} does not divide layer width "
                  f"{n_layer} (even-mapping constraint, Eq. 4)")
        if run.chunk_width != n_layer // d:
            _fail(f"RUN period {p}: chunk_width {run.chunk_width} != "
                  f"{n_layer} / {d}")
    # Eq. 11: BP windows mirror FP windows
    for i in range(1, l + 1):
        fp, bp = runs[i], runs[2 * l - i + 1]
        if fp.devices != bp.devices:
            _fail(f"BP period {2 * l - i + 1} window {list(bp.devices)} != "
                  f"FP period {i} window {list(fp.devices)} "
                  f"(data-locality constraint, Eq. 11)")

    # --------------------------------------------------------------- mesh
    for ins in instrs:
        bad = [d for d in ins.devices if not 0 <= d < n_dev]
        if bad:
            _fail(f"{ins.opcode.value.upper()} period {ins.period}: devices "
                  f"{bad} outside the {n_dev}-device mesh [0, {n_dev})")

    # ---------------------------------------------------------- SEND/RECV
    sends = {i.period: i for i in instrs if i.opcode is Opcode.SEND}
    recvs = {i.period: i for i in instrs if i.opcode is Opcode.RECV}
    want = set(range(1, 2 * l)) - {l}
    for p in sorted(recvs):
        if p not in sends:
            _fail(f"dangling RECV at period {p}: no matching SEND "
                  f"(receivers {list(recvs[p].devices)} would wait forever)")
    for p in sorted(sends):
        if p not in recvs:
            _fail(f"dangling SEND at period {p}: no matching RECV")
    if set(sends) != want:
        _fail(f"transition periods {sorted(sends)} != "
              f"{sorted(want)} (Eq. 6: 2l-2 transitions, none at the "
              f"period-l turnaround)")
    for p, s in sends.items():
        if tuple(s.devices) != tuple(runs[p].devices):
            _fail(f"SEND period {p}: senders {list(s.devices)} != period-{p} "
                  f"RUN window {list(runs[p].devices)}")
        if tuple(recvs[p].devices) != tuple(runs[p + 1].devices):
            _fail(f"RECV period {p}: receivers {list(recvs[p].devices)} != "
                  f"period-{p + 1} RUN window {list(runs[p + 1].devices)}")

    # ------------------------------------------------- FREE (window kind)
    frees: dict[int, list] = {}
    for ins in instrs:
        if ins.opcode is Opcode.FREE and ins.layer is None:
            frees.setdefault(ins.period, []).append(ins)
    for p, fs in frees.items():
        released = [d for f in fs for d in f.devices]
        if len(set(released)) != len(released):
            _fail(f"FREE period {p}: device(s) "
                  f"{sorted(set(d for d in released if released.count(d) > 1))}"
                  f" double-freed")
        held = set(runs[p].devices)
        ghost = sorted(set(released) - held)
        if ghost:
            _fail(f"FREE period {p}: devices {ghost} not in the period's "
                  f"window {sorted(held)} — cannot free what is not held")
        if p < 2 * l:
            needed = set(runs[p + 1].devices)
            early = sorted(set(released) & needed)
            if early:
                _fail(f"FREE period {p}: devices {early} are freed before "
                      f"last use — period {p + 1}'s window still needs "
                      f"their chunks")
    for p in range(1, 2 * l):
        leaving = set(runs[p].devices) - set(runs[p + 1].devices)
        released = {d for f in frees.get(p, []) for d in f.devices}
        leaked = sorted(leaving - released)
        if leaked:
            _fail(f"period {p}: devices {leaked} leave the active window "
                  f"but are never freed (residency leak)")
    final_released = {d for f in frees.get(2 * l, []) for d in f.devices}
    if final_released != set(runs[2 * l].devices):
        _fail(f"period {2 * l}: final FREE releases "
              f"{sorted(final_released)} != final window "
              f"{sorted(runs[2 * l].devices)}")

    # ---------------------------------------------- residency (schema v2)
    if program.version >= 2:
        param_frees = [i for i in instrs if i.opcode is Opcode.FREE
                       and i.layer is not None]
        for layer in range(1, l + 1):
            fp = runs[layer]
            bp = runs[2 * l - layer + 1]
            if fp.param_bytes <= 0.0:
                _fail(f"RUN period {layer}: param_bytes "
                      f"{fp.param_bytes!r} must be positive (schema v2 "
                      f"residency annotation)")
            if bp.param_bytes != fp.param_bytes:
                _fail(f"RUN period {2 * l - layer + 1}: BP param_bytes "
                      f"{bp.param_bytes!r} != FP mirror's "
                      f"{fp.param_bytes!r} (layer {layer} chunks are "
                      f"reused, not re-acquired)")
            lf = [f for f in param_frees if f.layer == layer]
            if len(lf) != 1:
                _fail(f"layer {layer}: expected exactly one param FREE, "
                      f"found {len(lf)} (chunk residency ledger)")
            f = lf[0]
            mirror = 2 * l - layer + 1
            if f.period != mirror:
                _fail(f"param FREE for layer {layer} at period {f.period} "
                      f"!= BP mirror period {mirror} (Eq. 11: the chunk's "
                      f"last use)")
            if set(f.devices) != set(fp.devices):
                _fail(f"param FREE for layer {layer}: devices "
                      f"{sorted(f.devices)} != layer window "
                      f"{sorted(fp.devices)}")
            if f.param_bytes != fp.param_bytes:
                _fail(f"param FREE for layer {layer}: releases "
                      f"{f.param_bytes!r} bytes != resident chunk bytes "
                      f"{fp.param_bytes!r} (ledger would not drain)")
        bad_layers = sorted({f.layer for f in param_frees}
                            - set(range(1, l + 1)))
        if bad_layers:
            _fail(f"param FREE for unknown layer(s) {bad_layers}")
        # ordered walk: a RUN after its layer's param FREE touches
        # non-resident chunks
        freed: set[int] = set()
        for ins in instrs:
            if ins.opcode is Opcode.RUN and ins.layer in freed:
                _fail(f"RUN period {ins.period}: layer {ins.layer} chunks "
                      f"are non-resident (freed by an earlier param FREE) "
                      f"— RUN operands must be resident")
            if ins.opcode is Opcode.FREE and ins.layer is not None:
                freed.add(ins.layer)
        # per-device ledger: acquired bytes must drain to exactly zero
        acquired = [0.0] * n_dev
        for layer in range(1, l + 1):
            for d in runs[layer].devices:
                acquired[d] += runs[layer].param_bytes
        for f in param_frees:
            for d in f.devices:
                acquired[d] -= f.param_bytes
        leaky = [d for d in range(n_dev) if acquired[d] != 0.0]
        if leaky:
            _fail(f"residency ledger does not drain to zero on device(s) "
                  f"{leaky}: residual bytes "
                  f"{[acquired[d] for d in leaky]}")
        if workload is not None and cfg is not None:
            for layer in range(1, l + 1):
                run = runs[layer]
                want = float((workload.n(layer - 1) + 1) * run.chunk_width
                             * cfg.bytes_per_value)
                if run.param_bytes != want:
                    _fail(f"RUN period {layer}: param_bytes "
                          f"{run.param_bytes!r} != chunk geometry "
                          f"(n_{layer - 1}+1) x chunk_width x "
                          f"bytes_per_value = {want!r}")

    # -------------------------------------------------------------- costs
    if workload is None or cfg is None:
        return
    if tuple(int(n) for n in workload.layer_sizes) != program.layer_sizes:
        _fail(f"workload layer sizes {list(workload.layer_sizes)} != "
              f"program layer sizes {list(program.layer_sizes)}")
    if backend is None:
        backend = ONoCBackend() if program.backend == "onoc" else ENoCBackend()
    if backend.name != program.backend:
        _fail(f"backend {backend.name!r} != program backend "
              f"{program.backend!r}")
    paper_mapping = map_cores(workload, cfg, program.strategy,
                              list(program.onoc_cores))
    for p, run in runs.items():
        m_star = len(paper_mapping.window(p))
        if run.onoc_cores != m_star:
            _fail(f"RUN period {p}: onoc_cores {run.onoc_cores} != paper "
                  f"window size {m_star}")
        want_cost = compute_time(workload, cfg, p, m_star)
        if not math.isclose(run.cost_s, want_cost, rel_tol=_REL_TOL,
                            abs_tol=0.0):
            _fail(f"RUN period {p}: cost {run.cost_s!r} != paper-level "
                  f"compute_time {want_cost!r} (simulator contract)")
    for p, s in sends.items():
        tr = backend.transition_time(workload, cfg, p, paper_mapping)
        want_cost = tr.comm_s
        if backend.name == "onoc" and p == 1:
            want_cost = 0.0  # Eq. (6): g(m_1) = 0
        if not math.isclose(s.cost_s, want_cost, rel_tol=_REL_TOL,
                            abs_tol=0.0):
            _fail(f"SEND period {p}: cost {s.cost_s!r} != backend "
                  f"transition_time {want_cost!r} (simulator contract)")
