"""Happens-before analysis over per-device instruction streams.

Three checkers, all consuming ``expand.expand_program`` output (plus the
SPMD program for endpoint annotations):

  * ``check_endpoints``   — every RECV's chunk-ordered ``sources`` must
    name exactly the senders of the matching SEND, in chunk order: the
    executor materializes chunk j of a period's activation from window
    device j, so a permuted source list silently reads another device's
    chunk (wrong numerics, not an error, at run time).
  * ``check_happens_before`` — builds the happens-before digraph (program
    order within each stream; a cross edge SEND(s,p) -> RECV(r,p) for
    every sender s and receiver r, since the gather blocks on *all*
    contributions, a device's own included) and rejects cycles: a cycle
    is a communication deadlock — every device on it waits for an event
    scheduled after its own wait.
  * ``check_memory``      — abstract per-device memory state at chunk
    granularity: the activation chunk a device holds (defined by RUN,
    redefined by RECV, killed by window FREE) and the liveness of each
    layer's param chunk (resident from step start, killed by its param
    FREE).  Flags use-before-def, use-after-FREE and double-FREE — the
    per-device orderings the SPMD validator's set/ledger checks cannot
    see (they are order-insensitive within a period).

All rejections raise ``ProgramAnalysisError`` naming the offending
device, period and (where applicable) chunk or cycle.
"""

from __future__ import annotations

from repro_torch.exec.analysis.errors import ProgramAnalysisError
from repro_torch.exec.analysis.expand import DeviceOp
from repro_torch.exec.program import Opcode, PeriodProgram

__all__ = ["check_endpoints", "check_happens_before", "check_memory"]


def _fail(msg: str) -> None:
    raise ProgramAnalysisError(msg)


# --------------------------------------------------------------- endpoints

def check_endpoints(program: PeriodProgram) -> None:
    """RECV sources must match the senders of the same-period SEND, in
    chunk order (chunk j is computed and sent by sender window[j])."""
    sends = {i.period: i for i in program.instructions
             if i.opcode is Opcode.SEND}
    for ins in program.instructions:
        if ins.opcode is not Opcode.RECV:
            continue
        p = ins.period
        send = sends.get(p)
        if send is None:
            _fail(f"RECV period {p} on devices {list(ins.devices)}: no "
                  f"matching SEND — the receivers would wait forever "
                  f"(unmatched endpoint)")
        senders = tuple(send.devices)
        sources = tuple(ins.sources) or senders
        if len(sources) != len(senders):
            _fail(f"RECV period {p}: {len(sources)} sources "
                  f"{list(sources)} != {len(senders)} senders "
                  f"{list(senders)} of the period-{p} SEND (unmatched "
                  f"endpoint: chunk count disagrees)")
        if set(sources) != set(senders):
            _fail(f"RECV period {p}: sources {list(sources)} are not the "
                  f"senders {list(senders)} of the period-{p} SEND "
                  f"(unmatched endpoint)")
        for j, src in enumerate(sources):
            if src != senders[j]:
                _fail(f"RECV period {p} on devices {list(ins.devices)}: "
                      f"chunk {j} is declared to come from device {src}, "
                      f"but chunk {j} of the period-{p} activation is "
                      f"computed and sent by device {senders[j]} (swapped "
                      f"RECV source — the gather would read the wrong "
                      f"device's chunk)")


# --------------------------------------------------- happens-before graph

def check_happens_before(streams: dict[int, tuple[DeviceOp, ...]]) -> int:
    """Build the happens-before digraph and reject cycles (deadlocks).

    Nodes are (device, position-in-stream); edges are program order plus
    SEND -> RECV per transition period (a RECV waits on *every* sender's
    SEND — the gather needs all chunks, the receiver's own included).
    Returns the edge count (for analysis reports/benchmarks).
    """
    # node id = (device, pos); adjacency as index lists for the DFS
    nodes: list[DeviceOp] = []
    node_id: dict[tuple[int, int], int] = {}
    for d, ops in streams.items():
        for pos, op in enumerate(ops):
            node_id[(d, pos)] = len(nodes)
            nodes.append(op)

    adj: list[list[int]] = [[] for _ in nodes]
    n_edges = 0
    for d, ops in streams.items():
        for pos in range(len(ops) - 1):
            adj[node_id[(d, pos)]].append(node_id[(d, pos + 1)])
            n_edges += 1

    send_nodes: dict[int, list[int]] = {}
    recv_nodes: dict[int, list[int]] = {}
    for d, ops in streams.items():
        for pos, op in enumerate(ops):
            if op.op == "send":
                send_nodes.setdefault(op.period, []).append(
                    node_id[(d, pos)])
            elif op.op == "recv":
                recv_nodes.setdefault(op.period, []).append(
                    node_id[(d, pos)])
    for p, snodes in send_nodes.items():
        for s in snodes:
            for r in recv_nodes.get(p, ()):
                adj[s].append(r)
                n_edges += 1

    # iterative 3-color DFS; a back edge closes a deadlock cycle
    WHITE, GRAY, BLACK = 0, 1, 2
    color = [WHITE] * len(nodes)
    parent = [-1] * len(nodes)
    for root in range(len(nodes)):
        if color[root] != WHITE:
            continue
        stack = [(root, 0)]
        color[root] = GRAY
        while stack:
            u, ei = stack[-1]
            if ei < len(adj[u]):
                stack[-1] = (u, ei + 1)
                v = adj[u][ei]
                if color[v] == WHITE:
                    color[v] = GRAY
                    parent[v] = u
                    stack.append((v, 0))
                elif color[v] == GRAY:
                    cycle = [v]
                    w = u
                    while w != v and w != -1:
                        cycle.append(w)
                        w = parent[w]
                    cycle.append(v)
                    chain = " -> ".join(
                        nodes[n].describe() for n in reversed(cycle))
                    _fail(f"communication deadlock: cyclic happens-before "
                          f"wait {chain} — every device on the cycle "
                          f"blocks on an event scheduled after its own "
                          f"wait")
            else:
                color[u] = BLACK
                stack.pop()
    return n_edges


# ------------------------------------------------------- per-device memory

def check_memory(streams: dict[int, tuple[DeviceOp, ...]], l: int,
                 fp_windows: dict[int, tuple[int, ...]],
                 check_params: bool = True) -> None:
    """Walk each device's stream with an abstract chunk-level memory state.

    Activation state per device: ``None`` (nothing live / freed) or
    ``("out", p)`` (own period-p RUN output chunk) or ``("recv", p)``
    (period-p gathered activations).  Param state per device: one live
    bit per layer whose FP window contains the device (schema-v2 chunk
    residency; disabled for v1 programs via ``check_params=False``).
    """
    for d, ops in streams.items():
        act: tuple[str, int] | None = None
        freed_at: int | None = None
        param_live = {layer: True for layer, win in fp_windows.items()
                      if d in win}
        param_freed_at: dict[int, int] = {}

        def held(a=None, _d=d):
            a = a if a is not None else act
            if a is None:
                return ("nothing (freed at period "
                        f"{freed_at})" if freed_at is not None
                        else "nothing")
            tag, p = a
            return (f"its period-{p} RUN output chunk" if tag == "out"
                    else f"the period-{p} gathered activations")

        for op in ops:
            p = op.period
            if op.op == "run":
                if check_params:
                    if op.layer not in param_live:
                        _fail(f"use-before-def: RUN period {p} on device "
                              f"{d} needs layer {op.layer}'s param chunk, "
                              f"which was never resident on this device "
                              f"(FP window of layer {op.layer} does not "
                              f"contain it)")
                    if not param_live[op.layer]:
                        _fail(f"use-after-FREE: RUN period {p} on device "
                              f"{d} reads layer {op.layer}'s param chunk, "
                              f"freed by the param FREE at period "
                              f"{param_freed_at[op.layer]} (chunk "
                              f"granularity)")
                if p == 1:
                    pass  # consumes the input batch, defined at step start
                elif p == l + 1:
                    if act != ("out", l):
                        _fail(f"use-before-def: RUN period {p} on device "
                              f"{d} is the FP->BP turnaround and expects "
                              f"the period-{l} activation chunk in place "
                              f"(Eq. 11: equal windows, no transition), "
                              f"but the device holds {held()}")
                elif act != ("recv", p - 1):
                    _fail(f"use-before-def: RUN period {p} on device {d} "
                          f"consumes the period-{p - 1} gathered "
                          f"activations, but the device holds {held()}")
                act = ("out", p)
            elif op.op == "send":
                if act is None:
                    _fail(f"use-after-FREE: SEND at period {p} on device "
                          f"{d} reads the period-{p} activation chunk "
                          f"{op.chunk}, but it was freed by the window "
                          f"FREE at period {freed_at} earlier in the "
                          f"stream (FREE before last use)")
                if act != ("out", p):
                    _fail(f"use-before-def: SEND at period {p} on device "
                          f"{d} sends the period-{p} RUN output chunk "
                          f"{op.chunk}, but the device holds {held()}")
            elif op.op == "recv":
                act = ("recv", p)
            elif op.op == "free" and op.free_kind == "window":
                if act is None:
                    _fail(f"double FREE: window FREE at period {p} on "
                          f"device {d} releases an activation chunk "
                          f"already freed at period {freed_at}")
                act = None
                freed_at = p
            elif op.op == "free" and op.free_kind == "param":
                if not check_params:
                    continue
                if op.layer not in param_live:
                    _fail(f"param FREE at period {p} on device {d}: layer "
                          f"{op.layer}'s chunk was never resident on this "
                          f"device")
                if not param_live[op.layer]:
                    _fail(f"double FREE: param FREE at period {p} on "
                          f"device {d} releases layer {op.layer}'s chunk "
                          f"already freed at period "
                          f"{param_freed_at[op.layer]} (chunk granularity)")
                param_live[op.layer] = False
                param_freed_at[op.layer] = p

        if check_params:
            leaked = sorted(layer for layer, live in param_live.items()
                            if live)
            if leaked:
                _fail(f"residency leak: device {d} ends the epoch still "
                      f"holding the param chunk(s) of layer(s) {leaked} — "
                      f"no param FREE released them")
