"""Shape/dtype abstract interpretation of a period program.

Propagates the abstract activation value ``(batch, width)`` through the
FP periods and the cotangent ``(batch, width)`` back through the BP
periods, cross-checking at every RUN:

  * the consumed width matches the layer's weight-chunk geometry
    ``(n_{i-1}+1, chunk_width)`` and the gathered output width
    ``degree * chunk_width`` reconstructs exactly ``n_i``;
  * the activation annotation matches the model contract
    (``models.fcnn.period_activation``: hidden layers sigmoid, output
    layer none) and each BP RUN differentiates the same nonlinearity its
    FP mirror applied;
  * (schema v2) the ``param_bytes`` annotations imply one consistent
    element width across all layers — and exactly
    ``cfg.bytes_per_value`` when a config is given;
  * (with a workload) the program's ``batch_size`` and ``layer_sizes``
    are the workload's — a stale or corrupted program fails here with a
    precise ``ProgramAnalysisError`` instead of a shape error deep
    inside the executor.
"""

from __future__ import annotations

import math

from repro_torch.core.onoc_model import FCNNWorkload, ONoCConfig, period_layer
from repro_torch.exec.analysis.errors import ProgramAnalysisError
from repro_torch.exec.program import Opcode, PeriodProgram
from repro_torch.models.fcnn import period_activation

__all__ = ["check_shapes"]

_BPV_TOL = 1e-9


def _fail(msg: str) -> None:
    raise ProgramAnalysisError(msg)


def check_shapes(program: PeriodProgram,
                 workload: FCNNWorkload | None = None,
                 cfg: ONoCConfig | None = None) -> int:
    """Run the abstract interpreter; returns the number of RUNs checked."""
    sizes = program.layer_sizes
    l = program.l
    batch = program.batch_size
    if not isinstance(batch, int) or batch < 1:
        _fail(f"shape mismatch: program batch_size {batch!r} is not a "
              f"positive integer")

    if workload is not None:
        if tuple(int(n) for n in workload.layer_sizes) != sizes:
            _fail(f"shape mismatch: program layer_sizes {list(sizes)} != "
                  f"workload layer_sizes {list(workload.layer_sizes)}")
        if batch != workload.batch_size:
            _fail(f"shape mismatch: RUN period 1 consumes a "
                  f"(batch={batch}, n_0={sizes[0]}) activation block per "
                  f"program.batch_size, but the workload feeds batch "
                  f"{workload.batch_size} — program batch_size disagrees "
                  f"with the workload")

    runs = {i.period: i for i in program.instructions
            if i.opcode is Opcode.RUN}
    bytes_per_value: dict[int, float] = {}
    n_checked = 0

    # forward pass: abstract activation (batch, width)
    width = sizes[0]
    for p in range(1, l + 1):
        run = runs.get(p)
        if run is None:
            _fail(f"shape interpretation impossible: no RUN at period {p}")
        layer = run.layer
        if workload is not None and layer != period_layer(workload, p):
            _fail(f"shape mismatch: RUN period {p} computes layer {layer} "
                  f"!= paper period-layer {period_layer(workload, p)}")
        in_width = sizes[layer - 1]
        if in_width != width:
            _fail(f"shape mismatch: RUN period {p} multiplies a "
                  f"(batch={batch}, {width}) activation block by layer "
                  f"{layer}'s ({in_width}+1, {run.chunk_width}) weight "
                  f"chunk — inner dimensions {width} != {in_width}")
        out_width = (run.degree or 0) * (run.chunk_width or 0)
        if out_width != sizes[layer]:
            _fail(f"shape mismatch: RUN period {p} gathers degree x "
                  f"chunk_width = {run.degree} x {run.chunk_width} = "
                  f"{out_width} output columns != n_{layer} = "
                  f"{sizes[layer]}")
        want_act = period_activation(layer, l)
        if run.activation != want_act:
            _fail(f"activation mismatch: RUN period {p} (layer {layer}) "
                  f"is annotated {run.activation!r} but the model contract "
                  f"(period_activation) requires {want_act!r} — the "
                  f"executor would apply the wrong nonlinearity")
        if program.version >= 2 and run.param_bytes:
            bytes_per_value[layer] = run.param_bytes / (
                (in_width + 1) * run.chunk_width)
        width = sizes[layer]
        n_checked += 1

    # backward pass: abstract cotangent (batch, width), seeded by the loss
    cot = sizes[l]
    for p in range(l + 1, 2 * l + 1):
        run = runs.get(p)
        if run is None:
            _fail(f"shape interpretation impossible: no RUN at period {p}")
        layer = run.layer
        if workload is not None and layer != period_layer(workload, p):
            _fail(f"shape mismatch: RUN period {p} computes layer {layer} "
                  f"!= paper period-layer {period_layer(workload, p)}")
        if sizes[layer] != cot:
            _fail(f"shape mismatch: BP RUN period {p} (layer {layer}) "
                  f"consumes a (batch={batch}, {cot}) cotangent but layer "
                  f"{layer} produces n_{layer} = {sizes[layer]} outputs")
        fp = runs.get(layer)
        if fp is not None and run.activation != fp.activation:
            _fail(f"activation mismatch: BP RUN period {p} is annotated "
                  f"{run.activation!r} but its FP mirror (period {layer}) "
                  f"applied {fp.activation!r} — the backward pass would "
                  f"differentiate the wrong nonlinearity")
        cot = sizes[layer - 1]
        n_checked += 1

    # dtype: one element width across all layers, == cfg when given
    if bytes_per_value:
        widths = sorted(set(bytes_per_value.values()))
        if not math.isclose(widths[0], widths[-1], rel_tol=_BPV_TOL):
            _fail(f"dtype mismatch: param_bytes annotations imply "
                  f"inconsistent element widths across layers: "
                  f"{ {k: v for k, v in sorted(bytes_per_value.items())} }")
        if cfg is not None and not math.isclose(
                widths[0], cfg.bytes_per_value, rel_tol=_BPV_TOL):
            _fail(f"dtype mismatch: param_bytes annotations imply "
                  f"{widths[0]!r} bytes per value, but cfg.bytes_per_value "
                  f"= {cfg.bytes_per_value!r}")
    return n_checked
