"""Executor: run a ``PeriodProgram`` on a ring of n logical devices held by
one process on one ``torch.device``, the PyTorch counterpart of the
reference's ``repro/exec/runtime.py`` (which runs the ring under
``shard_map`` on an n-device mesh).  The ring size is
``program.n_devices``.

Every step walks the program's FP periods, device by device of each
period's window.  Lowering of the instruction set:

  RUN (fp, layer i)   window device j computes column chunk j of layer i:
                      K1 (``kernels.fcnn_layer.fcnn_layer``) on the
                      (B, n_{i-1}) activation and its (n_{i-1}, n_i/d_i)
                      weight chunk.  Devices outside the window launch
                      nothing.  The reference has them compute the window
                      head's chunk and never select it, dead code to XLA
                      that would cost launches here: K1 runs sum(d_i) times
                      a step, not l*n (8 + 4 + 2 = 14 for NN1 ORRM on 8
                      devices).
  SEND + RECV (fp)    the d chunk outputs gathered in window order into the
                      (B, n_i) activation of the next period: chunk j comes
                      from device window[j].
  FREE                released devices stop contributing; in sharded
                      residency their slots of a layer hold zeros, which
                      get exactly zero gradients.
  RUN/SEND/RECV (bp)  the backward of the FP period, one autograd Function
                      (``_PeriodRun``): the cotangent is split back into
                      the d chunks (the Eq.-11 reduce-scatter: the senders
                      of period i are the receivers of period 2l-i+1); each
                      window device runs K2 on its chunk where the
                      activation needs a gradient (not at layer 1) and K3;
                      the d partial dX are summed in window order,
                      ((dX_0 + dX_1) + dX_2) + ..., and each chunk's dW/db
                      lands in its column block (replicated) or slot
                      (sharded) of one gradient of the leaf's shape.

The loss period (the FP->BP turnaround at period l) gathers the logit
chunks of the final window and evaluates ``ops.softmax_xent``: K4, and K5
in the backward.  The program schedules no transition there.

Two **residency** modes select the params layout:

  replicated   every device holds the full model: leaves ``w: (n_in,
               n_out)``, ``b: (n_out,)``; a RUN copies its chunk's columns
               of w once (the kernels take contiguous operands) and keeps
               the copy for K2.
  sharded      schema-v2 programs only.  Leaves are stacked,
               ``w: (n, n_in, width)``, ``b: (n, width)``: slot j holds
               chunk ``owner_chunk[j]`` if device j is in the layer's
               window, zeros otherwise (``shard_params``).  Only
               activations move between periods; off-window slots get
               exact-zero gradients, so element-wise optimizers keep them
               zero.  Per-device live parameter bytes follow the program's
               residency annotations (``exec.residency``).

Numerics: in both modes each chunk is computed from the same operands by
the same kernel, the partial dX are summed in the same order and the
chunk gradients are copied, never added, so the sharded run is
bit-identical to the replicated one: losses, gradients and element-wise
optimizer trajectories.  Against the single-device fused path
(``models.fcnn.loss_fn``) the executor differs only in the order of fp32
sums (a chunk's split-K plan is not the whole layer's, and dX is a sum of
d partial products).

``kernel_mode`` is fixed for the executor's life and changed only by
``degrade``: ``None`` runs the kernels (their plain versions on CPU
tensors, as the kernel wrappers do), ``"cuda"`` also refuses tensors off
the card, and ``"ref"`` runs the same schedule through the plain versions
of ``kernels/ref.py``.  Nothing falls back quietly.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.exec.program import PeriodProgram
from repro_torch.exec.residency import ResidencyTracker
from repro_torch.kernels import ops, ref
from repro_torch.kernels.fcnn_layer import (
    fcnn_layer,
    fcnn_layer_dgrad,
    fcnn_layer_wgrad,
)

Params = dict[str, Any]

__all__ = ["ProgramExecutor"]

# (forward, dgrad, wgrad) of a RUN: the kernel wrappers, or the plain
# versions for kernel_mode="ref"
_KERNEL_FNS = (fcnn_layer, fcnn_layer_dgrad, fcnn_layer_wgrad)
_PLAIN_FNS = (ref.fcnn_layer_ref, ref.fcnn_layer_dgrad_ref,
              ref.fcnn_layer_wgrad_ref)


@dataclasses.dataclass(frozen=True)
class _PeriodLayout:
    """Static per-FP-period geometry precomputed from RUN instructions."""

    layer: int                          # 1-based
    width: int                          # output columns per chunk (n_i/d_i)
    activation: str
    window: tuple[int, ...]             # device id of chunk j
    owner_chunk: tuple[int | None, ...]  # chunk of each device, None off-window


class _PeriodRun(torch.autograd.Function):
    """One FP period: the window's RUNs and the SEND/RECV gather.  Its
    backward is the period's BP RUN and the Eq.-11 reduce-scatter."""

    @staticmethod
    def forward(ctx, h, w, b, lay, sharded, fns):
        fwd = fns[0]
        ws, ys = [], []
        for j, dev in enumerate(lay.window):
            if sharded:
                w_c, b_c = w[dev], b[dev]
            else:
                cols = slice(j * lay.width, (j + 1) * lay.width)
                w_c, b_c = w[:, cols].contiguous(), b[cols]
            ws.append(w_c)
            ys.append(fwd(h, w_c, b_c, lay.activation))
        ctx.lay, ctx.sharded, ctx.fns = lay, sharded, fns
        ctx.save_for_backward(h, *ws, *ys)
        return torch.cat(ys, dim=1)

    @staticmethod
    def backward(ctx, dout):
        lay, d = ctx.lay, len(ctx.lay.window)
        _, dgrad, wgrad = ctx.fns
        h, *saved = ctx.saved_tensors
        ws, ys = saved[:d], saved[d:]
        # scatter: chunk j of the cotangent, each one contiguous
        dys = dout.reshape(dout.shape[0], d, lay.width).transpose(0, 1)
        dys = dys.contiguous()
        dh = gw = gb = None
        if ctx.needs_input_grad[0]:
            for j in range(d):   # the partial dX, summed in window order
                part = dgrad(dys[j], ys[j], ws[j], lay.activation)
                dh = part if dh is None else dh.add_(part)
        if ctx.needs_input_grad[1] or ctx.needs_input_grad[2]:
            dws, dbs = zip(*(wgrad(h, dys[j], ys[j], lay.activation)
                             for j in range(d)))
            if ctx.sharded:
                gw, gb = _slots(dws, lay), _slots(dbs, lay)
            else:
                gw, gb = torch.cat(dws, dim=1), torch.cat(dbs)
        return dh, gw, gb, None, None, None


class _ShardSlice(torch.autograd.Function):
    """One leaf from the full layout to the stacked one inside autograd:
    the forward is ``shard_params``'s slice and the backward its gather
    (column block j of the full gradient is slot window[j]'s)."""

    @staticmethod
    def forward(ctx, a, lay):
        ctx.lay = lay
        return _slots([a[..., c * lay.width:(c + 1) * lay.width]
                       for c in range(len(lay.window))], lay)

    @staticmethod
    def backward(ctx, g):
        return torch.cat([g[d] for d in ctx.lay.window], dim=-1), None


def _slots(chunks, lay: _PeriodLayout):
    """A layer's d chunks (tensors or numpy arrays) in the stacked (n, ...)
    layout: chunk ``owner_chunk[s]`` in slot s, exact zeros in the slots
    of devices outside the window."""
    stack, _, zeros_like = _array_ops(chunks[0])
    zero = zeros_like(chunks[0]) if None in lay.owner_chunk else None
    return stack([zero if c is None else chunks[c]
                  for c in lay.owner_chunk], 0)


def _array_ops(a):
    """(stack, concatenate, zeros_like) for a numpy array or a tensor."""
    if isinstance(a, np.ndarray):
        return np.stack, np.concatenate, np.zeros_like
    return torch.stack, torch.cat, torch.zeros_like


def _like(src, out):
    """``out`` with the gradient flag of ``src`` (tensors only)."""
    if isinstance(out, torch.Tensor):
        out.requires_grad_(src.requires_grad)
    return out


class ProgramExecutor:
    """Runs a compiled PeriodProgram on ``program.n_devices`` logical
    devices of one ``torch.device``.

    ``loss_fn(params, batch)`` has the signature and semantics of
    ``models.fcnn.loss_fn``: a differentiable mean cross-entropy, which
    ``torch.autograd.grad`` and the optimizers compose with as usual.
    ``device=None`` means the card (``device.resolve_device``).
    """

    def __init__(self, program: PeriodProgram,
                 device: str | torch.device | None = None,
                 kernel_mode: str | None = None,
                 residency: str = "replicated"):
        if residency not in ("replicated", "sharded"):
            raise ValueError(
                f"residency must be 'replicated' or 'sharded', got "
                f"{residency!r}")
        if residency == "sharded" and program.version < 2:
            raise ValueError(
                f"sharded residency needs a schema-v2 program with "
                f"residency annotations; this one is v{program.version} "
                f"— recompile with compile_program")
        self.program = program
        self.residency = residency
        self.kernel_mode = ops.resolve_mode(kernel_mode)
        self.device = resolve_device(device)
        # byte-level accounting of the layout this executor runs under
        self.tracker = ResidencyTracker(program, mode=residency)

        n = program.n_devices
        self._layout: list[_PeriodLayout] = []
        for run in program.runs(phase="fp"):
            owner: list[int | None] = [None] * n
            for j, dev in enumerate(run.devices):
                owner[dev] = j
            self._layout.append(_PeriodLayout(
                layer=run.layer, width=run.chunk_width,
                activation=run.activation, window=tuple(run.devices),
                owner_chunk=tuple(owner),
            ))

    @property
    def n_devices(self) -> int:
        return self.program.n_devices

    def degrade(self, mode: str | None = "ref") -> str | None:
        """Switch the kernel dispatch (after a kernel failure, typically to
        the plain versions) and return the previous mode.  The switch is
        explicit: nothing in ``ops`` falls back on its own."""
        previous = self.kernel_mode
        self.kernel_mode = ops.resolve_mode(mode)
        return previous

    # ------------------------------------------------------------------ run

    def loss_fn(self, params: Params, batch: Params) -> torch.Tensor:
        """Mean softmax cross-entropy of the program on ``batch``.

        ``params`` must be in the executor's residency layout: full
        (replicated mode) or stacked chunks from ``shard_params``
        (sharded mode)."""
        sharded = self.residency == "sharded"
        self._check_params(params, layout="sharded" if sharded else "full")
        x, y = batch["x"], batch["y"]
        ops.resolve_mode(self.kernel_mode, x, y)
        fns = _PLAIN_FNS if self.kernel_mode == "ref" else _KERNEL_FNS
        h = x
        for lay in self._layout:
            lp = params["layers"][lay.layer - 1]
            h = _PeriodRun.apply(h, lp["w"], lp["b"], lay, sharded, fns)
        return ops.softmax_xent(h, y, mode=self.kernel_mode)

    # ------------------------------------------------------- sharded layout

    def shard_params(self, params: Params) -> Params:
        """Full layout -> stacked residency layout, for tensors or numpy
        arrays alike (so the reference's trees convert directly).

        For layer i, device j's slot is column chunk ``owner_chunk[j]`` of
        (W_i, b_i) if j is in the layer's window, zeros otherwise."""
        self._check_params(params, layout="full")
        layers = []
        for lay in self._layout:
            lp = params["layers"][lay.layer - 1]
            out = {}
            for k in ("w", "b"):
                a = lp[k]
                with torch.no_grad():
                    out[k] = _like(a, _slots(
                        [a[..., c * lay.width:(c + 1) * lay.width]
                         for c in range(len(lay.window))], lay))
            layers.append(out)
        return {"layers": layers}

    def slice_params(self, params: Params) -> Params:
        """``shard_params`` inside autograd: full layout -> stacked layout,
        with the gather as the backward.  ``torch.autograd.grad`` of the
        sharded loss with respect to the full leaves then gives the
        full-layout gradients, bit-identical to the replicated executor's.
        This keeps a training state in the layout every ring shares (the
        degraded-mode runner's), at a copy of the model each way a step."""
        self._check_params(params, layout="full")
        return {"layers": [
            {k: _ShardSlice.apply(lp[k], lay) for k in ("w", "b")}
            for lay, lp in zip(self._layout, params["layers"])]}

    def gather_params(self, sparams: Params) -> Params:
        """Stacked residency layout -> full layout (chunk j of layer i
        comes from device window[j]'s slot), for tensors or numpy arrays.
        The only place the full matrices are put together: for evaluation
        and checkpoints, never inside the sharded loss."""
        self._check_params(sparams, layout="sharded")
        layers = []
        for lay in self._layout:
            sp = sparams["layers"][lay.layer - 1]
            out = {}
            for k, axis in (("w", 1), ("b", 0)):
                a = sp[k]
                _, concatenate, _ = _array_ops(a)
                with torch.no_grad():
                    out[k] = _like(a, concatenate(
                        [a[d] for d in lay.window], axis))
            layers.append(out)
        return {"layers": layers}

    def _check_params(self, params: Params, layout: str = "full") -> None:
        sizes = self.program.layer_sizes
        n = self.n_devices
        layers = params["layers"]
        if len(layers) != self.program.l:
            raise ValueError(
                f"program has {self.program.l} layers, params have "
                f"{len(layers)}")
        for i, (lp, lay) in enumerate(zip(layers, self._layout)):
            w_shape, b_shape = tuple(lp["w"].shape), tuple(lp["b"].shape)
            if layout == "full":
                want, want_b = (sizes[i], sizes[i + 1]), (sizes[i + 1],)
            else:
                if len(w_shape) == 3 and w_shape[0] != n:
                    raise ValueError(
                        f"program compiled for {n} devices, layer {i + 1}'s "
                        f"weights are stacked for {w_shape[0]}")
                want, want_b = (n, sizes[i], lay.width), (n, lay.width)
            if w_shape != want:
                raise ValueError(
                    f"layer {i + 1}: weight shape {w_shape} != {layout}-"
                    f"layout shape {want}")
            if b_shape != want_b:
                raise ValueError(
                    f"layer {i + 1}: bias shape {b_shape} != {layout}-"
                    f"layout shape {want_b}")
