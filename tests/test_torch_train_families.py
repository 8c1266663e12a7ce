"""The train paths of chip_smoke.py's phases 18d-18f (the MoE, the
encoder-decoder and the VLM at full width on the card) on the CPU at smoke
size, against the JAX reference.

  * granite-moe-1b-a400m-smoke's loss and every gradient leaf against the
    reference's ``loss_fn`` under ``jax.value_and_grad``, off-mesh, and its
    ``gradsync.accumulate_grads`` where there are 2 microbatches (the
    load-balance loss accumulated over them), in fp32 and bf16, with remat
    on and off.  fp32: the jitted reference, the loss within 1e-5 and each
    leaf within 1e-4 of its norm (``test_torch_lm_train.py``'s bars).
    bf16: the op-by-op reference (``jax.disable_jit``) with the port's
    expert choices replayed into its ``lax.top_k`` (bf16 roundings flip
    choices between the frameworks, and a flipped choice changes the
    function), at ``test_torch_lm_train_bf16.py``'s bars (2e-2, 5e-2); the
    reference's remat traces its layer once for every layer (a replayed
    choice there would be one constant for all) and changes no value of
    its function, so this oracle runs without it;
  * ``chip_smoke.ExpertChoices``, the record and replay keyed by (layer,
    forward or recompute, microbatch): under remat each recompute routes as
    its forward did, bit for bit; replaying a recorded run gives the free
    run's loss and gradients bit for bit; ``moe.top_k`` and ``moe._route``
    are restored after a raise, and a key never recorded raises;
  * ``chip_smoke.train_launches`` for the three families equal to the
    wrapper calls of a smoke train step, remat on and off;
  * ``chip_smoke.train_batch``: the keys, shapes and dtypes of the
    reference's ``input_specs`` for a train shape, for all six families;
  * the plain path's noise witness (``reference_chunked_attention``, the
    reference's chunked attention in plain PyTorch) computes the plain
    version's function, and its loss alone is the step's;
    ``chunked_plain_attention`` swaps it in and restores the plain version,
    also after a raise; the three new cells of phase 22.
"""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ShapeSpec as JShapeSpec
from repro.models import moe as JMOE
from repro.parallel import gradsync as JG
from repro_torch.configs import ShapeSpec, smoke_config
from repro_torch.kernels import ops, ref
from repro_torch.launch.steps import (
    TrainSettings,
    build_train_step,
    init_train_state,
)
from repro_torch.models import moe
from repro_torch.models.api import get_model
from test_torch_lm_train import (
    BF16_GRAD_TOL,
    BF16_LOSS_RTOL,
    FAMILY_ARCHS,
    GRAD_TOL,
    LOSS_RTOL,
    batch_np,
    leaf_errors,
    models,
    to_jax,
    to_torch,
)
from test_torch_lm_train_bf16 import _UpcastBf16Dots

_SPEC = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
SMOKE = importlib.util.module_from_spec(_SPEC)
_SPEC.loader.exec_module(SMOKE)

MOE = "granite-moe-1b-a400m"
SEQ = 32


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _split(nb: dict, n: int) -> dict:
    return {k: v.reshape((n, v.shape[0] // n) + v.shape[1:])
            for k, v in nb.items()}


class _Replay:
    """``jax`` for the reference MoE with ``lax.top_k`` replaying
    ``choices`` (one (G, T, k) array per call, in call order), the gates
    gathered from its own probabilities; it counts its calls (under remat
    the probabilities are tracers, so nothing of them is kept)."""

    def __init__(self, choices):
        self.left = list(choices)
        self.calls = 0
        outer = self

        class _Lax:
            def __getattr__(self, name):
                return getattr(jax.lax, name)

            @staticmethod
            def top_k(probs, k):
                outer.calls += 1
                idx = jnp.asarray(outer.left.pop(0), jnp.int32)
                return jnp.take_along_axis(probs, idx, axis=-1), idx

        self.lax = _Lax()

    def __getattr__(self, name):
        return getattr(jax, name)


def _reference(jm, jp, jb, n: int, eager: bool):
    """The reference's (loss, grads): ``value_and_grad`` of its loss_fn, or
    its ``accumulate_grads`` over the batch split in ``n``."""
    if n == 1:
        fn = jax.value_and_grad(jm.loss_fn)
    else:
        def fn(p, b):
            return JG.accumulate_grads(jm.loss_fn, p, _split(b, n))
    if eager:
        with jax.disable_jit():
            return fn(jp, jb)
    return jax.jit(fn)(jp, jb)


# -------------------------------------------- granite-moe against the reference

MOE_CASES = [(dtype, remat, n) for dtype in ("float32", "bfloat16")
             for remat in (False, True) for n in (1, 2)]


@pytest.mark.parametrize("dtype,remat,n_micro", MOE_CASES)
def test_moe_loss_and_grads_match_reference(dtype, remat, n_micro,
                                            monkeypatch):
    cfg, _, jm, tm, jp, tp = models(MOE, dtype, remat=remat)
    nb = batch_np(cfg, b=2, s=SEQ, seed=21)
    fp32 = dtype == "float32"
    choices = SMOKE.ExpertChoices()
    loss, grads = SMOKE.step_grads(tm, tp, to_torch(nb, dtype), n_micro,
                                   around=choices.record)
    if fp32:
        want_loss, want = _reference(jm, jp, to_jax(nb, dtype), n_micro,
                                     eager=False)
        replayed = ""
    else:
        # the reference's remat traces one layer for all (a replayed
        # choice would be one constant for every layer), and changes no
        # value of its function: its op-by-op oracle runs without
        _, _, jm, _, jp, _ = models(MOE, dtype, remat=False)
        monkeypatch.setattr(JMOE, "jnp", _UpcastBf16Dots())
        order = [choices.choices[(layer, "forward", i)]
                 for i in range(n_micro) for layer in range(cfg.n_layers)]
        replay = _Replay([e.numpy() for e in order])
        monkeypatch.setattr(JMOE, "jax", replay)
        want_loss, want = _reference(jm, jp, to_jax(nb, dtype), n_micro,
                                     eager=True)
        assert replay.left == [] and replay.calls == len(order)
        replayed = ", the port's expert choices replayed"
    errs = leaf_errors(grads, want)
    print(f"{MOE} {dtype} remat {remat} microbatches {n_micro}{replayed}: "
          f"loss {float(loss)} vs {float(want_loss)}; worst leaves "
          f"{errs[:3]}")
    assert loss.dtype == torch.float32 and loss.dim() == 0
    np.testing.assert_allclose(float(loss), float(want_loss),
                               rtol=LOSS_RTOL if fp32 else BF16_LOSS_RTOL)
    assert errs[0][0] <= (GRAD_TOL if fp32 else BF16_GRAD_TOL), errs[:3]
    n_re = sum(k[1] == "recompute" for k in choices.choices)
    assert n_re == (cfg.n_layers * n_micro if remat else 0)
    assert len(choices.choices) - n_re == cfg.n_layers * n_micro


# ------------------------------------------------ the keyed record and replay


def _moe_smoke(dtype="bfloat16", remat=True):
    cfg = smoke_config(MOE).replace(dtype=dtype, param_dtype=dtype,
                                    remat=remat)
    model = get_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    batch = SMOKE.train_batch(torch, "cpu", cfg, 2,
                              torch.Generator().manual_seed(1), SEQ)
    return cfg, model, params, batch


def _flat(grads):
    return [t for _, t in SMOKE._paths(grads)]


def test_recompute_routes_as_the_forward_did():
    """Under remat each layer's recompute (called last layer first, inside
    the backward) is keyed apart from its forward and, recorded, equals it
    bit for bit, for each of 2 microbatches."""
    cfg, model, params, batch = _moe_smoke()
    choices = SMOKE.ExpertChoices()
    SMOKE.step_grads(model, params, batch, 2, around=choices.record)
    keys = set(choices.choices)
    assert keys == {(layer, kind, n) for layer in range(cfg.n_layers)
                    for kind in ("forward", "recompute") for n in range(2)}
    assert choices.recompute_differs() == []
    assert [e.shape for e in choices.by_layer(n=1)] == [(1, SEQ, 2)] * 2
    # a recompute whose choices are changed is reported
    key = (1, "recompute", 0)
    choices.choices[key] = choices.choices[key].flip(-1)
    assert choices.recompute_differs() == [(1, 0)]


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("n_micro", [1, 2])
def test_replay_reproduces_the_free_run_bit_for_bit(remat, n_micro):
    """A run that replays the choices a recorded run made gives the free
    run's loss and gradients bit for bit, on the kernel path and on the
    plain path (``mode="ref"``)."""
    cfg, model, params, batch = _moe_smoke(remat=remat)
    choices = SMOKE.ExpertChoices()
    recorded = SMOKE.step_grads(model, params, batch, n_micro,
                                around=choices.record)
    for mode in (None, "ref"):
        free = SMOKE.step_grads(model, params, batch, n_micro, mode)
        replayed = SMOKE.step_grads(model, params, batch, n_micro, mode,
                                    around=choices.replay)
        for run in ((recorded, replayed) if mode is None else (replayed,)):
            assert torch.equal(run[0], free[0])
            assert all(torch.equal(a, b) for a, b in
                       zip(_flat(run[1]), _flat(free[1])))


def test_patches_are_restored_after_a_raise():
    """``moe.top_k`` and ``moe._route`` are the real ones again after a run
    that raises inside record() or replay(); a replayed key that was never
    recorded raises."""
    cfg, model, params, batch = _moe_smoke(remat=False)
    real = moe.top_k, moe._route
    choices = SMOKE.ExpertChoices()
    with pytest.raises(RuntimeError, match="inside"):
        with choices.record():
            assert moe.top_k is not real[0]
            model.loss_fn(params, {k: v[:1] for k, v in batch.items()})
            raise RuntimeError("inside")
    assert (moe.top_k, moe._route) == real
    assert len(choices.choices) == cfg.n_layers
    with pytest.raises(KeyError, match="no expert choices recorded"):
        with choices.replay():
            model.loss_fn(params, {k: v[:1] for k, v in batch.items()})
            model.loss_fn(params, {k: v[:1] for k, v in batch.items()})
    assert (moe.top_k, moe._route) == real


def test_phase_14_prefills_replay_by_layer():
    """Phase 14's ``moe_prefills`` through the keyed helper: one choice set
    a layer for each path, and on the CPU (the plain versions on both
    paths) the three prefills equal."""
    cfg, model, params, batch = _moe_smoke(remat=False)
    with torch.inference_mode():
        lk, lp, lpin, ck, cp = SMOKE.moe_prefills(
            torch, model, params, {"tokens": batch["tokens"][:1]}, SEQ + 4)
    assert len(ck) == len(cp) == cfg.n_layers
    assert torch.equal(lk, lp) and torch.equal(lk, lpin)
    assert SMOKE.flip_shares(ck, cp) == [0.0] * cfg.n_layers


# ------------------------------------------------------------- launches


def _count_wrappers(monkeypatch) -> dict:
    calls = dict.fromkeys(("softmax_xent_fwd", "softmax_xent_dlogits",
                           "flash_attention", "flash_attention_bwd"), 0)
    for attr, name in (("_xent_fwd", "softmax_xent_fwd"),
                       ("_xent_dlogits", "softmax_xent_dlogits"),
                       ("_flash_attention", "flash_attention"),
                       ("_flash_attention_bwd", "flash_attention_bwd")):
        real = getattr(ops, attr)

        def spy(*a, _real=real, _name=name, **kw):
            calls[_name] += 1
            return _real(*a, **kw)
        monkeypatch.setattr(ops, attr, spy)
    return calls


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("family", ["moe", "encdec", "vlm"])
def test_train_launches_match_a_smoke_step(family, remat, monkeypatch):
    """One smoke train step of each family, in its phase's batch and
    microbatches (the VLM one row, whose (3, B, S) positions do not split),
    calls K4, K5, K6 and K6's backward as ``chip_smoke.train_launches``
    counts them: the encoder-decoder's encoder self-attention, decoder
    self-attention and cross-attention each twice forward under remat."""
    arch = FAMILY_ARCHS[family] if family != "moe" else MOE
    cfg = smoke_config(arch).replace(remat=remat)
    n_micro, rows = (1, 1) if family == "vlm" else (2, 2)
    model = get_model(cfg)
    calls = _count_wrappers(monkeypatch)
    settings = TrainSettings(microbatches=n_micro)
    state = init_train_state(model, settings, torch.Generator().manual_seed(0),
                             "cpu")
    batch = SMOKE.train_batch(torch, "cpu", cfg, rows,
                              torch.Generator().manual_seed(2), 16)
    before = ops.launch_counts()
    _, metrics = build_train_step(model, settings)(state, batch)
    assert np.isfinite(float(metrics["loss"]))
    want = SMOKE.train_launches(cfg, n_micro, True)
    assert calls == {k: want[k] for k in calls}
    assert all(want[k] == 0 for k in want if k not in calls)
    per_layer = (cfg.n_encoder_layers + 2 * cfg.n_layers
                 if family == "encdec" else cfg.n_layers)
    assert want["flash_attention"] == (2 if remat else 1) * per_layer * n_micro
    assert ops.launch_counts() == before
    assert SMOKE.train_launches(cfg, n_micro, False) == dict.fromkeys(want, 0)


# ----------------------------------------------------------- train batches


@pytest.mark.parametrize("family", list(FAMILY_ARCHS))
def test_train_batch_matches_reference_input_specs(family):
    """``chip_smoke.train_batch`` has the reference's train ``input_specs``
    keys, shapes and dtypes (and the port's), in the config's dtype; the
    VLM's positions are an image grid's then its text's, past the grid."""
    from repro.configs import smoke_config as j_smoke_config
    from repro.models.api import get_model as j_get_model

    arch = FAMILY_ARCHS[family]
    for dtype in ("float32", "bfloat16"):
        cfg = smoke_config(arch).replace(dtype=dtype)
        jcfg = j_smoke_config(arch).replace(dtype=dtype)
        got = SMOKE.train_batch(torch, "cpu", cfg, 2,
                                torch.Generator().manual_seed(3), 128)
        want = j_get_model(jcfg).input_specs(
            JShapeSpec("train", 128, 2, "train"))
        port = get_model(cfg).input_specs(ShapeSpec("train", 128, 2, "train"))
        assert set(got) == set(want) == set(port)
        for key, spec in want.items():
            assert tuple(got[key].shape) == tuple(spec.shape), key
            assert str(got[key].dtype)[6:] == jnp.dtype(spec.dtype).name, key
            assert got[key].dtype == port[key].dtype, key
    if family == "vlm":     # 128 = a 1 x 32 x 2 grid, then 64 text tokens
        from repro_torch.models import vlm

        pos = got["positions"]
        assert torch.equal(pos[:, :, :64], vlm.make_image_positions(
            2, 1, 32, 2))
        assert torch.equal(pos[:, :, 64:], vlm.make_text_positions(2, 64)
                           + 32)
    else:                   # labels are the next tokens
        first = got["dec_tokens" if family == "encdec" else "tokens"]
        assert torch.equal(got["labels"][:, :-1], first[:, 1:])


# ------------------------------------------------------- witnesses, cells


@pytest.mark.parametrize("shape", [(1, 4, 2, 37, 16, 37, True, 0),
                                   (2, 4, 4, 20, 8, 33, False, 0),
                                   (1, 4, 1, 50, 16, 50, True, 7)])
def test_witness_attention_computes_the_same_function(shape):
    """The noise witness's attention (the reference's chunked attention in
    plain PyTorch, over one key chunk and over chunks of 16) gives the
    plain version's output and, under autograd, its gradients to fp32
    order in fp32; in bf16 its forward lies within phase 7's K6 bar of the
    plain version and differs from it somewhere, and its backward is the
    plain K6 backward on its own o and lse."""
    b, h, kv, s, d, sk, causal, window = shape
    gen = torch.Generator().manual_seed(4)
    q = torch.randn(b, h, s, d, generator=gen)
    k, v = (torch.randn(b, kv, sk, d, generator=gen) for _ in range(2))
    do = torch.randn(b, h, s, d, generator=gen)
    chunked = SMOKE.reference_chunked_attention()
    outs = []
    for fn in (ref.flash_attention_ref, chunked,
               SMOKE.reference_chunked_attention(16)):
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        o = fn(*leaves, causal, window)
        outs.append((o.detach(), *torch.autograd.grad(o, leaves, do)))
    for out in outs[1:]:
        for got, want in zip(out, outs[0]):
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    qb, kb, vb, dob = (t.bfloat16() for t in (q, k, v, do))
    want = ref.flash_attention_ref(qb, kb, vb, causal, window)
    for chunk in (None, 16):
        got = SMOKE.flash_rounded_attention_ref(qb, kb, vb, causal, window,
                                                chunk)
        ok, _, crit = SMOKE._close(
            torch, got, want, SMOKE.K6_FP32_RTOL,
            lambda: SMOKE.BF16_ULP * ref.flash_attention_ref(
                q, k, v.abs(), causal, window))
        assert ok, crit
        assert not torch.equal(got, want)
    leaves = [t.clone().requires_grad_(True) for t in (qb, kb, vb)]
    o = chunked(*leaves, causal, window)
    grads = torch.autograd.grad(o, leaves, dob)
    lse = torch.logsumexp(ref._scores(qb, kb, causal, window), -1).reshape(
        b, h, s)
    for a, w in zip(grads, ref.flash_attention_bwd_ref(
            qb, kb, vb, o.detach(), dob, lse, causal, window)):
        assert torch.equal(a, w)


def test_chunked_plain_attention_restores_after_a_raise():
    """Inside ``chunked_plain_attention`` the plain path attends over the
    reference's chunked attention at WITNESS_CHUNK keys (an fp32 smoke
    step's loss moves by at most fp32 order); the plain version is back
    after the block, also when the block raises."""
    cfg, model, params, batch = _moe_smoke("float32")
    plain = ref.flash_attention_ref
    choices = SMOKE.ExpertChoices()
    want = SMOKE.step_loss(torch, model, params, batch, 2, "ref",
                           choices.record)
    with SMOKE.chunked_plain_attention():
        assert ref.flash_attention_ref is not plain
        got = SMOKE.step_loss(torch, model, params, batch, 2, "ref",
                              choices.replay)
    assert ref.flash_attention_ref is plain
    assert abs(got - want) <= 1e-5 * abs(want)
    with pytest.raises(RuntimeError, match="inside"):
        with SMOKE.chunked_plain_attention(16):
            raise RuntimeError("inside")
    assert ref.flash_attention_ref is plain


def test_raised_step1_bars_are_twice_the_recorded_witness():
    """Only the cells whose plain path's own noise lies past phase 18's
    bars carry raised ones, each twice the largest witness recorded for
    the cell (ROADMAP F5), never below phase 18's."""
    bars = {ft.arch: (ft.loss_rtol, ft.leaf_rtol)
            for ft in SMOKE.TRAIN_FAMILIES}
    assert bars[MOE] == (SMOKE.TRAIN_LOSS_RTOL, SMOKE.TRAIN_LEAF_RTOL)
    assert bars[SMOKE.ENCDEC_ARCH] == (SMOKE.ENCDEC_TRAIN_LOSS_RTOL,
                                       SMOKE.ENCDEC_TRAIN_LEAF_RTOL)
    assert bars[SMOKE.VLM_ARCH] == (SMOKE.VLM_TRAIN_LOSS_RTOL,
                                    SMOKE.TRAIN_LEAF_RTOL)
    for loss, leaf in bars.values():
        assert loss >= SMOKE.TRAIN_LOSS_RTOL and leaf >= SMOKE.TRAIN_LEAF_RTOL


@pytest.mark.parametrize("n_micro", [1, 2])
def test_step_loss_is_step_grads_loss(n_micro):
    """The witness's loss alone equals ``step_grads``'s loss bit for bit,
    the MoE replaying its choices."""
    cfg, model, params, batch = _moe_smoke()
    choices = SMOKE.ExpertChoices()
    loss, _ = SMOKE.step_grads(model, params, batch, n_micro,
                               around=choices.record)
    for mode in (None, "ref"):
        want, _ = SMOKE.step_grads(model, params, batch, n_micro, mode,
                                   around=choices.replay)
        got = SMOKE.step_loss(torch, model, params, batch, n_micro, mode,
                              choices.replay)
        assert got == want.item()


def test_family_cells_are_phase_22_cells():
    """Phases 18d-18f's cells are in phase 22's (b), with their batch,
    microbatches and (the VLM) depth; the VLM's cut is 2 layers."""
    cells = {c.label: c for c in SMOKE.dry_cells()}
    for ft in SMOKE.TRAIN_FAMILIES:
        cell = cells[SMOKE.family_label(ft)]
        assert cell.part == "b" and cell.arch == ft.arch
        assert cell.shape.global_batch == ft.batch
        assert cell.shape.seq_len == SMOKE.TRAIN_SEQ
        assert cell.settings.microbatches == ft.microbatches
        assert SMOKE.cell_config(cell) == SMOKE.family_config(ft)
    assert SMOKE.family_config(SMOKE.TRAIN_FAMILIES[2]).n_layers == 2
