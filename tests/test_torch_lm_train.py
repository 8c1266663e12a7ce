"""The port's LM train step against the JAX reference, on the smoke
configs of the six families (dense granite-3-2b, moe qwen2-moe-a2.7b,
ssm mamba2-2.7b, hybrid zamba2-1.2b, encdec seamless-m4t-large-v2, vlm
qwen2-vl-72b).

The reference's own train step fails on jax 0.9 (its mesh); the oracle is
each reference ``loss_fn`` under ``jax.value_and_grad`` off-mesh, where
its sharding constraints do nothing, and the reference's ``gradsync``,
``clip_by_global_norm`` and ``adamw`` called directly, which is the body
of its ``build_train_step``.  Inputs are the reference's init converted
to numpy and seeded numpy token ids, fed to both frameworks.

  * loss and every parameter's gradient, fp32: loss within rtol 1e-5,
    each leaf within 1e-4 of its norm (‖Δ‖/‖ref‖; measured ≤ 2.5e-6),
    and with a token mask for the encoder-decoder and the VLM (bf16 is in
    ``test_torch_lm_train_bf16.py``);
  * ``fused_unembed_ce`` (length a multiple of its chunk, and not), the
    remat policies (bit-identical to no remat on the CPU), the MoE router's
    load-balance term;
  * ``gradsync``: ``accumulate_grads`` with 2 and 4 microbatches in fp32
    and bf16, with and without an fp32 accumulator; int8 codes and scales
    exactly equal, ties at .5 included;
  * the optimizers (``sgd``, ``momentum`` plain and Nesterov, ``adamw``,
    ``constant``), one and five updates in fp32 and with bf16 parameters;
  * the 5-step train trajectory of granite-3-2b-smoke (fp32, (4, 32), the
    reference's ``test_lm_train_step_decreases_loss`` batch) through
    ``launch.steps.build_train_step`` in four settings: losses and
    gradient norms within rtol 1e-5, the loss falling;
  * K4/K5's host plans and chip_smoke.py's element-wise dlogits bar, which
    a K5 with a small error in exp or lse fails (CPU), and on the card
    (``gpu``) K4/K5 at LM shapes against their plain versions and the
    train step's kernel path (K4-K7 and the backwards of K6 and K7)
    against its plain path;
  * ``layers.gemm_f32_grads`` (the card's backward of a bf16 product
    with fp32 output, its GEMM emulated on the CPU) against JAX's
    transpose.
"""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as j_smoke_config
from repro.models import moe as JMOE
from repro.models.api import get_model as j_get_model
from repro.optim import optimizers as JO
from repro.optim import schedules as JS
from repro.parallel import gradsync as JG
from repro_torch import optim as O
from repro_torch.configs import smoke_config
from repro_torch.kernels import ops, ref
from repro_torch.kernels.softmax_xent import (
    fwd_plan,
    softmax_xent_dlogits,
    softmax_xent_fwd,
    vector_loads,
)
from repro_torch.launch.steps import (
    TrainSettings,
    build_train_step,
    init_train_state,
)
from repro_torch.models import layers as L
from repro_torch.models import moe
from repro_torch.models.api import get_model
from repro_torch.models.tree import params_from_numpy, tree_map
from repro_torch.parallel import gradsync

FAMILY_ARCHS = {"dense": "granite-3-2b", "moe": "qwen2-moe-a2.7b",
                "ssm": "mamba2-2.7b", "hybrid": "zamba2-1.2b",
                "encdec": "seamless-m4t-large-v2", "vlm": "qwen2-vl-72b"}
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4          # ‖Δ‖/‖ref‖ per leaf, fp32
BF16_LOSS_RTOL = 2e-2
BF16_GRAD_TOL = 5e-2     # the reference's bf16 kernel bar (test_kernels.py)
TRAJ_RTOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


_MODELS: dict = {}


def models(arch: str, dtype: str = "float32", **over):
    """(port cfg, reference cfg, reference model, port model, reference
    params (jax), port params) of a smoke config, the reference's init."""
    key = (arch, dtype, tuple(sorted(over.items())))
    if key not in _MODELS:
        over = {"dtype": dtype, "param_dtype": dtype, **over}
        cfg = smoke_config(arch).replace(**over)
        jcfg = j_smoke_config(arch).replace(**over)
        jm = j_get_model(jcfg)
        host = jax.tree.map(np.asarray, jax.jit(jm.init)(
            jax.random.PRNGKey(0)))
        _MODELS[key] = (cfg, jcfg, jm, get_model(cfg),
                        jax.tree.map(jnp.asarray, host),
                        params_from_numpy(host, "cpu"))
    return _MODELS[key]


def batch_np(cfg, b: int = 2, s: int = 32, seed: int = 0,
             mask: bool = False) -> dict:
    """A training batch of numpy arrays for ``cfg``'s family: next-token
    labels of seeded ids; frame or patch embeddings for the stub front
    ends (the VLM's at grid M-RoPE positions); a token mask with ~30% off."""
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, cfg.vocab_size, size=(b, s + 1), dtype=np.int32)
    if cfg.family == "encdec":
        out = {"enc_embeds": rng.normal(size=(b, 24, cfg.d_model)).astype(
                   np.float32),
               "dec_tokens": tok[:, :-1], "labels": tok[:, 1:]}
    elif cfg.family == "vlm":
        pos = np.broadcast_to(np.arange(s, dtype=np.int32), (3, b, s)).copy()
        pos[1] //= 4
        pos[2] %= 4
        out = {"embeds": rng.normal(size=(b, s, cfg.d_model)).astype(
                   np.float32),
               "positions": pos, "labels": tok[:, 1:]}
    else:
        out = {"tokens": tok[:, :-1], "labels": tok[:, 1:]}
    if mask:
        out["mask"] = rng.random((b, s)) < 0.7
    return out


def to_jax(nb: dict, dtype: str) -> dict:
    return {k: jnp.asarray(v, jnp.dtype(dtype)) if v.dtype == np.float32
            else jnp.asarray(v) for k, v in nb.items()}


def to_torch(nb: dict, dtype: str) -> dict:
    """Embeddings rounded to ``dtype`` as the reference's are."""
    return {k: torch.from_numpy(np.asarray(jnp.asarray(v, jnp.dtype(dtype)),
                                           np.float32)).to(getattr(torch,
                                                                   dtype))
            if v.dtype == np.float32 else torch.from_numpy(np.array(v))
            for k, v in nb.items()}


def leaf_errors(got: dict, want) -> list[tuple[float, str]]:
    """(‖got − want‖/‖want‖, path) of every leaf, worst first; a leaf whose
    reference gradient is zero must be zero."""
    out = []
    for path, w in jax.tree_util.tree_flatten_with_path(want)[0]:
        g = got
        for key in path:
            g = g[key.key]
        w = np.asarray(w, np.float64)
        g = g.detach().double().numpy()
        assert g.shape == w.shape, path
        n, d = np.linalg.norm(w), np.linalg.norm(g - w)
        out.append((d / n if n > 0 else (0.0 if d == 0 else np.inf),
                    jax.tree_util.keystr(path)))
    return sorted(out, reverse=True)


def reference_value_and_grad(jm, jp, jb):
    return jax.jit(jax.value_and_grad(jm.loss_fn))(jp, jb)


# ------------------------------------------------------------ fp32 parity

CASES = [(f, False) for f in FAMILY_ARCHS] + [("encdec", True),
                                               ("vlm", True)]


@pytest.mark.parametrize("family,masked", CASES)
def test_loss_and_grads_match_reference_fp32(family, masked):
    cfg, _, jm, tm, jp, tp = models(FAMILY_ARCHS[family])
    nb = batch_np(cfg, mask=masked)
    want_loss, want = reference_value_and_grad(jm, jp, to_jax(nb, "float32"))
    loss, grads = gradsync.value_and_grad(tm.loss_fn)(
        tp, to_torch(nb, "float32"))
    errs = leaf_errors(grads, want)
    print(f"{family} fp32{' masked' if masked else ''}: loss {float(loss)} "
          f"vs {float(want_loss)}, worst leaves {errs[:3]}")
    assert loss.dtype == torch.float32 and loss.dim() == 0
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=LOSS_RTOL)
    assert errs[0][0] <= GRAD_TOL, errs[:3]


def test_masked_loss_counts_only_masked_tokens():
    """The masked mean over the mask's tokens equals the plain mean over
    those tokens alone, and an all-zero mask gives 0 (max(Σ mask, 1))."""
    cfg, _, _, tm, _, tp = models(FAMILY_ARCHS["dense"])
    logits = torch.randn(2, 8, cfg.padded_vocab,
                         generator=torch.Generator().manual_seed(0))
    labels = torch.randint(0, cfg.vocab_size, (2, 8),
                           generator=torch.Generator().manual_seed(1))
    mask = torch.zeros(2, 8, dtype=torch.bool)
    mask[0, :5] = mask[1, 6:] = True
    got = L.cross_entropy_loss(logits, labels, mask)
    want = L.cross_entropy_loss(logits[mask][None], labels[mask][None])
    torch.testing.assert_close(got, want, rtol=1e-6, atol=0)
    zero = L.cross_entropy_loss(logits, labels, torch.zeros(2, 8))
    assert float(zero) == 0.0
    for m in (None, mask):
        x = logits.clone().requires_grad_(True)
        y = logits.clone().requires_grad_(True)
        L.cross_entropy_loss(x, labels, m).backward()
        L.cross_entropy_loss(y, labels, m, mode="ref").backward()
        torch.testing.assert_close(x.grad, y.grad, rtol=1e-5, atol=1e-8)


# ---------------------------------------------- fused CE, remat, MoE aux


@pytest.mark.parametrize("seq", [512, 40])
def test_fused_unembed_ce_matches_reference(seq):
    """``fused_ce=True``: at 512 tokens (one chunk of 512) the chunked,
    checkpointed path; at 40 the fallback to the plain loss."""
    cfg, _, jm, tm, jp, tp = models(FAMILY_ARCHS["dense"], fused_ce=True)
    nb = batch_np(cfg, b=1, s=seq, seed=3)
    want_loss, want = reference_value_and_grad(jm, jp, to_jax(nb, "float32"))
    loss, grads = gradsync.value_and_grad(tm.loss_fn)(
        tp, to_torch(nb, "float32"))
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=LOSS_RTOL)
    assert leaf_errors(grads, want)[0][0] <= GRAD_TOL
    h = torch.randn(2, 1024, cfg.d_model,
                    generator=torch.Generator().manual_seed(2))
    labels = torch.randint(0, cfg.vocab_size, (2, 1024),
                           generator=torch.Generator().manual_seed(3))
    emb = tp["embedding"]
    torch.testing.assert_close(
        L.fused_unembed_ce(emb, h, labels),
        L.cross_entropy_loss(L.unembed(emb, h), labels), rtol=1e-6, atol=0)


@pytest.mark.parametrize("policy", ["full", "dots"])
@pytest.mark.parametrize("family", list(FAMILY_ARCHS))
def test_remat_is_bit_identical_to_no_remat(family, policy):
    """Each family's layers under ``remat_wrap`` give the same loss and
    gradients, bit for bit, as without it (the recompute repeats the same
    CPU arithmetic)."""
    arch = FAMILY_ARCHS[family]
    cfg, *_, tp = models(arch)
    nb = to_torch(batch_np(cfg, seed=4), "float32")
    plain = gradsync.value_and_grad(get_model(cfg).loss_fn)(tp, nb)
    remat = get_model(cfg.replace(remat=True, remat_policy=policy))
    got = gradsync.value_and_grad(remat.loss_fn)(tp, nb)
    assert torch.equal(got[0], plain[0])
    for a, b in zip(jax.tree.leaves(tree_map(lambda t: t.numpy(), got[1])),
                    jax.tree.leaves(tree_map(lambda t: t.numpy(), plain[1]))):
        np.testing.assert_array_equal(a, b)


def test_remat_dots_saves_only_products_without_batch_dims():
    """The ``dots`` policy keeps mm/addmm outputs and recomputes the rest
    (a bmm has a batch dimension)."""
    from torch.utils.checkpoint import CheckpointPolicy

    aten = torch.ops.aten
    assert L._save_dots(None, aten.mm.default) == CheckpointPolicy.MUST_SAVE
    assert L._save_dots(None, aten.addmm.default) == CheckpointPolicy.MUST_SAVE
    for op in (aten.bmm.default, aten.mul.Tensor, aten.exp.default):
        assert L._save_dots(None, op) == CheckpointPolicy.PREFER_RECOMPUTE
    cfg = smoke_config("granite-3-2b")
    fn = lambda x: x  # noqa: E731
    assert L.remat_wrap(cfg, fn) is fn
    assert L.remat_wrap(cfg.replace(remat=True), fn) is not fn


@pytest.mark.parametrize("kind", ["plain", "ragged", "biased"])
def test_moe_aux_matches_reference(kind):
    """The router's load-balance term alone, and its gradient, against the
    reference's ``moe_mlp`` aux (fp32; padding tokens choose nothing)."""
    cfg, jcfg, _, _, jp, _ = models(FAMILY_ARCHS["moe"])
    rng = np.random.default_rng(5)
    p = jax.tree.map(lambda a: np.array(a[0]), jp["layers"]["moe"])
    b, s = (2, 23) if kind == "ragged" else (2, 32)
    x = rng.normal(size=(b, s, cfg.d_model)).astype(np.float32)
    if kind == "biased":
        p["router"][:, 0] += 0.3
    jaux, jgrad = jax.jit(jax.value_and_grad(
        lambda r: JMOE.moe_mlp({**p, "router": r}, jnp.asarray(x),
                               jcfg)[1]))(jnp.asarray(p["router"]))
    tp = params_from_numpy(p, "cpu")
    router = tp["router"].requires_grad_(True)
    _, aux = moe.moe_mlp({**tp, "router": router}, torch.from_numpy(x), cfg)
    aux.backward()
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-6)
    np.testing.assert_allclose(router.grad.numpy(), np.asarray(jgrad),
                               rtol=1e-4, atol=1e-7)


def test_moe_loss_adds_the_scaled_aux():
    """loss = cross-entropy + router_aux_coef · Σ aux / n_layers."""
    cfg, _, _, tm, _, tp = models(FAMILY_ARCHS["moe"])
    nb = to_torch(batch_np(cfg, seed=6), "float32")
    with_aux = tm.loss_fn(tp, nb)
    without = get_model(cfg.replace(router_aux_coef=0.0)).loss_fn(tp, nb)
    assert float(with_aux) > float(without)
    h = L.embed(tp["embedding"], nb["tokens"])
    pos = torch.arange(h.shape[1]).expand(h.shape[0], -1)
    total = 0.0
    for i in range(cfg.n_layers):
        h, a = moe.block_apply_aux(tree_map(lambda t: t[i], tp["layers"]),
                                   h, pos, cfg)
        total += float(a)
    np.testing.assert_allclose(float(with_aux) - float(without),
                               cfg.router_aux_coef * total / cfg.n_layers,
                               rtol=1e-4)


# ------------------------------------------------------------------ gradsync


@pytest.mark.parametrize("acc", [None, "float32"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n_micro", [2, 4])
def test_accumulate_grads_matches_reference(n_micro, dtype, acc):
    cfg, jcfg, jm, tm, jp, tp = models(FAMILY_ARCHS["dense"], dtype)
    nb = batch_np(cfg, b=4, s=16, seed=7)
    micro = {k: v.reshape((n_micro, 4 // n_micro) + v.shape[1:])
             for k, v in nb.items()}
    jacc = None if acc is None else jnp.dtype(acc)
    want_loss, want = jax.jit(lambda p, m: JG.accumulate_grads(
        jm.loss_fn, p, m, acc_dtype=jacc))(jp, to_jax(micro, dtype))
    loss, grads = gradsync.accumulate_grads(
        tm.loss_fn, tp, to_torch(micro, dtype),
        acc_dtype=None if acc is None else getattr(torch, acc))
    out_dtype = getattr(torch, acc or dtype)
    assert all(g.dtype == out_dtype for g in jax.tree.leaves(
        tree_map(lambda t: t, grads)))
    fp32 = dtype == "float32"
    errs = leaf_errors(grads, want)
    print(f"accumulate {n_micro} {dtype} acc {acc}: loss {float(loss)} vs "
          f"{float(want_loss)}, worst {errs[:2]}")
    np.testing.assert_allclose(float(loss), float(want_loss),
                               rtol=LOSS_RTOL if fp32 else BF16_LOSS_RTOL)
    assert errs[0][0] <= (GRAD_TOL if fp32 else BF16_GRAD_TOL)


def test_int8_codes_and_scales_equal_the_reference():
    """Codes and scales exactly, ties at .5 rounding half to even."""
    ties = np.array([127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 3.5, 126.5,
                     -126.5, 0.0], np.float32)
    rng = np.random.default_rng(8)
    cases = [ties, rng.normal(size=(64, 33)).astype(np.float32),
             (rng.normal(size=1000) * 1e-3).astype(np.float32),
             np.zeros(7, np.float32)]
    for g in cases:
        q, s = gradsync.quantize_int8(torch.from_numpy(g))
        jq, js = JG.quantize_int8(jnp.asarray(g))
        assert q.dtype == torch.int8
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        assert float(s) == float(js)
        np.testing.assert_array_equal(
            gradsync.dequantize_int8(q, s).numpy(),
            np.asarray(JG.dequantize_int8(jq, js)))
    q, _ = gradsync.quantize_int8(torch.from_numpy(ties))
    assert q.tolist() == [127, 0, 2, 2, 0, -2, -2, 4, 126, -126, 0]


def test_error_feedback_matches_reference_over_steps():
    """``compress_grads_ef`` with its fp32 residual over three rounds of
    the same fp32 and bf16 grads: dequantized grads and residuals equal
    the reference's bit for bit."""
    rng = np.random.default_rng(9)
    grads = {"a": rng.normal(size=(16, 8)).astype(np.float32),
             "b": {"c": (rng.normal(size=5) * 3).astype(np.float32)}}
    tg = tree_map(torch.from_numpy, grads)
    tg["b"]["c"] = tg["b"]["c"].bfloat16()
    jg = {"a": jnp.asarray(grads["a"]),
          "b": {"c": jnp.asarray(grads["b"]["c"], jnp.bfloat16)}}
    res = gradsync.init_residual(tg)
    jres = JG.init_residual(jg)
    for _ in range(3):
        deq, res = gradsync.compress_grads_ef(tg, res)
        jdeq, jres = JG.compress_grads_ef(jg, jres)
        for a, b in zip(jax.tree.leaves(tree_map(lambda t: t.numpy(), deq)),
                        jax.tree.leaves(jdeq)):
            np.testing.assert_array_equal(a, np.asarray(b))
        for a, b in zip(jax.tree.leaves(tree_map(lambda t: t.numpy(), res)),
                        jax.tree.leaves(jres)):
            assert a.dtype == np.float32
            np.testing.assert_array_equal(a, np.asarray(b))


# ------------------------------------------------------------- optimizers


def _opt_pair(name):
    lr_t, lr_j = O.constant(0.05), JS.constant(0.05)
    return {
        "sgd": (O.sgd(lr_t), JO.sgd(lr_j)),
        "momentum": (O.momentum(lr_t), JO.momentum(lr_j)),
        "nesterov": (O.momentum(lr_t, nesterov=True),
                     JO.momentum(lr_j, nesterov=True)),
        "adamw": (O.adamw(lr_t, weight_decay=0.1),
                  JO.adamw(lr_j, weight_decay=0.1)),
        "adamw_float_lr": (O.adamw(0.02), JO.adamw(0.02)),
    }[name]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ["sgd", "momentum", "nesterov", "adamw",
                                  "adamw_float_lr"])
def test_optimizers_match_reference(name, dtype):
    """One and five updates on a small tree (new grads each step); fp32
    parameters within 1e-6, bf16 ones within one bf16 ulp (both round the
    same fp32 update, computed in another order), moments fp32."""
    rng = np.random.default_rng(10)
    shapes = {"w": (8, 4), "n": {"b": (4,), "s": (3, 2, 2)}}
    p0 = tree_map(lambda s: rng.normal(size=s).astype(np.float32), shapes)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    opt, jopt = _opt_pair(name)
    # the port updates in place: its tensors own their memory
    tp = tree_map(lambda a: torch.from_numpy(
        np.array(jnp.asarray(a, jdt), np.float32)).to(tdt), p0)
    jp = tree_map(lambda a: jnp.asarray(a, jdt), p0)
    state, jstate = opt.init(tp), jopt.init(jp)
    rtol = 1e-6 if dtype == "float32" else 2.0 ** -8
    for step in range(5):
        g = tree_map(lambda s: rng.normal(size=s).astype(np.float32), shapes)
        tp, state = opt.update(tree_map(
            lambda a: torch.from_numpy(a.copy()).to(tdt), g), state, tp,
                               torch.tensor(step, dtype=torch.int32))
        jp, jstate = jopt.update(tree_map(lambda a: jnp.asarray(a, jdt), g),
                                 jstate, jp, jnp.int32(step))
        if step in (0, 4):
            for a, b in zip(jax.tree.leaves(tree_map(
                    lambda t: t.float().numpy(), tp)), jax.tree.leaves(jp)):
                np.testing.assert_allclose(a, np.asarray(b, np.float32),
                                           rtol=rtol, atol=1e-7)
            for a, b in zip(jax.tree.leaves(tree_map(lambda t: t.numpy(),
                                                     state)),
                            jax.tree.leaves(jstate)):
                assert a.dtype == np.float32
                np.testing.assert_allclose(a, np.asarray(b), rtol=1e-5,
                                           atol=1e-7)


def test_constant_schedule_matches_reference():
    for step in (0, 3, 1000):
        got = O.constant(3e-4)(torch.tensor(float(step)))
        assert got.dtype == torch.float32 and got.dim() == 0
        assert float(got) == float(JS.constant(3e-4)(step))


# ------------------------------------------------------ the 5-step trajectory

SETTINGS = {
    "plain": TrainSettings(learning_rate=1e-3),
    "microbatches2": TrainSettings(learning_rate=1e-3, microbatches=2),
    "int8": TrainSettings(learning_rate=1e-3, grad_compression="int8"),
    "clipped": TrainSettings(learning_rate=1e-3, grad_clip=0.05),
}


def oracle_trajectory(jm, jp, jb, settings: TrainSettings, steps: int):
    """The reference's ``build_train_step`` body, off-mesh and unjitted
    around jitted pieces: losses and gradient norms of ``steps`` steps on
    the batch ``jb``, or on ``jb[i]`` at step i where ``jb`` is a list."""
    opt = JO.adamw(settings.learning_rate,
                   weight_decay=settings.weight_decay)
    state = {"params": jp, "opt": opt.init(jp), "step": jnp.int32(0)}
    if settings.grad_compression == "int8":
        state["residual"] = JG.init_residual(jp)
    n = settings.microbatches
    if n > 1:
        def split(b):
            return jax.tree.map(lambda x: x.reshape((n, x.shape[0] // n)
                                                    + x.shape[1:]), b)
        grad_fn = jax.jit(lambda p, b: JG.accumulate_grads(jm.loss_fn, p,
                                                           split(b)))
    else:
        grad_fn = jax.jit(lambda p, b: jax.value_and_grad(jm.loss_fn)(p, b))
    batches = jb if isinstance(jb, list) else [jb] * steps
    out = []
    for i in range(steps):
        loss, grads = grad_fn(state["params"], batches[i])
        grads, gnorm = JO.clip_by_global_norm(grads, settings.grad_clip)
        if settings.grad_compression == "int8":
            grads, state["residual"] = JG.compress_grads_ef(
                grads, state["residual"])
        state["params"], state["opt"] = opt.update(
            grads, state["opt"], state["params"], state["step"])
        state["step"] = state["step"] + 1
        out.append((float(loss), float(gnorm)))
    return out


@pytest.mark.parametrize("setting", list(SETTINGS))
def test_train_trajectory_matches_reference(setting):
    settings = SETTINGS[setting]
    cfg, _, jm, tm, jp, tp = models(FAMILY_ARCHS["dense"])
    tok = np.random.default_rng(11).integers(0, cfg.vocab_size, size=(4, 32),
                                             dtype=np.int32)
    nb = {"tokens": tok, "labels": tok}
    want = oracle_trajectory(jm, jp, to_jax(nb, "float32"), settings, 5)
    state = init_train_state(tm, settings, torch.Generator().manual_seed(0),
                             "cpu")
    state["params"] = tree_map(lambda t: t.clone(), tp)
    step = build_train_step(tm, settings)
    got = []
    for _ in range(5):
        state, metrics = step(state, to_torch(nb, "float32"))
        assert metrics["loss"].dim() == metrics["grad_norm"].dim() == 0
        got.append((float(metrics["loss"]), float(metrics["grad_norm"])))
    print(f"{setting}: port {got}\n  reference {want}")
    np.testing.assert_allclose(np.array(got), np.array(want), rtol=TRAJ_RTOL)
    assert got[-1][0] < got[0][0]
    assert int(state["step"]) == 5 and state["step"].dtype == torch.int32
    if setting == "clipped":
        assert all(g > settings.grad_clip for _, g in got)
    if setting == "int8":
        assert any(float(r.abs().max()) > 0 for r in jax.tree.leaves(
            tree_map(lambda t: t, state["residual"])))


def test_init_train_state_holds_fp32_moments_and_residual():
    cfg = smoke_config("granite-3-2b").replace(dtype="bfloat16",
                                               param_dtype="bfloat16")
    state = init_train_state(get_model(cfg), SETTINGS["int8"],
                             torch.Generator().manual_seed(0), "cpu")
    assert set(state) == {"params", "opt", "step", "residual"}
    for tree in (state["opt"]["m"], state["opt"]["v"], state["residual"]):
        assert all(t.dtype == torch.float32 and not t.any()
                   for t in jax.tree.leaves(tree_map(lambda t: t, tree)))
    assert state["params"]["embedding"]["w"].dtype == torch.bfloat16
    with pytest.raises(ValueError, match="grad_compression"):
        build_train_step(get_model(cfg), TrainSettings(grad_compression="fp8"))


# ------------------------------------------------------- K4/K5 host plans


def test_xent_plans_choose_the_grid():
    """K4: the one-block lane kernel at the FCNN's shapes, else the rows
    kernel on a grid (a block a row from C = 4096, a warp a row below);
    both kernels move 16-byte vectors where C and the alignment allow (the
    CUDA launchers size the grids from these flags)."""
    assert fwd_plan(64, 10) == (0, False)
    assert fwd_plan(256, 16) == (0, False)
    assert fwd_plan(1, 10) == (0, False)
    assert fwd_plan(257, 10) == (1, False)
    assert fwd_plan(2048, 49408) == (8, True)
    assert fwd_plan(2048, 49408, 2) == (8, True)
    assert fwd_plan(4096, 32000) == (8, True)
    assert fwd_plan(37, 49408) == (8, True)
    assert fwd_plan(2048, 1000) == (1, True)
    assert fwd_plan(2048, 1004) == (1, True)
    assert fwd_plan(2048, 1004, 2) == (1, False)
    assert fwd_plan(37, 300, 4, aligned=False) == (1, False)
    assert vector_loads(49408) and vector_loads(49408, 2)
    assert vector_loads(1000) and not vector_loads(1004, 2)
    assert not vector_loads(10) and not vector_loads(301)
    assert not vector_loads(49408, aligned=False)


_SPEC = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
SMOKE = importlib.util.module_from_spec(_SPEC)
_SPEC.loader.exec_module(SMOKE)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dlogits_bar_catches_a_small_error_in_exp_or_lse(dtype):
    """chip_smoke.py's K5 bar at the LM loss's factor (g/B = 0.7/2048):
    the plain version passes against the same function taken another way
    (float64 softmax, rounded once), and fails with its lse moved or its
    exp scaled by a little more than the bar (1e-4 in fp32, 3% in bf16,
    where one bf16 ulp is 2^-7) or by 10%; rows whose factor is 0 must be
    0."""
    gen = torch.Generator().manual_seed(3)
    b, c = 16, 49408
    x = (torch.randn(b, c, generator=gen) * 3).to(dtype)
    lab = torch.randint(0, c, (b,), generator=gen, dtype=torch.int32)
    lse = ref.softmax_xent_fwd_ref(x, lab)[1]
    s = torch.full((b,), 0.7 / 2048)
    s[3] = 0.0
    want = ref.softmax_xent_dlogits_ref(x, lab, lse, s)
    onehot = torch.nn.functional.one_hot(lab.long(), c).double()
    other = ((torch.softmax(x.double(), -1) - onehot)
             * s.double()[:, None]).to(dtype)
    assert SMOKE.dlogits_error(other, want) <= 1
    assert SMOKE.dlogits_error(want, want) == 0
    small = 1e-4 if dtype == torch.float32 else 3e-2

    def wrong(lse_shift=0.0, exp_scale=1.0):
        p = torch.exp(x.float() - (lse + lse_shift)[:, None]) * exp_scale
        return ((p - onehot.float()) * s[:, None]).to(dtype)

    for bad in (wrong(lse_shift=small), wrong(exp_scale=1 + small),
                wrong(lse_shift=0.1), wrong(exp_scale=1.1)):
        assert SMOKE.dlogits_error(bad, want) > 1
    nonzero = want.clone()
    nonzero[3, 0] = 1e-30
    assert SMOKE.dlogits_error(nonzero, want) > 1


def _mm_fp32(a, b, out_dtype=None):
    """torch.mm of bf16 operands with fp32 output, as the card's GEMM: the
    products are exact in fp32, the sums fp32."""
    assert out_dtype == torch.float32
    return torch.mm(a.float(), b.float())


def test_gemm_f32_grads_match_the_fp32_transpose():
    """The card's backward of a bf16 product written in fp32 (the fp32
    cotangent split into bf16 hi + lo) against JAX's transpose, which
    multiplies the fp32 cotangent: every element within one bf16 ulp of
    it (2^-7·|ref| plus 2^-16 of the largest, for sums that cancel), where
    rounding the cotangent once to bf16 is not."""
    rng = np.random.default_rng(4)
    x = rng.normal(size=(64, 96)).astype(np.float32)
    w = (rng.normal(size=(96, 80)) / 10).astype(np.float32)
    g = (rng.normal(size=(64, 80)) * 1e-3).astype(np.float32)
    jx, jw = jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16)
    _, vjp = jax.vjp(lambda a, b: jnp.einsum(
        "md,df->mf", a, b, preferred_element_type=jnp.float32), jx, jw)
    want = [torch.from_numpy(np.asarray(t, np.float32))
            for t in vjp(jnp.asarray(g))]
    tx = torch.from_numpy(x).bfloat16()
    tw = torch.from_numpy(w).bfloat16()
    tg = torch.from_numpy(g)
    got = L.gemm_f32_grads(tx, tw, tg, _mm_fp32)
    once = (torch.mm(tg.bfloat16().float(), tw.float().t()),
            torch.mm(tx.float().t(), tg.bfloat16().float()))

    def worst(out, ref_):
        d = (out.double() - ref_.double()).abs()
        bar = 2.0 ** -7 * ref_.double().abs() + 2.0 ** -16 * ref_.abs().max()
        return (d / bar).max().item()

    for out, w_, one in zip(got, want, once):
        assert out.dtype == torch.bfloat16
        err, err_once = worst(out, w_), worst(one.bfloat16(), w_)
        print(f"split {err:.3f}, one rounding {err_once:.3f} of the bar")
        assert err <= 1 and err_once > 1


# ------------------------------------------------------------ on the card

LM_XENT_SHAPES = [(2048, 49408, torch.float32), (4096, 32000, torch.float32),
                  (37, 49408, torch.float32), (2048, 1000, torch.float32),
                  (2048, 49408, torch.bfloat16), (37, 301, torch.float32)]


@pytest.mark.gpu
@pytest.mark.parametrize("b,c,dtype", LM_XENT_SHAPES)
def test_xent_kernels_match_plain_at_lm_shapes_on_card(cuda, b, c, dtype):
    """K4 (nll, lse, mean within 1e-5; the mean of two runs bit-identical)
    and K5 (per row, from g, and an unaligned copy) within chip_smoke.py's
    element-wise bar (``dlogits_error``) at LM shapes."""
    gen = torch.Generator(device=cuda).manual_seed(12)
    x = (torch.randn(b, c, generator=gen, device=cuda) * 3).to(dtype)
    lab = torch.randint(0, c, (b,), generator=gen, device=cuda,
                        dtype=torch.int32)
    want = ref.softmax_xent_fwd_ref(x, lab)
    runs = [softmax_xent_fwd(x, lab) for _ in range(2)]
    g = torch.tensor(0.7, device=cuda)
    scale = torch.rand(b, generator=gen, device=cuda)
    odd = torch.empty(b * c + 1, device=cuda, dtype=dtype)[1:].view(b, c)
    odd.copy_(x)
    dls = [softmax_xent_dlogits(x, lab, want[1], scale),
           softmax_xent_dlogits(x, lab, want[1], g=g),
           softmax_xent_dlogits(odd, lab, want[1], g=g)]
    torch.cuda.synchronize()
    for o, w in zip(runs[0], want):
        torch.testing.assert_close(o, w, rtol=0, atol=1e-5)
    assert torch.equal(runs[0][2], runs[1][2])
    for dl, w in zip(dls, [ref.softmax_xent_dlogits_ref(x, lab, want[1], scale),
                           *[ref.softmax_xent_dlogits_ref(x, lab, want[1],
                                                          g=g)] * 2]):
        assert dl.dtype == dtype
        assert SMOKE.dlogits_error(dl, w) <= 1
    odd_fwd = softmax_xent_fwd(odd, lab)
    torch.cuda.synchronize()
    torch.testing.assert_close(odd_fwd[0], want[0], rtol=0, atol=1e-5)


# a bf16 smoke step's kernel path against its plain path: the losses (1e-4
# relative), the gradient norms and each gradient leaf of step 1 (phase
# 18's bars, TRAIN_GNORM_RTOL and TRAIN_LEAF_RTOL, for the same comparison
# at full width)
BF16_STEP_LOSS_RTOL = 1e-4


def _held_k6_backward(monkeypatch) -> list:
    """Hold every K6 backward launch to its plain version on the same
    inputs at phase 7's bars (``k6_bwd_close`` with the ``k6_bwd_noise``
    floor) and the lse it is handed to the plain one (``K6_LSE_TOL``);
    returns the list of (ok, note) it fills, one entry a gradient or lse."""
    bwd = ops._flash_attention_bwd
    held = []

    def checked(q, k, v, o, do, lse, causal, window):
        got = bwd(q, k, v, o, do, lse, causal, window)
        want = ref.flash_attention_bwd_ref(q, k, v, o, do, lse, causal,
                                           window)
        for g, w, noise in zip(got, want, SMOKE.k6_bwd_noise(q, k, v, do)):
            ok, _, note = SMOKE.k6_bwd_close(torch, g, w, noise)
            held.append((ok, f"{tuple(q.shape)} {g.dtype}: {note}"))
        plain = ref.flash_attention_lse_ref(q, k, v, causal, window)[1]
        err = ((lse - plain).abs() / (1 + plain.abs())).max().item()
        held.append((err <= SMOKE.K6_LSE_TOL, f"lse {err:.2e}"))
        return got

    monkeypatch.setattr(ops, "_flash_attention_bwd", checked)
    return held


def _held_k7_backward(monkeypatch) -> list:
    """Hold every K7 backward launch to its plain version on the same
    inputs at phase 7's bars (``k7_bwd_close`` with the ``k7_bwd_noise``
    floor); returns the list of (ok, note) it fills, one entry a launch."""
    bwd = ops._ssd_chunk_bwd
    held = []

    def checked(x, dt_a, b, c, dy, dstate, ddecay, groups):
        got = bwd(x, dt_a, b, c, dy, dstate, ddecay, groups)
        want = ref.ssd_chunk_bwd_ref(x, dt_a, b, c, dy, dstate, ddecay,
                                     groups)
        ok, _, note = SMOKE.k7_bwd_close(
            torch, got, want, SMOKE.k7_bwd_noise(x, b, c, dy, dstate, ddecay))
        held.append((ok, f"{tuple(x.shape)} {x.dtype}: {note}"))
        return got

    monkeypatch.setattr(ops, "_ssd_chunk_bwd", checked)
    return held


# the kernels whose launches a train step of each family makes on the
# kernel path (K4/K5 aside)
FAMILY_KERNELS = {"dense": ("flash_attention", "flash_attention_bwd"),
                  "moe": ("flash_attention", "flash_attention_bwd"),
                  "ssm": ("ssd_chunk", "ssd_chunk_bwd"),
                  "hybrid": ("flash_attention", "flash_attention_bwd",
                             "ssd_chunk", "ssd_chunk_bwd")}


def _two_steps_both_paths(cuda, family, dtype):
    """Two steps of ``family``'s smoke config in ``dtype`` on the card
    through the kernel path (``mode=None``) and the plain path
    (``mode="ref"``) from the same weights: {mode: [(loss, grad_norm)] a
    step}, and step 1's gradient leaves, kernel against plain, worst
    first.  Asserts the launches: K4 twice a step, the family's K6, K7 and
    their backwards (``FAMILY_KERNELS``) on the kernel path, none of them
    on the plain path."""
    cfg = smoke_config(FAMILY_ARCHS[family]).replace(
        dtype=dtype, param_dtype=dtype, remat=True)
    model = get_model(cfg)
    nb = batch_np(cfg, b=2, s=32, seed=13)
    batch = {k: v.to(cuda) for k, v in to_torch(nb, dtype).items()}
    settings = TrainSettings(microbatches=2)
    out = {}
    for mode in (None, "ref"):
        state = init_train_state(model, settings,
                                 torch.Generator(device=cuda).manual_seed(0),
                                 cuda)
        step = build_train_step(model, settings, mode=mode)
        before = ops.launch_counts()
        metrics = [step(state, batch)[1] for _ in range(2)]
        after = ops.launch_counts()
        out[mode] = [(float(m["loss"]), float(m["grad_norm"]))
                     for m in metrics]
        launched = after["softmax_xent_fwd"] - before["softmax_xent_fwd"]
        assert launched == (4 if mode is None else 0)
        for name in ("flash_attention", "flash_attention_bwd", "ssd_chunk",
                     "ssd_chunk_bwd"):
            n = after[name] - before[name]
            on = mode is None and name in FAMILY_KERNELS[family]
            assert n > 0 if on else n == 0, (name, n)
    params = init_train_state(model, settings,
                              torch.Generator(device=cuda).manual_seed(0),
                              cuda)["params"]
    leaves = SMOKE.grad_leaf_errors(torch, model, params, batch,
                                    settings.microbatches)
    for rows in out.values():
        assert rows[1][0] < rows[0][0]
    return out, leaves


@pytest.mark.gpu
@pytest.mark.parametrize("family", ["dense", "hybrid", "moe", "ssm"])
def test_train_step_kernel_path_matches_plain_on_card(cuda, family,
                                                      monkeypatch):
    """Two steps of a smoke config on the card, bf16, from the same
    weights, through K4/K5, K6 and K7 with their backwards, against the
    plain path (``ref.flash_attention_ref`` and ``ref.ssd_chunk_ref`` under
    autograd).  Every K6 and K7 backward launch of the kernel path is held
    to its plain version on the same inputs at phase 7's bars.  The step
    carries two roundings of the reference's flash-style attention that
    ``_sdpa``'s autodiff, the plain path, does not take: the forward
    rounds the unnormalised p for PV (``_flash_fwd_core``) and the
    backward rounds dS (``_sdpa_chunked_bwd``).
    Plain against plain on the card, the two move step 1's loss by
    2.5e-5-2.9e-5 and its gradient norm by 4.9e-4-5.9e-4, and the plain
    path with its attention's head dimension permuted (a change of fp32
    sum orders only) moves the dense step's gradient norm by 1.0e-4, so
    1e-5 is below the noise here; the step is held to phase 18's bars for
    the same comparison: both losses within 1e-4, both gradient norms
    within 1e-2 (AdamW's first update is lr·sign(g), so a gradient
    element near 0 that the two paths round to opposite signs moves a
    whole step), each leaf of step 1 within 5e-2 of its norm.  fp32, where
    no rounding separates the paths, keeps 1e-5 (the next test).  Both
    paths' losses fall; K6 and its backward launch on the kernel path,
    never on the plain path; so do K7 and its backward for the ssm and
    hybrid families."""
    k6, k7 = _held_k6_backward(monkeypatch), _held_k7_backward(monkeypatch)
    out, leaves = _two_steps_both_paths(cuda, family, "bfloat16")
    held = k6 + k7
    assert held and all(ok for ok, _ in held), [n for ok, n in held if not ok]
    np.testing.assert_allclose([r[0] for r in out[None]],
                               [r[0] for r in out["ref"]],
                               rtol=BF16_STEP_LOSS_RTOL)
    np.testing.assert_allclose([r[1] for r in out[None]],
                               [r[1] for r in out["ref"]],
                               rtol=SMOKE.TRAIN_GNORM_RTOL)
    assert leaves[0][1] <= SMOKE.TRAIN_LEAF_RTOL, leaves[:3]


@pytest.mark.gpu
@pytest.mark.parametrize("family", ["dense", "hybrid", "moe", "ssm"])
def test_train_step_kernel_path_matches_plain_fp32_on_card(cuda, family,
                                                           monkeypatch):
    """The same two steps in fp32, where K6, K7 and their backwards take
    no rounding the plain path does not: step 1's loss and gradient norm
    and step 2's loss within 1e-5 of the plain path's, step 2's gradient
    norm within 1e-2, each leaf of step 1 within 1e-4 of its norm (the
    fp32 bar of the families' parity tests), every K6 and K7 backward
    launch within phase 7's fp32 bar of its plain version."""
    k6, k7 = _held_k6_backward(monkeypatch), _held_k7_backward(monkeypatch)
    out, leaves = _two_steps_both_paths(cuda, family, "float32")
    held = k6 + k7
    assert held and all(ok for ok, _ in held), [n for ok, n in held if not ok]
    np.testing.assert_allclose(out[None][0], out["ref"][0], rtol=1e-5)
    np.testing.assert_allclose(out[None][1][0], out["ref"][1][0], rtol=1e-5)
    np.testing.assert_allclose(out[None][1][1], out["ref"][1][1], rtol=1e-2)
    assert leaves[0][1] <= GRAD_TOL, leaves[:3]
