"""The port's FCNN in bf16 against the JAX reference.

The reference's FCNN trains in bf16: ``init(key, sizes, dtype)`` rounds
its fp32 draw once, its three Pallas kernels read bf16 operands,
accumulate in fp32 and round once, and every dtype follows the tensors.
The same numpy inputs go through the reference (``"ref"``, and
``"pallas_interpret"`` at small sizes) and through the port on the CPU,
where the kernel wrappers run their plain versions.  The cases, by the
dtypes of (x, w and b, dy and y): (a) bf16 data in a bf16 network, (b)
fp32 data in a bf16 network (fp32 activations against bf16 weights),
(d) bf16 data in an fp32 network; (c), fp32 throughout, is
tests/test_torch_kernels.py's and test_torch_fcnn.py's.

Tolerances, with what was measured here:
  * a bf16 output element-wise within one bf16 ulp of the reference's
    (2^-7·|ref|: both round an fp32 sum taken in another order, which can
    flip one rounding) plus 1e-4 of its largest |ref| (a sum that cancels
    to near 0 rounds at another scale), and norm-wise within 2^-7·‖ref‖;
    an fp32 output within 1e-5 of its largest (measured ≤ 8.4e-7);
  * NN1 (784-1000-500-10, batch 64): loss 1e-5 relative (measured
    1.9e-7), each gradient leaf 1e-3 of its norm (measured ≤ 2.9e-4);
  * five Adam steps: losses 1e-3 relative, leaves 1e-2 of their norms
    (the measured values are printed: run with ``-s``).
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.data import fcnn_classification_dataset as j_dataset
from repro.kernels import ops as jops
from repro.kernels import ref as JR
from repro.kernels.fcnn_layer import (
    fcnn_layer as j_fwd,
    fcnn_layer_dgrad as j_dgrad,
    fcnn_layer_wgrad as j_wgrad,
)
from repro.models import fcnn as jfcnn
from repro.optim import adam as j_adam
from repro.optim import linear_warmup_cosine as j_lwc
from repro_torch.kernels import cost, ops
from repro_torch.kernels.fcnn_layer import (
    fcnn_layer,
    fcnn_layer_dgrad,
    fcnn_layer_wgrad,
)
from repro_torch.launch import dryrun
from repro_torch.launch.train_fcnn import train_step
from repro_torch.models import fcnn
from repro_torch.optim import adam, linear_warmup_cosine

NN1 = [784, 1000, 500, 10]
BF16_ULP = 2.0 ** -7
BF16_SLACK = 1e-4
FP32_RTOL = 1e-5

# (x dtype, w and b dtype) of each case; dy and y take x's
CASES = {"a": ("bfloat16", "bfloat16"), "b": ("float32", "bfloat16"),
         "d": ("bfloat16", "float32")}
# tests/test_kernels.py's shapes (:25-30) and its ragged ones (:44-50), and
# an even width under 16 bytes of bf16
SHAPES = [(128, 128, 128), (256, 512, 128), (128, 1024, 256),
          (384, 256, 384), (32, 784, 1000), (32, 500, 10), (100, 64, 64),
          (8, 1024, 4000), (7, 13, 5), (3, 20, 10)]
# the reference in interpret mode at the smaller of them (~0.5 s a case)
INTERPRET_SHAPES = [(128, 128, 128), (32, 500, 10), (100, 64, 64),
                    (7, 13, 5), (3, 20, 10)]


def _jnp(a: np.ndarray, dtype: str):
    return jnp.asarray(a, getattr(jnp, dtype))


def _torch(a) -> torch.Tensor:
    """A numpy or jax array as a CPU tensor of its own dtype (bf16 exactly,
    through fp32)."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).removeprefix("torch.")


def _assert_matches(ours: torch.Tensor, theirs, what: str) -> None:
    """``ours`` in the reference's dtype and within the bars above."""
    ref = np.asarray(theirs)
    assert _dtype_name(ours) == ref.dtype.name, (what, ours.dtype, ref.dtype)
    o = ours.detach().double().numpy()
    r = ref.astype(np.float64)
    scale = np.abs(r).max()
    if ref.dtype.name == "float32":
        assert np.abs(o - r).max() <= FP32_RTOL * scale, what
        return
    bar = BF16_ULP * np.abs(r) + BF16_SLACK * scale
    assert (np.abs(o - r) <= bar).all(), (what, (np.abs(o - r) / bar).max())
    assert np.linalg.norm(o - r) <= BF16_ULP * np.linalg.norm(r), what


def _layer_inputs(m, k, n, case, seed=0, act="sigmoid"):
    """x, w, b, and dy and y of the layer (y the reference's forward), as
    jax arrays of the case's dtypes."""
    xd, wd = CASES[case]
    rng = np.random.default_rng(seed)
    x = _jnp(rng.normal(size=(m, k)), xd)
    w = _jnp(rng.normal(size=(k, n)) * k ** -0.5, wd)
    b = _jnp(rng.normal(size=(n,)) * 0.1, wd)
    y = JR.fcnn_layer_ref(x, w, b, act)
    dy = _jnp(rng.normal(size=(m, n)) * 0.01, xd)
    return x, w, b, dy, y


def _port_layer(x, w, b, dy, y, act):
    tx, tw, tb, tdy, ty = map(_torch, (x, w, b, dy, y))
    return (fcnn_layer(tx, tw, tb, act), fcnn_layer_dgrad(tdy, ty, tw, act),
            *fcnn_layer_wgrad(tx, tdy, ty, act))


@pytest.mark.parametrize("m,k,n", SHAPES)
@pytest.mark.parametrize("case", sorted(CASES))
def test_kernels_plain_match_reference_ref(m, k, n, case):
    """K1-K3 through the wrappers (plain versions on the CPU) against the
    reference's oracles: outputs in the reference's dtypes (y x's, dX
    dy's, dW x's, db dy's) and values."""
    act = "sigmoid" if n > 10 else "none"
    x, w, b, dy, y = _layer_inputs(m, k, n, case, act=act)
    outs = _port_layer(x, w, b, dy, y, act)
    wants = (JR.fcnn_layer_ref(x, w, b, act),
             JR.fcnn_layer_dgrad_ref(dy, y, w, act),
             *JR.fcnn_layer_wgrad_ref(x, dy, y, act))
    for what, o, r in zip(("y", "dx", "dw", "db"), outs, wants):
        _assert_matches(o, r, what)


@pytest.mark.parametrize("m,k,n", INTERPRET_SHAPES)
@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("act", ["sigmoid", "relu", "tanh"])
def test_kernels_plain_match_reference_pallas(m, k, n, case, act):
    """The same against the reference's Pallas kernels in interpret mode,
    whose output dtypes (``out_shape``) are the contract."""
    x, w, b, dy, y = _layer_inputs(m, k, n, case, seed=1, act=act)
    outs = _port_layer(x, w, b, dy, y, act)
    wants = (j_fwd(x, w, b, act, interpret=True),
             j_dgrad(dy, y, w, act, interpret=True),
             *j_wgrad(x, dy, y, act, interpret=True))
    for what, o, r in zip(("y", "dx", "dw", "db"), outs, wants):
        _assert_matches(o, r, what)


@pytest.mark.parametrize("x_dtype,dy_dtype", [("float32", "bfloat16"),
                                               ("bfloat16", "float32")])
def test_wgrad_mixed_groups_match_reference(x_dtype, dy_dtype):
    """K3 with x and (dy, y) in different dtypes, which the FCNN does not
    reach but the wrapper takes: dW in x's dtype, db in dy's."""
    rng = np.random.default_rng(4)
    x = _jnp(rng.normal(size=(32, 500)), x_dtype)
    y = _jnp(1 / (1 + np.exp(-rng.normal(size=(32, 10)))), dy_dtype)
    dy = _jnp(rng.normal(size=(32, 10)) * 0.01, dy_dtype)
    outs = fcnn_layer_wgrad(_torch(x), _torch(dy), _torch(y), "sigmoid")
    for wants in (JR.fcnn_layer_wgrad_ref(x, dy, y, "sigmoid"),
                  j_wgrad(x, dy, y, "sigmoid", interpret=True)):
        for what, o, r in zip(("dw", "db"), outs, wants):
            _assert_matches(o, r, what)


def test_wrappers_refuse_split_groups_and_other_dtypes():
    """b takes w's dtype and y dy's (the kernels read each group as one
    type); fp16 and fp64 are no operand's."""
    x, w = torch.zeros(4, 8, dtype=torch.bfloat16), torch.zeros(8, 10)
    with pytest.raises(TypeError, match="b must be torch.float32"):
        fcnn_layer(x, w, torch.zeros(10, dtype=torch.bfloat16))
    dy = torch.zeros(4, 10, dtype=torch.bfloat16)
    with pytest.raises(TypeError, match="y must be torch.bfloat16"):
        fcnn_layer_dgrad(dy, torch.zeros(4, 10), w)
    with pytest.raises(TypeError, match="y must be torch.bfloat16"):
        fcnn_layer_wgrad(x, dy, torch.zeros(4, 10))
    for dt in (torch.float16, torch.float64):
        with pytest.raises(TypeError, match="float32 or torch.bfloat16"):
            fcnn_layer(x.to(dt), w, torch.zeros(10))


@pytest.mark.parametrize("case", sorted(CASES))
def test_fused_backward_casts_like_the_reference_vjp(case):
    """``_FusedFCNN`` on the CPU against ``jax.grad`` of the reference's
    Pallas op (interpret mode): each gradient in its primal's dtype."""
    x, w, b, _, _ = _layer_inputs(7, 13, 5, case, seed=2)
    rng = np.random.default_rng(3)
    tgt = rng.normal(size=(7, 5)).astype(np.float32)

    def jloss(p):
        yy = jops.fcnn_layer(p["x"], p["w"], p["b"], "tanh",
                             force="pallas_interpret")
        return jnp.sum((yy.astype(jnp.float32) - tgt) ** 2)

    g_ref = jax.grad(jloss)({"x": x, "w": w, "b": b})
    leaves = {k: _torch(v).requires_grad_(True)
              for k, v in (("x", x), ("w", w), ("b", b))}
    yy = ops.fcnn_layer(leaves["x"], leaves["w"], leaves["b"], "tanh")
    ((yy.float() - torch.from_numpy(tgt)) ** 2).sum().backward()
    for name in ("x", "w", "b"):
        _assert_matches(leaves[name].grad, g_ref[name], name)


def _bf16_tree(sizes, seed=0):
    """The reference's bf16 parameters and the same as numpy leaves."""
    jp = jfcnn.init(jax.random.PRNGKey(seed), sizes, dtype=jnp.bfloat16)
    return jp, jax.tree.map(np.asarray, jp)


def test_params_from_numpy_keeps_bf16_exactly():
    jp, tree = _bf16_tree(NN1)
    params = fcnn.params_from_numpy(tree)
    for t in fcnn.parameters(params):
        assert t.dtype == torch.bfloat16 and t.requires_grad
    back = fcnn.params_to_numpy(params)
    for lo, lt in zip(back["layers"], tree["layers"]):
        for k in ("w", "b"):
            assert lo[k].dtype == lt[k].dtype == ml_dtypes.bfloat16
            np.testing.assert_array_equal(lo[k], lt[k])
    again = fcnn.params_from_numpy(back)
    for a, b in zip(fcnn.parameters(again), fcnn.parameters(params)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_carried_bf16_params_give_the_reference_logits():
    """The reference's bf16 NN1, carried across, with bf16 data: logits in
    bf16, as the reference's, and the same values."""
    jp, tree = _bf16_tree(NN1)
    x, _ = j_dataset(16, input_dim=NN1[0], seed=0)
    xb = jnp.asarray(x, jnp.bfloat16)
    want = jfcnn.forward(jp, xb, kernel_mode="ref")
    got = fcnn.forward(fcnn.params_from_numpy(tree), _torch(xb))
    assert want.dtype == jnp.bfloat16
    _assert_matches(got, want, "logits")


def test_init_rounds_the_fp32_draw_once():
    sizes = [64, 48, 32, 10]
    p32 = fcnn.init(sizes, torch.Generator().manual_seed(5), "cpu")
    p16 = fcnn.init(sizes, torch.Generator().manual_seed(5), "cpu",
                    dtype=torch.bfloat16)
    for a, b in zip(fcnn.parameters(p32), fcnn.parameters(p16)):
        assert b.dtype == torch.bfloat16 and b.requires_grad
        assert torch.equal(a.detach().to(torch.bfloat16), b.detach())


def _nn1_batch(case: str, n: int = 64):
    x, y = j_dataset(n, input_dim=NN1[0], seed=0)
    xj = jnp.asarray(x, jnp.bfloat16 if case == "a" else jnp.float32)
    return xj, y


@pytest.mark.parametrize("case", ["a", "b"])
@pytest.mark.parametrize("mode,j_mode", [(None, "pallas_interpret"),
                                         ("ref", "ref")])
def test_nn1_loss_grads_accuracy_match_reference(case, mode, j_mode):
    """NN1 in bf16 from the reference's parameters: the port's fused ops
    (plain versions on the CPU) against the reference's Pallas kernels in
    interpret mode, and the plain path against the reference's oracles."""
    jp, tree = _bf16_tree(NN1)
    xj, y = _nn1_batch(case)
    loss_ref, g_ref = jax.value_and_grad(
        lambda p: jfcnn.loss_fn(p, {"x": xj, "y": y}, kernel_mode=j_mode))(jp)
    params = fcnn.params_from_numpy(tree)
    tx, ty = _torch(xj), torch.from_numpy(y)
    logits = fcnn.forward(params, tx, kernel_mode=mode)
    assert _dtype_name(logits) == jfcnn.forward(
        jp, xj, kernel_mode=j_mode).dtype.name
    loss = fcnn.loss_fn(params, {"x": tx, "y": ty}, kernel_mode=mode)
    assert loss.dtype == torch.float32
    rel = abs(loss.item() - float(loss_ref)) / abs(float(loss_ref))
    grads = torch.autograd.grad(loss, fcnn.parameters(params))
    want = [np.asarray(lp[k], np.float32) for lp in g_ref["layers"]
            for k in ("w", "b")]
    dists = []
    for g, r in zip(grads, want):
        assert g.dtype == torch.bfloat16
        dists.append(float(np.linalg.norm(g.float().numpy() - r))
                     / max(float(np.linalg.norm(r)), 1e-30))
    print(f"NN1 case ({case}) {mode}/{j_mode}: loss rel {rel:.3e}, leaves "
          + " ".join(f"{d:.2e}" for d in dists))
    assert rel <= 1e-5
    assert max(dists) <= 1e-3
    assert float(fcnn.accuracy(params, tx, ty, kernel_mode=mode)) == float(
        jfcnn.accuracy(jp, xj, y, kernel_mode=j_mode))


@pytest.mark.parametrize("case", ["a", "b"])
@pytest.mark.parametrize("mode,j_mode", [(None, "pallas_interpret"),
                                         ("ref", "ref")])
def test_five_adam_steps_in_bf16_match_reference(case, mode, j_mode):
    """``train_fcnn.train_step`` with Adam on a bf16 network against the
    reference's loop (value_and_grad of loss_fn + adam), from the same
    bf16 parameters and batches."""
    sizes, batch, steps = [64, 48, 32, 10], 16, 5
    jp, tree = _bf16_tree(sizes, seed=1)
    x, y = j_dataset(batch * steps, input_dim=sizes[0], seed=2)
    dt = jnp.bfloat16 if case == "a" else jnp.float32
    j_opt = j_adam(j_lwc(3e-3, 2, steps))
    j_params, j_state = jp, j_opt.init(jp)
    grad_fn = jax.value_and_grad(
        lambda p, bt: jfcnn.loss_fn(p, bt, kernel_mode=j_mode))
    opt = adam(linear_warmup_cosine(3e-3, 2, steps))
    params = fcnn.params_from_numpy(tree)
    state, step_t = opt.init(params), torch.zeros(())
    j_losses, losses = [], []
    for i in range(steps):
        rows = slice(i * batch, (i + 1) * batch)
        xb = jnp.asarray(x[rows], dt)
        loss, g = grad_fn(j_params, {"x": xb, "y": y[rows]})
        j_params, j_state = j_opt.update(g, j_state, j_params, i)
        j_losses.append(float(loss))
        losses.append(train_step(params, opt, state,
                                 {"x": _torch(xb),
                                  "y": torch.from_numpy(y[rows])},
                                 step_t, mode).item())
    rel = [abs(a - b) / abs(b) for a, b in zip(losses, j_losses)]
    dists = []
    for lo, lt in zip(params["layers"], j_params["layers"]):
        for k in ("w", "b"):
            assert lo[k].dtype == torch.bfloat16
            r = np.asarray(lt[k], np.float32)
            dists.append(float(np.linalg.norm(
                lo[k].detach().float().numpy() - r)) / float(np.linalg.norm(r)))
    print(f"5 Adam steps, case ({case}) {mode}/{j_mode}: losses rel "
          + " ".join(f"{v:.2e}" for v in rel) + "; leaves "
          + " ".join(f"{d:.2e}" for d in dists))
    assert max(rel) <= 1e-3
    assert max(dists) <= 1e-2


def _nn1_meta_step(case: str, batch: int):
    """(setup, step) of one NN1 Adam step on the meta device."""
    opt = adam(1e-3)
    xdt = torch.bfloat16 if case == "a" else torch.float32

    def setup():
        params = fcnn.init(NN1, torch.Generator().manual_seed(0), "meta",
                           dtype=torch.bfloat16)
        return (params, opt.init(params),
                {"x": torch.empty((batch, NN1[0]), dtype=xdt, device="meta"),
                 "y": torch.empty((batch,), dtype=torch.int32,
                                  device="meta")},
                torch.zeros((), device="meta"))

    return setup, lambda a: train_step(a[0], opt, a[1], a[2], a[3])


@pytest.fixture
def calls(monkeypatch):
    """Calls of the five kernel wrappers through ``kernels.ops``."""
    counts = dict.fromkeys(ops.KERNELS, 0)

    def spy(fn, name):
        def wrapped(*a, **kw):
            counts[name] += 1
            return fn(*a, **kw)
        return wrapped

    for attr, name in (("_fcnn_fwd", "fcnn_layer"),
                       ("_fcnn_dgrad", "fcnn_layer_dgrad"),
                       ("_fcnn_wgrad", "fcnn_layer_wgrad"),
                       ("_xent_fwd", "softmax_xent_fwd"),
                       ("_xent_dlogits", "softmax_xent_dlogits")):
        monkeypatch.setattr(ops, attr, spy(getattr(ops, attr), name))
    return counts


@pytest.mark.parametrize("case", ["a", "b"])
def test_meta_step_counts_bf16_bytes_and_the_cpu_launches(case, calls):
    """A bf16 NN1 step on meta: each bf16 element counted at 2 bytes and
    each fp32 one at 4; the products at the bf16 rate as the tensor-core
    kernels run them (K1 once in (a), twice in (b) where x is split hi/lo;
    K2, and K3 in (a) where x is bf16, twice, dZ split hi/lo) and at fp32's
    where the CUDA-core kernels run them (K3 in (b); K2 at the output
    layer, N = 10 <= cost.TC_NARROW); the launches are the wrapper calls of
    the same step on the CPU."""
    batch = 8
    counter = dryrun.count(*_nn1_meta_step(case, batch))
    calls.update(dict.fromkeys(calls, 0))
    params = fcnn.init(NN1, torch.Generator().manual_seed(0), "cpu",
                       dtype=torch.bfloat16)
    opt = adam(1e-3)
    x = torch.randn(batch, NN1[0], generator=torch.Generator().manual_seed(1))
    train_step(params, opt, opt.init(params),
               {"x": x.to(torch.bfloat16 if case == "a" else torch.float32),
                "y": torch.zeros(batch, dtype=torch.int32)},
               torch.zeros(()))
    assert dict(counter.launches) == {k: v for k, v in calls.items() if v}
    assert calls["fcnn_layer"] == calls["fcnn_layer_wgrad"] == 3
    assert calls["fcnn_layer_dgrad"] == 2

    xs = 2 if case == "a" else 4    # activations' element size
    nbytes, flops = 0, {"bfloat16": 0, "float32": 0}
    for i, (k, n) in enumerate(zip(NN1[:-1], NN1[1:])):
        m = batch
        nbytes += xs * (m * k + m * n) + 2 * (k * n + n)          # K1
        nbytes += xs * (m * k + 2 * m * n) + xs * n + xs * k * n  # K3
        flops["bfloat16"] += (1 if case == "a" else 2) * 2 * m * k * n
        flops["float32"] += 2 * m * n + 3 * m * n
        if case == "a":                    # K3 on the tensor cores
            flops["bfloat16"] += 2 * 2 * m * k * n
        else:
            flops["float32"] += 2 * m * k * n
        if i:                                                      # K2
            nbytes += xs * (2 * m * n + m * k) + 2 * k * n
            if n <= cost.TC_NARROW:
                flops["float32"] += 2 * m * n * k
            else:
                flops["bfloat16"] += 2 * 2 * m * n * k
            flops["float32"] += 2 * m * n
    for c in (cost.xent_fwd(batch, 10, xs), cost.xent_dlogits(batch, 10, xs)):
        nbytes += c.nbytes
        flops["float32"] += c.flops["float32"]
    assert counter.kernel_bytes == nbytes
    assert dict(counter.kernel_flops) == {k: v for k, v in flops.items() if v}
