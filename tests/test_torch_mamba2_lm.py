"""The port's attention-free Mamba2 LM (``models/mamba2.py``, family
``"ssm"``) against the JAX reference on mamba2-2.7b-smoke (2 layers,
d_model 64, 8 heads of 16, N = 16, chunk 8, tied embeddings), from the
reference's own parameters (``get_model(cfg).init(PRNGKey(0))`` as numpy,
through ``params_from_numpy``), the reference run outside any mesh.

fp32: layers within 1e-5, the model's logits and every cache leaf within
1e-4 (forward, prefill and decode steps), the served token streams equal
``JaxModelRunner``'s, and ``launch/serve`` serves the smoke model.

bf16 (``dtype`` and ``param_dtype`` bfloat16) is held to the reference
run op by op (``jax.disable_jit``) and jitted.  The port departs from the
reference in the SSD alone, by the four roundings D1-D4 that
tests/test_torch_zamba2_bf16.py names (y_diag rounded to bf16 before the
readout; the readout, the intra-chunk weights and the chunk-state decays
in fp32 where the reference's jnp path rounds them to bf16).  Measured on
this config, as shares of the largest value: forward logits 8.3e-3 of the
op-by-op reference and 7.2e-3 of the jitted one (which is itself 8.2e-3
from its own op-by-op run); over the prefill and 4 decode steps, logits
8.5e-3, the SSM state cache 4.9e-3, the conv cache 4.5e-3.  With the
reference's four roundings applied in PyTorch
(``_ssd_with_reference_roundings``, taken from that file) the port meets
the op-by-op reference to fp32 order (logits 9.1e-8, SSM state 3.4e-7,
the conv cache bit-identical), so nothing else differs.
"""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as j_smoke_config
from repro.models import mamba2 as JM
from repro.models.api import get_model as j_get_model
from repro.serve import traffic as j_traffic
from repro.serve.runner import JaxModelRunner
from repro.serve.scheduler import ServingEngine as JServingEngine
from repro.serve.scheduler import TickClock as JTickClock
from repro_torch.configs import smoke_config
from repro_torch.models import mamba2 as M
from repro_torch.models.api import get_model
from repro_torch.models.tree import layer, params_from_numpy, tree_map
from repro_torch.serve import (
    ServingEngine,
    TickClock,
    TorchModelRunner,
    make_traffic,
    scenario_preset,
    snap_prompt_buckets,
)

_SPEC = importlib.util.spec_from_file_location(
    "zamba2_bf16_twin", Path(__file__).with_name("test_torch_zamba2_bf16.py"))
_TWIN = importlib.util.module_from_spec(_SPEC)
_SPEC.loader.exec_module(_TWIN)

ARCH = "mamba2-2.7b"
LAYER_TOL = 1e-5
MODEL_TOL = 1e-4
FP32_ORDER = 1e-6           # fp32 results whose sums run in another order
# D1-D4, measured (docstring) up to 8.5e-3 of the largest value
BF16_RTOL = 2e-2
FLIP_SHARE = 5e-3
FLIP_RTOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_PARAMS: dict = {}


def _params(dtype="float32"):
    """(port cfg, reference cfg, reference params (jax), port params)."""
    if dtype not in _PARAMS:
        over = {"dtype": dtype, "param_dtype": dtype}
        cfg = smoke_config(ARCH).replace(**over)
        jcfg = j_smoke_config(ARCH).replace(**over)
        jp = jax.jit(j_get_model(jcfg).init)(jax.random.PRNGKey(0))
        host = jax.tree.map(np.asarray, jp)
        _PARAMS[dtype] = (cfg, jcfg, jp, params_from_numpy(host, "cpu"))
    return _PARAMS[dtype]


def _np32(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(a).astype(np.float32)


def _close(ours, theirs, tol):
    np.testing.assert_allclose(_np32(ours), _np32(theirs), rtol=tol, atol=tol)


def _rel(ours, theirs):
    g, w = _np32(ours), _np32(theirs)
    assert g.shape == w.shape
    return float(np.abs(g - w).max() / max(np.abs(w).max(), 1e-30))


def _same_but_flips(got, want):
    """Equal but for flips of a bf16 rounding on a few elements."""
    g, w = _np32(got), _np32(want)
    d = np.abs(g - w)
    mag = np.maximum(np.abs(g), np.abs(w))
    ulp = np.exp2(np.floor(np.log2(np.where(mag > 0, mag, 1.0))) - 7)
    bar = np.maximum(ulp, FLIP_RTOL * np.abs(w).max())
    assert np.all(d <= bar), float(np.max(d / bar))
    assert np.mean(d > 0) <= FLIP_SHARE, np.mean(d > 0)


def _tokens(shape, vocab, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, size=shape,
                                                dtype=np.int32)


def _jlayer(tree, i):
    return jax.tree.map(lambda a: a[i], tree)


# ---- fp32 ----------------------------------------------------------------

def test_params_from_numpy_keeps_the_pytree():
    cfg, _, jp, tp = _params()
    for path, leaf in jax.tree_util.tree_flatten_with_path(jp)[0]:
        t = tp
        for key in path:
            t = t[key.key]
        assert tuple(t.shape) == leaf.shape, path
        assert str(t.dtype).split(".")[-1] == str(leaf.dtype), path
    assert cfg.tie_embeddings and "unembed" not in tp
    assert tp["layers"]["in_proj"]["w"].shape[0] == cfg.n_layers
    # the port's own init draws the same tree
    own = get_model(cfg).init(torch.Generator().manual_seed(0), "cpu")
    assert jax.tree.map(lambda a: a.shape, jp) == tree_map(
        lambda t: tuple(t.shape), own)


def test_layer_matches_reference_prefill_and_decode():
    """One layer of the stack: the whole-sequence block with its final
    state and conv tail, then one decode step from them (1e-5)."""
    cfg, jcfg, jp, tp = _params()
    jl, tl = _jlayer(jp["layers"], 1), layer(tp["layers"], 1)
    rng = np.random.default_rng(3)
    hid = rng.normal(size=(2, 32, cfg.d_model)).astype(np.float32)
    one = rng.normal(size=(2, 1, cfg.d_model)).astype(np.float32)
    res_j, (st_j, tail_j) = jax.jit(
        lambda lp, h: JM.block_apply(lp, h, None, jcfg,
                                     return_states=True))(jl, jnp.asarray(hid))
    out_j, st2_j, tail2_j = jax.jit(
        lambda lp, h, s, t: JM.block_decode(lp, h, s, t, jcfg))(
        jl, jnp.asarray(one), st_j, tail_j)
    res, (st, tail) = M.block_apply(tl, torch.from_numpy(hid), cfg,
                                    return_states=True)
    out, st2, tail2 = M.block_decode(tl, torch.from_numpy(one), st, tail, cfg)
    for got, want in ((res, res_j), (st, st_j), (tail, tail_j), (out, out_j),
                      (st2, st2_j), (tail2, tail2_j)):
        _close(got, want, LAYER_TOL)


def test_forward_matches_reference():
    cfg, jcfg, jp, tp = _params()
    toks = _tokens((2, 32), cfg.vocab_size)
    want = jax.jit(j_get_model(jcfg).forward)(jp, {"tokens": jnp.asarray(toks)})
    got = get_model(cfg).forward(tp, {"tokens": torch.from_numpy(toks)})
    assert got.dtype == torch.float32 and got.shape == want.shape
    _close(got, want, MODEL_TOL)


def test_prefill_cache_and_decode_match_reference():
    """Prefill 16 tokens, then 6 decode steps: logits and every cache leaf
    (the fp32 SSM state, the conv tail, the lengths) after each call; the
    cache keeps its size whatever ``max_len`` says, as the reference's."""
    cfg, jcfg, jp, tp = _params()
    jm, tm = j_get_model(jcfg), get_model(cfg)
    toks = _tokens((2, 22), cfg.vocab_size, seed=4)
    lj, cj = jax.jit(jm.prefill, static_argnums=2)(
        jp, {"tokens": jnp.asarray(toks[:, :16])}, 18)
    lt, ct = tm.prefill(tp, {"tokens": torch.from_numpy(toks[:, :16])}, 18)
    _close(lt, lj, MODEL_TOL)
    assert set(ct) == set(cj) == set(tm.cache_axes())
    for key in cj:
        assert tuple(ct[key].shape) == cj[key].shape, key
        assert str(ct[key].dtype).split(".")[-1] == str(cj[key].dtype), key
        _close(ct[key], cj[key], MODEL_TOL)
    assert ({k: v.shape for k, v in tm.init_cache(2, 18, "cpu").items()}
            == {k: v.shape for k, v in tm.init_cache(2, 1000, "cpu").items()})
    j_decode = jax.jit(jm.decode_step)
    for step in range(6):
        tok = toks[:, 16 + step:17 + step]
        lj, cj = j_decode(jp, cj, {"tokens": jnp.asarray(tok)})
        ssm = ct["ssm"]
        lt, ct = tm.decode_step(tp, ct, {"tokens": torch.from_numpy(tok)})
        assert ct["ssm"] is ssm                    # updated in place
        _close(lt, lj, MODEL_TOL)
        for key in cj:
            _close(ct[key], cj[key], MODEL_TOL)
    assert ct["len"].tolist() == [22, 22]


def test_prefill_launches_the_ssd_once_a_layer(monkeypatch):
    """The prefill's SSD intra-chunk terms go through ``ops.ssd_chunk`` (K7
    on the card) once per layer, and never through flash attention."""
    from repro_torch.kernels import ops

    cfg, _, _, tp = _params()
    calls = {"ssd_chunk": 0, "flash_attention": 0}
    for name, fn in (("ssd_chunk", ops.ssd_chunk),
                     ("flash_attention", ops.flash_attention)):
        def counted(*a, _fn=fn, _name=name, **k):
            calls[_name] += 1
            return _fn(*a, **k)
        monkeypatch.setattr(ops, name, counted)
    get_model(cfg).prefill(tp, {"tokens": torch.zeros((1, 16),
                                                      dtype=torch.int64)}, 20)
    assert calls == {"ssd_chunk": cfg.n_layers, "flash_attention": 0}


def test_served_streams_equal_the_reference_end_to_end():
    """mamba2-2.7b-smoke through both serving engines, same trace, same
    numpy parameters, virtual time: identical token streams and reports."""
    cfg = smoke_config(ARCH)
    sc = scenario_preset("steady", n_requests=6)
    sc = sc.replace(prompt_buckets=snap_prompt_buckets(cfg, sc.prompt_buckets))
    assert all(b % cfg.ssm_chunk == 0 for b in sc.prompt_buckets)
    reference = JaxModelRunner(j_smoke_config(ARCH), n_slots=2,
                               max_len=sc.max_len, devices=jax.devices()[:1])
    j_trace = j_traffic.make_traffic(
        j_traffic.scenario_preset("steady", n_requests=6), 0)
    theirs = JServingEngine(reference, n_slots=2,
                            clock=JTickClock()).run(j_trace, sc)
    runner = TorchModelRunner(
        cfg, n_slots=2, max_len=sc.max_len, device="cpu",
        params=jax.tree.map(np.asarray, reference._host_params))
    trace = make_traffic(sc, seed=0)
    ours = ServingEngine(runner, n_slots=2, clock=TickClock()).run(trace, sc)
    assert set(ours.streams) == set(trace.rids)
    assert ours.streams == theirs.streams
    assert (ours.n_prefills, ours.n_decode_steps) == (theirs.n_prefills,
                                                      theirs.n_decode_steps)
    assert ours.slo.to_row() == theirs.slo.to_row()


def test_serve_cli_serves_the_ssm_smoke_model_on_cpu(capsys):
    from repro_torch.launch import serve as serve_cli

    assert serve_cli.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                           "--requests", "3", "--slots", "2"]) == 0
    out = capsys.readouterr().out
    assert "mamba2-2.7b-smoke" in out and "served 3/3 requests" in out


# ---- bf16 ----------------------------------------------------------------

@pytest.fixture
def reference_roundings(monkeypatch):
    """The port's model with the reference's SSD roundings (D1-D4 off)."""
    monkeypatch.setattr(M, "ssd_chunked", _TWIN._ssd_with_reference_roundings)


@pytest.fixture(scope="module")
def bf16_reference():
    """Op-by-op reference in bf16: forward logits of 32 tokens; prefill of
    16 tokens and 4 decode steps, (logits, cache) after each; and the
    jitted forward."""
    _, jcfg, jp, _ = _params("bfloat16")
    jm = j_get_model(jcfg)
    toks = _tokens((2, 32), 256, seed=5)
    batch = {"tokens": jnp.asarray(toks)}
    serving = []
    with jax.disable_jit():
        eager = jm.forward(jp, batch)
        logits, cache = jm.prefill(jp, {"tokens": jnp.asarray(toks[:, :16])},
                                   20)
        serving.append((logits, cache))
        for step in range(4):
            tok = jnp.asarray(toks[:, 16 + step:17 + step])
            logits, cache = jm.decode_step(jp, cache, {"tokens": tok})
            serving.append((logits, cache))
    return toks, eager, jax.jit(jm.forward)(jp, batch), serving


def _port_serving(toks):
    cfg, _, _, tp = _params("bfloat16")
    tm = get_model(cfg)
    logits, cache = tm.prefill(tp, {"tokens": torch.from_numpy(toks[:, :16])},
                               20)
    out = [(logits, {k: v.clone() for k, v in cache.items()})]
    for step in range(4):
        tok = torch.from_numpy(toks[:, 16 + step:17 + step])
        logits, cache = tm.decode_step(tp, cache, {"tokens": tok})
        out.append((logits, {k: v.clone() for k, v in cache.items()}))
    return out


def test_bf16_forward_matches_reference(bf16_reference):
    """Within D1-D4 of the op-by-op and the jitted reference (measured
    8.3e-3 and 7.2e-3 of the largest logit)."""
    toks, eager, jitted, _ = bf16_reference
    cfg, _, _, tp = _params("bfloat16")
    got = get_model(cfg).forward(tp, {"tokens": torch.from_numpy(toks)})
    assert got.dtype == torch.float32
    assert _rel(got, eager) <= BF16_RTOL
    assert _rel(got, jitted) <= BF16_RTOL


def test_bf16_forward_with_reference_roundings_matches_op_by_op(
        bf16_reference, reference_roundings):
    """With D1-D4 off the port meets the op-by-op reference to fp32 order:
    the departures are the whole gap."""
    toks, eager, _, _ = bf16_reference
    cfg, _, _, tp = _params("bfloat16")
    got = get_model(cfg).forward(tp, {"tokens": torch.from_numpy(toks)})
    assert _rel(got, eager) <= FP32_ORDER


def test_bf16_prefill_and_decode_match_reference(bf16_reference):
    """Logits and every cache leaf after the prefill and each of 4 decode
    steps within D1-D4 (measured up to 8.5e-3 of the largest value)."""
    toks, _, _, want = bf16_reference
    got = _port_serving(toks)
    for (lt, ct), (lj, cj) in zip(got, want):
        assert set(ct) == set(cj)
        assert _rel(lt, lj) <= BF16_RTOL
        for key in cj:
            assert str(ct[key].dtype).split(".")[-1] == str(cj[key].dtype)
            assert _rel(ct[key], cj[key]) <= BF16_RTOL, key
    assert got[-1][1]["len"].tolist() == [20, 20]


def test_bf16_prefill_and_decode_with_reference_roundings_match_op_by_op(
        bf16_reference, reference_roundings):
    """With D1-D4 off: logits and the fp32 SSM state to fp32 order, the
    bf16 conv cache equal but for single-ulp flips."""
    toks, _, _, want = bf16_reference
    for (lt, ct), (lj, cj) in zip(_port_serving(toks), want):
        assert _rel(lt, lj) <= FP32_ORDER
        assert _rel(ct["ssm"], cj["ssm"]) <= FP32_ORDER
        _same_but_flips(ct["conv"], cj["conv"])
        np.testing.assert_array_equal(ct["len"].numpy(), np.asarray(cj["len"]))
