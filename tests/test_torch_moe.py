"""The port's MoE transformer (``models/moe``) against the JAX reference
on the two MoE smoke configs (granite-moe-1b-a400m: 8 experts, top 2;
qwen2-moe-a2.7b: 6 experts, top 2, 2 shared, QKV bias), groups of 32
tokens.

``moe_mlp`` is held to the reference's on the same numpy inputs in fp32
(1e-5 of the largest value) and in bf16 against the reference run op by
op (``jax.disable_jit``: equal but for single-ulp flips where a sum runs
in another fp32 order) and jitted (3e-2 of the largest value; XLA fuses
and rounds elsewhere); measured, the bf16 outputs are bit-identical to
both.  XLA's CPU backend cannot run the reference's batched bf16 dots with
fp32 results (``DotThunk``: BF16 x BF16 = F32 unsupported), so for the
bf16 cases its ``einsum`` runs them on the operands upcast to fp32: bf16
products are exact in fp32 and the sums were fp32 already, so the
arithmetic is the reference's.  The cases are built to exercise the
routing rules:
  * a router biased to expert 0, so that every token picks it and
    capacity drops all but the first C of each group there;
  * n tokens not a multiple of the group size (padding routes nowhere);
  * shared experts (qwen2-moe), added after the routed ones;
  * two experts with identical router columns, whose equal probabilities
    go to the lower index, as ``jax.lax.top_k`` breaks ties.
Then ``forward``, ``prefill`` and ``decode_step`` of both models (fp32,
1e-4, as tests/test_torch_zamba2.py) and the served token streams
against ``JaxModelRunner``'s.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as j_smoke_config
from repro.models import moe as JMOE
from repro.models.api import get_model as j_get_model
from repro.serve import traffic as j_traffic
from repro.serve.runner import JaxModelRunner
from repro.serve.scheduler import ServingEngine as JServingEngine
from repro.serve.scheduler import TickClock as JTickClock
from repro_torch.configs import smoke_config
from repro_torch.models import moe
from repro_torch.models.api import get_model
from repro_torch.models.tree import layer, params_from_numpy, tree_map
from repro_torch.serve import (
    ServingEngine,
    TickClock,
    TorchModelRunner,
    make_traffic,
    scenario_preset,
)

MOE_ARCHS = ["granite-moe-1b-a400m", "qwen2-moe-a2.7b"]
LAYER_TOL = 1e-5
MODEL_TOL = 1e-4
BF16_JIT_RTOL = 3e-2
FLIP_SHARE = 5e-3
FLIP_RTOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_PARAMS: dict = {}


def _params(arch, dtype="float32"):
    """(port cfg, reference cfg, reference params (jax), port params)."""
    key = (arch, dtype)
    if key not in _PARAMS:
        over = {"dtype": dtype, "param_dtype": dtype}
        cfg = smoke_config(arch).replace(**over)
        jcfg = j_smoke_config(arch).replace(**over)
        host = jax.tree.map(np.asarray, jax.jit(j_get_model(jcfg).init)(
            jax.random.PRNGKey(0)))
        if "bq" in host["layers"]["attn"]:
            rng = np.random.default_rng(1)
            for name in ("bq", "bk", "bv"):
                b = host["layers"]["attn"][name]
                host["layers"]["attn"][name] = (
                    rng.normal(size=b.shape) * 0.5).astype(b.dtype)
        jp = jax.tree.map(jnp.asarray, host)
        _PARAMS[key] = (cfg, jcfg, jp, params_from_numpy(host, "cpu"))
    return _PARAMS[key]


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
    assert g.shape == w.shape
    d = np.abs(g - w)
    mag = np.maximum(np.abs(g), np.abs(w))
    ulp = np.exp2(np.floor(np.log2(np.where(mag > 0, mag, 1.0))) - 7)
    bar = np.maximum(ulp, FLIP_RTOL * np.abs(w).max())
    assert np.all(d <= bar), float(np.max(d / bar))
    assert np.mean(d > 0) <= FLIP_SHARE, np.mean(d > 0)


def _tokens(shape, vocab, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, size=shape,
                                                dtype=np.int32)


def _case(cfg, jp, kind, seed=0):
    """(numpy moe params of layer 0, x (B, S, d)) for one routing case."""
    rng = np.random.default_rng(seed)
    p = jax.tree.map(lambda a: np.array(a[0]), jp["layers"]["moe"])
    b, s = (2, 23) if kind == "ragged" else (2, 32)
    x = rng.normal(size=(b, s, cfg.d_model)).astype(np.float32)
    if kind == "biased":
        x += 1.0
        p["router"] = p["router"].copy()
        p["router"][:, 0] += 0.3
    elif kind == "tied":
        p["router"] = p["router"].copy()
        p["router"][:, 3] = p["router"][:, 1]
    return p, x


def _moe_pair(arch, kind, dtype):
    cfg, jcfg, jp, _ = _params(arch, dtype)
    p, x = _case(cfg, jp, kind)
    jdt = jnp.dtype(dtype)
    jparams = {k: (jnp.asarray(v) if k == "router" else
                   jax.tree.map(lambda a: jnp.asarray(a, jdt), v))
               for k, v in p.items()}
    jx = jnp.asarray(x, jdt)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    tx = torch.from_numpy(np.asarray(jx, np.float32)).to(getattr(torch, dtype))
    return cfg, jcfg, jparams, jx, tparams, tx


@pytest.mark.parametrize("kind", ["biased", "ragged", "tied", "plain"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_mlp_matches_reference_fp32(arch, kind):
    cfg, jcfg, jparams, jx, tparams, tx = _moe_pair(arch, kind, "float32")
    want, _ = jax.jit(lambda p, x: JMOE.moe_mlp(p, x, jcfg))(jparams, jx)
    got, _ = moe.moe_mlp(tparams, tx, cfg)
    assert got.dtype == torch.float32 and got.shape == tx.shape
    _close(got, want, LAYER_TOL)


class _UpcastBf16Dots:
    """``jax.numpy`` with ``einsum`` taking bf16 operands as fp32 where the
    result is fp32 (see the module docstring)."""

    def __getattr__(self, name):
        return getattr(jnp, name)

    @staticmethod
    def einsum(spec, *operands, preferred_element_type=None, **kw):
        if preferred_element_type == jnp.float32:
            operands = [o.astype(jnp.float32) if o.dtype == jnp.bfloat16
                        else o for o in operands]
        return jnp.einsum(spec, *operands,
                          preferred_element_type=preferred_element_type, **kw)


@pytest.mark.parametrize("kind", ["biased", "ragged", "tied"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_mlp_matches_reference_bf16(arch, kind, monkeypatch):
    monkeypatch.setattr(JMOE, "jnp", _UpcastBf16Dots())
    cfg, jcfg, jparams, jx, tparams, tx = _moe_pair(arch, kind, "bfloat16")
    with jax.disable_jit():
        want, _ = JMOE.moe_mlp(jparams, jx, jcfg)
    jitted, _ = jax.jit(lambda p, x: JMOE.moe_mlp(p, x, jcfg))(jparams, jx)
    got, _ = moe.moe_mlp(tparams, tx, cfg)
    assert got.dtype == torch.bfloat16
    _same_but_flips(got, want)
    assert _rel(got, jitted) <= BF16_JIT_RTOL


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_routing_drops_pads_and_breaks_ties_as_the_reference(arch):
    """The cases above do what they are built for: the biased router's
    expert 0 overflows (drops), padding routes nowhere, and the tie goes
    to the lower index."""
    cfg, _, jp, _ = _params(arch)
    g = cfg.moe_group_size
    cap = moe.capacity(cfg, g)

    def routed(kind):
        p, x = _case(cfg, jp, kind)
        n = x.shape[0] * x.shape[1]
        g_size = min(g, n)
        n_groups = -(-n // g_size)
        rows = torch.zeros((n_groups * g_size, cfg.d_model))
        rows[:n] = torch.from_numpy(x.reshape(n, -1))
        valid = (torch.arange(n_groups * g_size) < n).view(n_groups, g_size)
        return moe.route(torch.from_numpy(p["router"]),
                         rows.view(n_groups, g_size, -1), valid, cfg), valid

    (expert, _, slot, kept), _ = routed("biased")
    assert bool((expert[..., 0] == 0).all())
    assert int(kept[..., 0].sum()) == cap * expert.shape[0]
    assert bool((kept == (slot < cap)).all())
    (_, _, _, kept), valid = routed("ragged")
    assert not bool(valid.all())
    assert not bool(kept[~valid].any())
    (expert, gate, _, _), _ = routed("tied")
    # experts 1 and 3 tie everywhere: 3 is picked only after 1
    has1, has3 = (expert == 1).any(-1), (expert == 3).any(-1)
    assert bool(has1.any()) and bool((has3 <= has1).all())
    first1 = (expert == 1).float().argmax(-1)
    first3 = (expert == 3).float().argmax(-1)
    assert bool((first1 < first3)[has3].all())
    torch.testing.assert_close(gate.sum(-1), torch.ones(gate.shape[:-1]))
    probs = torch.tensor([[0.1, 0.3, 0.2, 0.3, 0.1]])
    assert moe.top_k(probs, 3)[1].tolist() == [[1, 3, 2]]


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_params_from_numpy_keeps_the_pytree(arch):
    cfg, _, jp, tp = _params(arch)
    for path, leaf in jax.tree_util.tree_flatten_with_path(jp)[0]:
        t = tp
        for key in path:
            t = t[key.key]
        assert tuple(t.shape) == leaf.shape, path
        assert str(t.dtype).split(".")[-1] == str(leaf.dtype), path
    assert tp["layers"]["moe"]["router"].dtype == torch.float32
    assert ("shared" in tp["layers"]["moe"]) == (cfg.n_shared_experts > 0)
    own = get_model(cfg).init(torch.Generator().manual_seed(0), "cpu")
    assert jax.tree.map(lambda a: a.shape, jp) == tree_map(
        lambda t: tuple(t.shape), own)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_block_matches_reference(arch):
    cfg, jcfg, jp, tp = _params(arch)
    h = np.random.default_rng(3).normal(size=(2, 16, cfg.d_model)).astype(
        np.float32)
    pos = np.broadcast_to(np.arange(16, dtype=np.int32), (2, 16)).copy()
    jl = jax.tree.map(lambda a: a[1], jp["layers"])
    want = jax.jit(lambda lp, hh: JMOE.block_apply(
        lp, hh, jnp.asarray(pos), jcfg))(jl, jnp.asarray(h))
    got, _ = moe.block_apply(layer(tp["layers"], 1), torch.from_numpy(h),
                             torch.from_numpy(pos), cfg)
    _close(got, want, LAYER_TOL)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_forward_prefill_and_decode_match_reference(arch):
    cfg, jcfg, jp, tp = _params(arch)
    jm, tm = j_get_model(jcfg), get_model(cfg)
    toks = _tokens((2, 24), cfg.vocab_size, seed=2)
    want = jax.jit(jm.forward)(jp, {"tokens": jnp.asarray(toks)})
    got = tm.forward(tp, {"tokens": torch.from_numpy(toks)})
    _close(got, want, MODEL_TOL)
    max_len = 22
    lj, cj = jax.jit(jm.prefill, static_argnums=2)(
        jp, {"tokens": jnp.asarray(toks[:, :18])}, max_len)
    lt, ct = tm.prefill(tp, {"tokens": torch.from_numpy(toks[:, :18])},
                        max_len)
    _close(lt, lj, MODEL_TOL)
    assert set(ct) == set(cj) == set(tm.cache_axes())
    for key in cj:
        _close(ct[key], cj[key], MODEL_TOL)
    j_decode = jax.jit(jm.decode_step)
    for step in range(6):                     # the last two past the cache
        tok = toks[:, 18 + step:19 + step]
        lj, cj = j_decode(jp, cj, {"tokens": jnp.asarray(tok)})
        lt, ct = tm.decode_step(tp, ct, {"tokens": torch.from_numpy(tok)})
        _close(lt, lj, MODEL_TOL)
        for key in cj:
            _close(ct[key], cj[key], MODEL_TOL)


def test_served_streams_equal_the_reference_end_to_end():
    """qwen2-moe-a2.7b-smoke through both serving engines: identical token
    streams (decode routes all slots' tokens as one group, empty slots
    included, in both)."""
    arch = "qwen2-moe-a2.7b"
    cfg = smoke_config(arch)
    sc = scenario_preset("steady", n_requests=6)
    reference = JaxModelRunner(j_smoke_config(arch), n_slots=2,
                               max_len=sc.max_len, devices=jax.devices()[:1])
    theirs = JServingEngine(reference, n_slots=2, clock=JTickClock()).run(
        j_traffic.make_traffic(j_traffic.scenario_preset(
            "steady", n_requests=6), 0), sc)
    runner = TorchModelRunner(
        cfg, n_slots=2, max_len=sc.max_len, device="cpu",
        params=jax.tree.map(np.asarray, reference._host_params))
    trace = make_traffic(sc, seed=0)
    ours = ServingEngine(runner, n_slots=2, clock=TickClock()).run(trace, sc)
    assert set(ours.streams) == set(trace.rids)
    assert ours.streams == theirs.streams
    assert ours.slo.to_row() == theirs.slo.to_row()


def test_serve_cli_serves_the_moe_smoke_model_on_cpu(capsys):
    from repro_torch.launch import serve as serve_cli

    assert serve_cli.main(["--arch", "granite-moe-1b-a400m", "--smoke",
                           "--device", "cpu", "--requests", "3"]) == 0
    out = capsys.readouterr().out
    assert "granite-moe-1b-a400m-smoke · scenario=steady" in out
    assert "served 3/3 requests" in out
