"""The port's dense transformer (``models/layers``, ``transformer``,
``api``) against the JAX reference on the four dense smoke configs
(granite-3-2b: GQA; qwen3-14b: GQA and qk-norm; qwen2.5-14b and
qwen1.5-110b: GQA and QKV bias), fp32, from the reference's own
parameters (``get_model(cfg).init(PRNGKey(0))`` as numpy) with its zero
biases and unit norm scales replaced by random values, so that every
term shows.

The reference runs outside any mesh (``shard_constraint`` is a no-op
there); the port runs on the CPU, where ``ops.flash_attention`` uses its
plain version.  Tolerances, as tests/test_torch_zamba2.py: 1e-5 at layer
level, 1e-4 for the model's logits and cache leaves.  Decode is held
through the cache's last row and past it, where the reference drops the
write (``mode="drop"``) and the port must too.  The serving engine's
token streams on qwen3-14b-smoke equal ``JaxModelRunner``'s.

bf16 (qwen3-14b-smoke and qwen2.5-14b-smoke, ``dtype`` and
``param_dtype`` bfloat16) is held to the reference run op by op
(``jax.disable_jit``) and jitted.  The port departs from the reference
nowhere on purpose.  The SwiGLU MLP is bit-identical; a block equals the
op-by-op reference but for single-ulp flips of a bf16 rounding where a
sum runs in another fp32 order (measured: 1.7e-3 of the largest value,
on few elements); the model's fp32 logits meet it to fp32 order (1.4e-7
of the largest logit, measured over forward, prefill and 4 decode steps)
and its bf16 caches are equal but for flips.  The jitted reference (XLA
fuses bf16 chains and rounds elsewhere) differs from its own op-by-op run
by up to 6.9e-3 of a block and 1.3e-2 of the logits on these configs, a
property of the reference's compiler; the port is held to it at 3e-2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as j_smoke_config
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.models.api import get_model as j_get_model
from repro.serve import traffic as j_traffic
from repro.serve.runner import JaxModelRunner
from repro.serve.scheduler import ServingEngine as JServingEngine
from repro.serve.scheduler import TickClock as JTickClock
from repro_torch.configs import smoke_config
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
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

DENSE_ARCHS = ["granite-3-2b", "qwen3-14b", "qwen2.5-14b", "qwen1.5-110b"]
BF16_ARCHS = ["qwen3-14b", "qwen2.5-14b"]
LAYER_TOL = 1e-5
MODEL_TOL = 1e-4
# bf16, as shares of the largest value (measured maxima in the docstring):
# fp32 results whose sums run in another order; against the jitted
# reference
FP32_ORDER = 1e-6
BF16_JIT_RTOL = 3e-2
# where both sides round one value summed in another fp32 order, a few
# elements may differ: by one bf16 ulp of themselves, or (a sum that
# cancels, then rounded) by FLIP_RTOL of the largest value
FLIP_SHARE = 5e-3
FLIP_RTOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _randomised(tree, seed):
    """The reference's init with its constant leaves (zero biases, unit
    norm scales) drawn at random, in each leaf's dtype."""
    rng = np.random.default_rng(seed)

    def leaf(path, a):
        name = jax.tree_util.keystr(path)
        a = np.asarray(a)
        if any(k in name for k in ("'bq'", "'bk'", "'bv'")):
            r = rng.normal(size=a.shape) * 0.5
        elif "'scale'" in name:
            r = 1.0 + rng.normal(size=a.shape) * 0.2
        else:
            return a
        return r.astype(np.float32).astype(a.dtype)
    return jax.tree_util.tree_map_with_path(leaf, tree)


_PARAMS: dict = {}


def _params(arch, dtype="float32"):
    """(port cfg, reference cfg, reference params (jax), port params)."""
    key = (arch, dtype)
    if key not in _PARAMS:
        over = {"dtype": dtype, "param_dtype": dtype}
        cfg = smoke_config(arch).replace(**over)
        jcfg = j_smoke_config(arch).replace(**over)
        host = _randomised(jax.jit(j_get_model(jcfg).init)(
            jax.random.PRNGKey(0)), seed=1)
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


def _hidden(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _pos(b, s):
    return np.broadcast_to(np.arange(s, dtype=np.int32), (b, s)).copy()


def _jlayer(tree, i):
    return jax.tree.map(lambda a: a[i], tree)


# ---- fp32 ----------------------------------------------------------------

@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_params_from_numpy_keeps_the_pytree(arch):
    cfg, _, jp, tp = _params(arch)
    for path, leaf in jax.tree_util.tree_flatten_with_path(jp)[0]:
        t = tp
        for key in path:
            t = t[key.key]
        assert tuple(t.shape) == leaf.shape, path
        assert str(t.dtype).split(".")[-1] == str(leaf.dtype), path
    assert tp["layers"]["attn"]["wk"].shape == (
        cfg.n_layers, cfg.d_model, cfg.n_kv_heads, cfg.resolved_head_dim)
    assert ("bq" in tp["layers"]["attn"]) == cfg.qkv_bias
    assert ("q_norm" in tp["layers"]["attn"]) == cfg.qk_norm
    assert ("unembed" in tp) == (not cfg.tie_embeddings)
    # the port's own init draws the same tree
    own = get_model(cfg).init(torch.Generator().manual_seed(0), "cpu")
    assert jax.tree.map(lambda a: a.shape, jp) == tree_map(
        lambda t: tuple(t.shape), own)


@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_attention_matches_reference(arch):
    cfg, _, jp, tp = _params(arch)
    x = _hidden((2, 16, cfg.d_model), 2)
    pos = _pos(2, 16)
    kw = dict(theta=cfg.rope_theta, qk_norm=cfg.qk_norm, eps=cfg.norm_eps)
    ja, ta = _jlayer(jp["layers"], 1)["attn"], layer(tp["layers"], 1)["attn"]
    want = JL.attention(ja, jnp.asarray(x), jnp.asarray(pos), causal=True,
                        **kw)
    got, (k, v) = L.attention(ta, torch.from_numpy(x), torch.from_numpy(pos),
                              causal=True, **kw)
    _close(got, want, LAYER_TOL)
    jk, jv = JL.prefill_attention_kv(ja, jnp.asarray(x), jnp.asarray(pos),
                                     **kw)
    _close(k, jk, LAYER_TOL)
    _close(v, jv, LAYER_TOL)
    assert k.shape == (2, 16, cfg.n_kv_heads, cfg.resolved_head_dim)


@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_decode_attention_matches_reference_through_the_last_row(arch):
    """Rows at depth 5, at the cache's last row (S − 1) and past it (S):
    the last row is written and attended; past it the reference drops the
    write and attends the whole cache."""
    cfg, _, jp, tp = _params(arch)
    s, kv, hd = 12, cfg.n_kv_heads, cfg.resolved_head_dim
    x = _hidden((3, 1, cfg.d_model), 3)
    ck, cv = _hidden((3, s, kv, hd), 4), _hidden((3, s, kv, hd), 5)
    cache_len = np.array([5, s - 1, s], np.int32)
    pos = cache_len[:, None].copy()
    kw = dict(theta=cfg.rope_theta, qk_norm=cfg.qk_norm, eps=cfg.norm_eps)
    ja, ta = _jlayer(jp["layers"], 0)["attn"], layer(tp["layers"], 0)["attn"]
    yj, ckj, cvj = JL.decode_attention(
        ja, jnp.asarray(x), jnp.asarray(ck), jnp.asarray(cv),
        jnp.asarray(cache_len), jnp.asarray(pos), **kw)
    tk, tv = torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy())
    yt, ckt, cvt = L.decode_attention(
        ta, torch.from_numpy(x), tk, tv, torch.from_numpy(cache_len),
        torch.from_numpy(pos), **kw)
    assert ckt is tk and cvt is tv                 # written in place
    _close(yt, yj, LAYER_TOL)
    _close(ckt, ckj, LAYER_TOL)
    _close(cvt, cvj, LAYER_TOL)
    np.testing.assert_array_equal(ckt[2].numpy(), ck[2])   # dropped write
    assert not np.array_equal(ckt[1, s - 1].numpy(), ck[1, s - 1])


def test_decode_attention_window_matches_reference():
    cfg, _, jp, tp = _params("qwen3-14b")
    s, kv, hd = 12, cfg.n_kv_heads, cfg.resolved_head_dim
    x = _hidden((2, 1, cfg.d_model), 6)
    ck, cv = _hidden((2, s, kv, hd), 7), _hidden((2, s, kv, hd), 8)
    cache_len = np.array([3, 9], np.int32)
    kw = dict(theta=cfg.rope_theta, qk_norm=True, eps=cfg.norm_eps, window=4)
    yj, ckj, _ = JL.decode_attention(
        _jlayer(jp["layers"], 0)["attn"], jnp.asarray(x), jnp.asarray(ck),
        jnp.asarray(cv), jnp.asarray(cache_len),
        jnp.asarray(cache_len[:, None]), **kw)
    yt, ckt, _ = L.decode_attention(
        layer(tp["layers"], 0)["attn"], torch.from_numpy(x),
        torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy()),
        torch.from_numpy(cache_len), torch.from_numpy(cache_len[:, None].copy()),
        **kw)
    _close(yt, yj, LAYER_TOL)
    _close(ckt, ckj, LAYER_TOL)


@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_block_apply_and_decode_match_reference(arch):
    cfg, jcfg, jp, tp = _params(arch)
    jl, tl = _jlayer(jp["layers"], 1), layer(tp["layers"], 1)
    h = _hidden((2, 16, cfg.d_model), 9)
    pos = _pos(2, 16)
    want = jax.jit(lambda lp, hh: JT.block_apply(lp, hh, jnp.asarray(pos),
                                                 jcfg))(jl, jnp.asarray(h))
    got, _ = T.block_apply(tl, torch.from_numpy(h), torch.from_numpy(pos),
                           cfg)
    _close(got, want, LAYER_TOL)
    s, kv, hd = 20, cfg.n_kv_heads, cfg.resolved_head_dim
    one = _hidden((2, 1, cfg.d_model), 10)
    ck, cv = _hidden((2, s, kv, hd), 11), _hidden((2, s, kv, hd), 12)
    cache_len = np.array([7, 16], np.int32)
    decode_j = jax.jit(lambda lp, hh, a, b, n: JT.block_decode(
        lp, hh, a, b, n, n[:, None], jcfg))
    hj, ckj, cvj = decode_j(jl, jnp.asarray(one), jnp.asarray(ck),
                            jnp.asarray(cv), jnp.asarray(cache_len))
    tk, tv = torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy())
    n = torch.from_numpy(cache_len)
    ht = T.block_decode(tl, torch.from_numpy(one), tk, tv, n, n[:, None], cfg)
    _close(ht, hj, LAYER_TOL)
    _close(tk, ckj, LAYER_TOL)
    _close(tv, cvj, LAYER_TOL)


@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_forward_matches_reference(arch):
    cfg, jcfg, jp, tp = _params(arch)
    toks = _tokens((2, 32), cfg.vocab_size)
    want = jax.jit(j_get_model(jcfg).forward)(jp, {"tokens": jnp.asarray(toks)})
    got = get_model(cfg).forward(tp, {"tokens": torch.from_numpy(toks)})
    assert got.dtype == torch.float32 and got.shape == want.shape
    _close(got, want, MODEL_TOL)


@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_prefill_cache_and_decode_past_the_end_match_reference(arch):
    """Prefill 12 tokens into a 16-deep cache, then 7 decode steps: the
    fourth writes the cache's last row, the last three write past it (the
    reference drops those writes and attends the whole cache)."""
    cfg, jcfg, jp, tp = _params(arch)
    jm, tm = j_get_model(jcfg), get_model(cfg)
    toks = _tokens((2, 19), cfg.vocab_size, seed=4)
    max_len = 16
    lj, cj = jax.jit(jm.prefill, static_argnums=2)(
        jp, {"tokens": jnp.asarray(toks[:, :12])}, max_len)
    lt, ct = tm.prefill(tp, {"tokens": torch.from_numpy(toks[:, :12])},
                        max_len)
    _close(lt, lj, MODEL_TOL)
    assert set(ct) == set(cj) == set(tm.cache_axes())
    for key in cj:
        assert tuple(ct[key].shape) == cj[key].shape, key
        assert str(ct[key].dtype).split(".")[-1] == str(cj[key].dtype), key
        _close(ct[key], cj[key], MODEL_TOL)
    j_decode = jax.jit(jm.decode_step)
    for step in range(7):
        tok = toks[:, 12 + step:13 + step]
        lj, cj = j_decode(jp, cj, {"tokens": jnp.asarray(tok)})
        lt, ct = tm.decode_step(tp, ct, {"tokens": torch.from_numpy(tok)})
        _close(lt, lj, MODEL_TOL)
        for key in cj:
            _close(ct[key], cj[key], MODEL_TOL)
    assert ct["len"].tolist() == [19, 19]


def test_prefill_refuses_a_prompt_longer_than_the_cache():
    cfg, _, _, tp = _params("granite-3-2b")
    with pytest.raises(ValueError, match="max_len"):
        T.prefill(tp, {"tokens": torch.zeros((1, 9), dtype=torch.int64)},
                  cfg, 8)


def test_served_streams_equal_the_reference_end_to_end():
    """qwen3-14b-smoke through both serving engines, same trace, same numpy
    parameters, virtual time: identical token streams and reports."""
    arch = "qwen3-14b"
    cfg = smoke_config(arch)
    sc = scenario_preset("steady", n_requests=6)
    sc = sc.replace(prompt_buckets=snap_prompt_buckets(cfg, sc.prompt_buckets))
    reference = JaxModelRunner(j_smoke_config(arch), n_slots=2,
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


# ---- bf16 ----------------------------------------------------------------

@pytest.mark.parametrize("arch", BF16_ARCHS)
def test_bf16_mlp_is_bit_identical(arch):
    cfg, _, jp, tp = _params(arch, "bfloat16")
    x = _hidden((2, 16, cfg.d_model), 13)
    jx = jnp.asarray(x, jnp.bfloat16)
    with jax.disable_jit():
        want = JL.mlp(_jlayer(jp["layers"], 0)["mlp"], jx)
    got = L.mlp(layer(tp["layers"], 0)["mlp"],
                torch.from_numpy(np.asarray(jx, np.float32)).bfloat16())
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(_np32(got), _np32(want))


@pytest.mark.parametrize("arch", BF16_ARCHS)
def test_bf16_block_matches_reference(arch):
    cfg, jcfg, jp, tp = _params(arch, "bfloat16")
    jl, tl = _jlayer(jp["layers"], 1), layer(tp["layers"], 1)
    h = np.asarray(jnp.asarray(_hidden((2, 16, cfg.d_model), 14),
                               jnp.bfloat16), np.float32)
    pos = _pos(2, 16)
    with jax.disable_jit():
        want = JT.block_apply(jl, jnp.asarray(h, jnp.bfloat16),
                              jnp.asarray(pos), jcfg)
    jitted = jax.jit(lambda lp, hh: JT.block_apply(
        lp, hh, jnp.asarray(pos), jcfg))(jl, jnp.asarray(h, jnp.bfloat16))
    got, _ = T.block_apply(tl, torch.from_numpy(h).bfloat16(),
                           torch.from_numpy(pos), cfg)
    assert got.dtype == torch.bfloat16
    _same_but_flips(got, want)
    assert _rel(got, jitted) <= BF16_JIT_RTOL


@pytest.mark.parametrize("arch", BF16_ARCHS)
def test_bf16_model_matches_reference(arch):
    """forward, prefill and 4 decode steps against the op-by-op reference,
    and the logits against the jitted one."""
    cfg, jcfg, jp, tp = _params(arch, "bfloat16")
    jm, tm = j_get_model(jcfg), get_model(cfg)
    toks = _tokens((2, 20), cfg.vocab_size, seed=5)
    got = tm.forward(tp, {"tokens": torch.from_numpy(toks)})
    with jax.disable_jit():
        want = jm.forward(jp, {"tokens": jnp.asarray(toks)})
    assert _rel(got, want) <= FP32_ORDER
    jitted = jax.jit(jm.forward)(jp, {"tokens": jnp.asarray(toks)})
    assert _rel(got, jitted) <= BF16_JIT_RTOL
    with jax.disable_jit():
        lj, cj = jm.prefill(jp, {"tokens": jnp.asarray(toks[:, :16])}, 20)
        lt, ct = tm.prefill(tp, {"tokens": torch.from_numpy(toks[:, :16])},
                            20)
        assert _rel(lt, lj) <= FP32_ORDER
        for key in ("k", "v"):
            assert ct[key].dtype == torch.bfloat16
            _same_but_flips(ct[key], cj[key])
        for step in range(4):
            tok = toks[:, 16 + step:17 + step]
            lj, cj = jm.decode_step(jp, cj, {"tokens": jnp.asarray(tok)})
            lt, ct = tm.decode_step(tp, ct, {"tokens": torch.from_numpy(tok)})
            assert _rel(lt, lj) <= FP32_ORDER
            for key in ("k", "v"):
                _same_but_flips(ct[key], cj[key])


def test_serve_cli_serves_the_dense_smoke_model_on_cpu(capsys):
    from repro_torch.launch import serve as serve_cli

    assert serve_cli.main(["--arch", "qwen3-14b", "--smoke", "--device",
                           "cpu", "--requests", "3", "--slots", "2"]) == 0
    out = capsys.readouterr().out
    assert "qwen3-14b-smoke · scenario=steady" in out
    assert "served 3/3 requests" in out
