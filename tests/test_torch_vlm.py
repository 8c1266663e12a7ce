"""The port's VLM backbone (``models/vlm.py``, family ``"vlm"``: the dense
transformer with Qwen2-VL's M-RoPE) against the JAX reference on
qwen2-vl-72b-smoke (2 layers, d_model 64, 4 heads on 2 KV heads of 16,
QKV bias, M-RoPE sections (2, 3, 3)), from the reference's own parameters
(``get_model(cfg).init(PRNGKey(0))`` as numpy) with its zero biases and
unit norm scales replaced by random values; the reference runs outside any
mesh.

``apply_mrope`` and the position makers are held to the reference's on
text positions (three equal streams, where M-RoPE is RoPE) and image-grid
positions; the model's prefill takes embeddings (the vision front end's
stub) at grid positions and decodes tokens, rotated by the cache length on
every stream.  fp32: layers 1e-5, models 1e-4.  bf16 (``dtype`` and
``param_dtype`` bfloat16): no departure on purpose; measured on this
config, a block equals the op-by-op reference but for single-ulp flips,
the logits of forward, prefill and 4 decode steps meet it within 1.2e-7
of the largest logit and the caches bit for bit (held: equal but for
flips); the jitted reference is 9.9e-3 from its own op-by-op run and from
the port, which is held to it at 3e-2.

Also here: ``get_model`` serves all six families of the reference on the
CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as j_smoke_config
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.models import vlm as JV
from repro.models.api import get_model as j_get_model
from repro_torch.configs import smoke_config
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models import vlm as V
from repro_torch.models.api import PORTED_FAMILIES, get_model
from repro_torch.models.tree import layer, params_from_numpy, tree_map

ARCH = "qwen2-vl-72b"
LAYER_TOL = 1e-5
MODEL_TOL = 1e-4
FP32_ORDER = 1e-6
BF16_JIT_RTOL = 3e-2
FLIP_SHARE = 5e-3
FLIP_RTOL = 1e-5
GRID = (2, 3, 4)            # (t, h, w): 24 positions


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _randomised(tree, seed):
    """The reference's init with its zero biases and unit norm scales drawn
    at random, in each leaf's dtype."""
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


def _params(dtype="float32"):
    """(port cfg, reference cfg, reference params (jax), port params)."""
    if dtype not in _PARAMS:
        over = {"dtype": dtype, "param_dtype": dtype}
        cfg = smoke_config(ARCH).replace(**over)
        jcfg = j_smoke_config(ARCH).replace(**over)
        host = _randomised(jax.jit(j_get_model(jcfg).init)(
            jax.random.PRNGKey(0)), seed=1)
        _PARAMS[dtype] = (cfg, jcfg, jax.tree.map(jnp.asarray, host),
                          params_from_numpy(host, "cpu"))
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


def _hidden(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(
        np.float32)


def _jlayer(tree, i):
    return jax.tree.map(lambda a: a[i], tree)


def _positions(kind, b):
    """(reference positions (jnp), the port's (torch)), (3, B, 24)."""
    if kind == "text":
        return JV.make_text_positions(b, 24), V.make_text_positions(b, 24)
    return JV.make_image_positions(b, *GRID), V.make_image_positions(b, *GRID)


# ---- M-RoPE ----------------------------------------------------------------

@pytest.mark.parametrize("kind", ["text", "image"])
def test_position_makers_equal_the_reference(kind):
    jpos, tpos = _positions(kind, 2)
    assert tpos.dtype == torch.int32
    np.testing.assert_array_equal(tpos.numpy(), np.asarray(jpos))


@pytest.mark.parametrize("kind", ["text", "image"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_mrope_matches_reference(kind, dtype):
    """Sections (16, 24, 24) over head_dim 128, as qwen2-vl-72b's, and the
    smoke config's (2, 3, 3) over 16: fp32 within 1e-6, bf16 equal but for
    flips."""
    jpos, tpos = _positions(kind, 2)
    for d, sections in ((128, (16, 24, 24)), (16, (2, 3, 3))):
        x = _hidden((2, 24, 3, d), 3)
        jx = jnp.asarray(x, getattr(jnp, dtype))
        tx = torch.from_numpy(np.array(jx, np.float32)).to(
            getattr(torch, dtype))
        want = JL.apply_mrope(jx, jpos, 1e6, sections)
        got = L.apply_mrope(tx, tpos, 1e6, sections)
        assert got.dtype == tx.dtype
        if dtype == "float32":
            _close(got, want, FP32_ORDER)
        else:
            _same_but_flips(got, want)


def test_mrope_on_text_positions_is_rope():
    """With the three streams equal, M-RoPE turns every slot with the same
    position: it is RoPE, in the port as in the reference."""
    _, tpos = _positions("text", 2)
    x = torch.from_numpy(_hidden((2, 24, 3, 16), 4))
    torch.testing.assert_close(L.apply_mrope(x, tpos, 1e4, (2, 3, 3)),
                               L.apply_rope(x, tpos[0], 1e4), rtol=0, atol=0)
    with pytest.raises(ValueError, match="must sum to 8"):
        L.apply_mrope(x, tpos, 1e4, (2, 3, 2))


def test_attention_with_mrope_matches_reference():
    cfg, _, jp, tp = _params()
    jpos, tpos = _positions("image", 2)
    x = _hidden((2, 24, cfg.d_model), 5)
    kw = dict(theta=cfg.rope_theta, eps=cfg.norm_eps,
              mrope_sections=cfg.mrope_sections)
    ja, ta = _jlayer(jp["layers"], 1)["attn"], layer(tp["layers"], 1)["attn"]
    want = JL.attention(ja, jnp.asarray(x), jpos, causal=True, **kw)
    got, (k, v) = L.attention(ta, torch.from_numpy(x), tpos, causal=True,
                              **kw)
    _close(got, want, LAYER_TOL)
    jk, jv = JL.prefill_attention_kv(ja, jnp.asarray(x), jpos, **kw)
    _close(k, jk, LAYER_TOL)
    _close(v, jv, LAYER_TOL)


# ---- fp32 model ------------------------------------------------------------

def test_params_from_numpy_keeps_the_pytree():
    cfg, _, jp, tp = _params()
    for path, leaf in jax.tree_util.tree_flatten_with_path(jp)[0]:
        t = tp
        for key in path:
            t = t[key.key]
        assert tuple(t.shape) == leaf.shape, path
    assert "bq" in tp["layers"]["attn"] and "unembed" in tp
    own = get_model(cfg).init(torch.Generator().manual_seed(0), "cpu")
    assert jax.tree.map(lambda a: a.shape, jp) == tree_map(
        lambda t: tuple(t.shape), own)


def _embeds_batch(cfg, seed=6, dtype="float32"):
    """(reference batch, port batch): embeddings at image-grid positions."""
    jpos, tpos = _positions("image", 2)
    emb = jnp.asarray(_hidden((2, 24, cfg.d_model), seed, 0.5),
                      getattr(jnp, dtype))
    temb = torch.from_numpy(np.array(emb, np.float32)).to(
        getattr(torch, dtype))
    return {"embeds": emb, "positions": jpos}, {"embeds": temb,
                                                 "positions": tpos}


def test_block_with_mrope_matches_reference():
    cfg, jcfg, jp, tp = _params()
    jpos, tpos = _positions("image", 2)
    h = _hidden((2, 24, cfg.d_model), 7)
    want = JT.block_apply(_jlayer(jp["layers"], 0), jnp.asarray(h), jpos,
                          jcfg)
    got, _ = T.block_apply(layer(tp["layers"], 0), torch.from_numpy(h), tpos,
                           cfg)
    _close(got, want, LAYER_TOL)


@pytest.mark.parametrize("inputs", ["embeds", "tokens"])
def test_forward_matches_reference(inputs):
    """Embeddings at image-grid positions, or tokens at text positions (the
    default: 0..S-1 on all three streams)."""
    cfg, jcfg, jp, tp = _params()
    if inputs == "embeds":
        jb, tb = _embeds_batch(cfg)
    else:
        toks = np.random.default_rng(8).integers(0, cfg.vocab_size, (2, 20),
                                                 dtype=np.int32)
        jb, tb = {"tokens": jnp.asarray(toks)}, {"tokens": torch.from_numpy(toks)}
    want = jax.jit(j_get_model(jcfg).forward)(jp, jb)
    got = get_model(cfg).forward(tp, tb)
    assert got.dtype == torch.float32 and got.shape == want.shape
    _close(got, want, MODEL_TOL)


def test_prefill_of_embeds_and_decode_match_reference():
    """Prefill 24 embeddings at image-grid positions into a 30-deep cache,
    then 6 decode steps of tokens: logits and every cache leaf after each
    call."""
    cfg, jcfg, jp, tp = _params()
    jm, tm = j_get_model(jcfg), get_model(cfg)
    jb, tb = _embeds_batch(cfg, seed=9)
    lj, cj = jax.jit(jm.prefill, static_argnums=2)(jp, jb, 30)
    lt, ct = tm.prefill(tp, tb, 30)
    _close(lt, lj, MODEL_TOL)
    assert set(ct) == set(cj)
    for key in cj:
        _close(ct[key], cj[key], MODEL_TOL)
    toks = np.random.default_rng(10).integers(0, cfg.vocab_size, (2, 6),
                                              dtype=np.int32)
    j_decode = jax.jit(jm.decode_step)
    for step in range(6):
        tok = toks[:, step:step + 1]
        lj, cj = j_decode(jp, cj, {"tokens": jnp.asarray(tok)})
        lt, ct = tm.decode_step(tp, ct, {"tokens": torch.from_numpy(tok)})
        _close(lt, lj, MODEL_TOL)
        for key in cj:
            _close(ct[key], cj[key], MODEL_TOL)
    assert ct["len"].tolist() == [30, 30]


def test_prefill_launches_flash_attention_once_a_layer(monkeypatch):
    from repro_torch.kernels import ops

    cfg, _, _, tp = _params()
    calls = []

    def counted(q, k, v, causal=True, *, window=0, mode=None,
                _fn=ops.flash_attention):
        assert window == 0
        calls.append((q.shape[1], k.shape[1], causal))
        return _fn(q, k, v, causal, window=window, mode=mode)
    monkeypatch.setattr(ops, "flash_attention", counted)
    get_model(cfg).prefill(tp, _embeds_batch(cfg)[1], 30)
    assert calls == [(cfg.n_heads, cfg.n_kv_heads, True)] * cfg.n_layers


# ---- bf16 model ------------------------------------------------------------

def test_bf16_block_equals_reference_but_for_flips():
    cfg, jcfg, jp, tp = _params("bfloat16")
    jpos, tpos = _positions("image", 2)
    h = jnp.asarray(_hidden((2, 24, cfg.d_model), 11), jnp.bfloat16)
    with jax.disable_jit():
        want = JT.block_apply(_jlayer(jp["layers"], 1), h, jpos, jcfg)
    got, _ = T.block_apply(layer(tp["layers"], 1),
                           torch.from_numpy(np.array(h, np.float32)).bfloat16(),
                           tpos, cfg)
    assert got.dtype == torch.bfloat16
    _same_but_flips(got, want)


def test_bf16_model_matches_reference():
    """forward and a prefill of embeddings at grid positions, then 4 decode
    steps, against the op-by-op reference; forward against the jitted one."""
    cfg, jcfg, jp, tp = _params("bfloat16")
    jm, tm = j_get_model(jcfg), get_model(cfg)
    jb, tb = _embeds_batch(cfg, seed=12, dtype="bfloat16")
    got = tm.forward(tp, tb)
    with jax.disable_jit():
        want = jm.forward(jp, jb)
    assert _rel(got, want) <= FP32_ORDER
    assert _rel(got, jax.jit(jm.forward)(jp, jb)) <= BF16_JIT_RTOL
    toks = np.random.default_rng(13).integers(0, cfg.vocab_size, (2, 4),
                                              dtype=np.int32)
    with jax.disable_jit():
        lj, cj = jm.prefill(jp, jb, 30)
        lt, ct = tm.prefill(tp, tb, 30)
        assert _rel(lt, lj) <= FP32_ORDER
        for key in ("k", "v"):
            _same_but_flips(ct[key], cj[key])
        for step in range(4):
            tok = toks[:, step:step + 1]
            lj, cj = jm.decode_step(jp, cj, {"tokens": jnp.asarray(tok)})
            lt, ct = tm.decode_step(tp, ct, {"tokens": torch.from_numpy(tok)})
            assert _rel(lt, lj) <= FP32_ORDER
            for key in ("k", "v"):
                _same_but_flips(ct[key], cj[key])


# ---- all six families ------------------------------------------------------

SIX = {"dense": "qwen3-14b", "moe": "qwen2-moe-a2.7b", "ssm": "mamba2-2.7b",
       "hybrid": "zamba2-1.2b", "encdec": "seamless-m4t-large-v2",
       "vlm": ARCH}


@pytest.mark.parametrize("family", sorted(SIX))
def test_get_model_serves_every_family(family):
    """Each family's smoke config through ``get_model``: a prefill and two
    decode steps on the CPU, logits of the reference's shapes."""
    assert set(PORTED_FAMILIES) == set(SIX)
    cfg = smoke_config(SIX[family])
    assert cfg.family == family
    model = get_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    toks = torch.randint(0, cfg.vocab_size, (2, 16),
                         generator=torch.Generator().manual_seed(1))
    if family == "encdec":
        batch = {"enc_embeds": torch.randn(2, 9, cfg.d_model),
                 "dec_tokens": toks}
    elif family == "vlm":
        batch = {"embeds": torch.randn(2, 24, cfg.d_model),
                 "positions": V.make_image_positions(2, *GRID)}
    else:
        batch = {"tokens": toks}
    logits, cache = model.prefill(params, batch, 32)
    assert logits.shape == (2, 1, cfg.vocab_size)
    assert set(cache) == set(model.cache_axes())
    for _ in range(2):
        logits, cache = model.decode_step(params, cache,
                                          {"tokens": torch.zeros(
                                              (2, 1), dtype=torch.int64)})
        assert logits.shape == (2, 1, cfg.vocab_size)
        assert bool(torch.isfinite(logits).all())
