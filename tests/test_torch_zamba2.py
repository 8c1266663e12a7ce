"""The port's Zamba2 hybrid (``models/layers``, ``mamba2``, ``zamba2``,
``api``) against the JAX reference on the smoke config (fp32, 5 Mamba
layers, 2 shared-attention invocations, ``ssm_chunk`` 8, ``attn_window``
64), from the reference's own parameters: ``get_model(cfg).init(
PRNGKey(0))`` as numpy, through ``params_from_numpy``.

The reference runs outside any mesh (``shard_constraint`` is a no-op
there); the port runs on the CPU, where ``ops.flash_attention`` and
``ops.ssd_chunk`` use their plain versions.  Tolerances: 1e-5 at layer
level, 1e-4 for the model's logits and cache leaves (tighter than the
reference's own 2e-4 bar for decode against forward,
tests/test_models_smoke.py); 1e-6 for the plain windowed attention
against the reference's masked ``_sdpa``.

A prompt longer than ``attn_window`` (the windowed prefill): the plain
flash attention with a window against the reference's mask, the shared
attention past the window, and a 96-token prefill with 4 decode steps
through the ring.  The port's prefill equals the reference's (logits, and
the ring's keys and values up to their slots); its decode steps equal the
reference's ``forward`` at those positions, where the reference's own
decode, which restarts RoPE at ``attn_window``, does not (ROADMAP.md,
queue 3).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as j_smoke_config
from repro.models import layers as JL
from repro.models import mamba2 as JM
from repro.models.api import get_model as j_get_model
from repro_torch.configs import smoke_config
from repro_torch.models import layers as L
from repro_torch.models import mamba2 as M
from repro_torch.models import zamba2
from repro_torch.models.api import get_model

ARCH = "zamba2-1.2b"
LAYER_TOL = 1e-5
MODEL_TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def cfgs():
    return smoke_config(ARCH), j_smoke_config(ARCH)


@pytest.fixture(scope="module")
def params(cfgs):
    """(reference params as jax arrays, the same as the port's tensors)."""
    jp = jax.jit(j_get_model(cfgs[1]).init)(jax.random.PRNGKey(0))
    tp = zamba2.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return jp, tp


def _close(ours, theirs, tol):
    np.testing.assert_allclose(ours.detach().float().numpy(),
                               np.asarray(theirs, np.float32),
                               rtol=tol, atol=tol)


def _tokens(shape, vocab, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, size=shape,
                                                dtype=np.int32)


def _layer(tree, i):
    return jax.tree.map(lambda a: a[i], tree)


def test_params_from_numpy_keeps_the_pytree(cfgs, params):
    cfg = cfgs[0]
    jp, tp = params
    flat_j = jax.tree_util.tree_flatten_with_path(jp)[0]
    for path, leaf in flat_j:
        t = tp
        for key in path:
            t = t[key.key]
        assert tuple(t.shape) == leaf.shape, path
        assert str(t.dtype).split(".")[-1] == str(leaf.dtype), path
    assert tp["mamba"]["in_proj"]["w"].shape[0] == cfg.n_layers
    for name in ("a_log", "d_skip", "dt_bias"):
        assert tp["mamba"][name].dtype == torch.float32
    # the port's own init draws the same tree
    own = get_model(cfg).init(torch.Generator().manual_seed(0), "cpu")
    assert jax.tree.map(lambda a: a.shape, jp) == zamba2._tree_map(
        lambda t: tuple(t.shape), own)


def test_attention_matches_reference(cfgs, params):
    cfg = cfgs[0]
    jp, tp = params
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 16, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(16, dtype=np.int32), (2, 16))
    want = JL.attention(jp["shared"]["attn"], jnp.asarray(x), jnp.asarray(pos),
                        theta=cfg.rope_theta, causal=True,
                        window=cfg.attn_window)
    got, _ = L.attention(tp["shared"]["attn"], torch.from_numpy(x),
                         torch.from_numpy(pos.copy()), theta=cfg.rope_theta,
                         causal=True, window=cfg.attn_window)
    _close(got, want, LAYER_TOL)


@pytest.mark.parametrize("with_initial_state", [False, True])
def test_ssd_chunked_matches_reference(cfgs, with_initial_state):
    cfg = cfgs[0]
    h, p, n, s = cfg.ssm_heads, cfg.ssm_headdim, cfg.ssm_state, 32
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, s, h, p)).astype(np.float32)
    dt_a = (-np.abs(rng.normal(size=(2, s, h))) * 0.3).astype(np.float32)
    b = rng.normal(size=(2, s, 1, n)).astype(np.float32)
    c = rng.normal(size=(2, s, 1, n)).astype(np.float32)
    st0 = (rng.normal(size=(2, h, p, n)).astype(np.float32)
           if with_initial_state else None)
    y_j, fin_j = JM.ssd_chunked(*(jnp.asarray(a) for a in (x, dt_a, b, c)),
                                cfg.ssm_chunk,
                                None if st0 is None else jnp.asarray(st0))
    y_t, fin_t = M.ssd_chunked(*(torch.from_numpy(a) for a in (x, dt_a, b, c)),
                               cfg.ssm_chunk,
                               None if st0 is None else torch.from_numpy(st0))
    _close(y_t, y_j, LAYER_TOL)
    _close(fin_t, fin_j, LAYER_TOL)


def test_block_apply_and_decode_match_reference(cfgs, params):
    cfg = cfgs[0]
    jp, tp = params
    jl, tl = _layer(jp["mamba"], 1), zamba2._layer(tp["mamba"], 1)
    rng = np.random.default_rng(3)
    hid = rng.normal(size=(2, 16, cfg.d_model)).astype(np.float32)
    apply_j = jax.jit(lambda lp, hh: JM.block_apply(lp, hh, None, cfgs[1],
                                                    return_states=True))
    res_j, (st_j, tail_j) = apply_j(jl, jnp.asarray(hid))
    res_t, (st_t, tail_t) = M.block_apply(tl, torch.from_numpy(hid), cfg,
                                          return_states=True)
    _close(res_t, res_j, LAYER_TOL)
    _close(st_t, st_j, LAYER_TOL)
    _close(tail_t, tail_j, LAYER_TOL)
    one = rng.normal(size=(2, 1, cfg.d_model)).astype(np.float32)
    decode_j = jax.jit(lambda lp, hh, st, tail: JM.block_decode(
        lp, hh, st, tail, cfgs[1]))
    out_j, st2_j, tail2_j = decode_j(jl, jnp.asarray(one), st_j, tail_j)
    out_t, st2_t, tail2_t = M.block_decode(tl, torch.from_numpy(one), st_t,
                                           tail_t, cfg)
    _close(out_t, out_j, LAYER_TOL)
    _close(st2_t, st2_j, LAYER_TOL)
    _close(tail2_t, tail2_j, LAYER_TOL)


def test_forward_matches_reference(cfgs, params):
    jp, tp = params
    toks = _tokens((2, 32), cfgs[0].vocab_size)
    want = jax.jit(j_get_model(cfgs[1]).forward)(
        jp, {"tokens": jnp.asarray(toks)})
    got = get_model(cfgs[0]).forward(tp, {"tokens": torch.from_numpy(toks)})
    assert got.dtype == torch.float32
    _close(got, want, MODEL_TOL)


def test_prefill_cache_and_decode_through_the_ring_wrap(cfgs, params):
    """Prefill 16 tokens into an 18-deep cache, then 4 decode steps: the
    third and fourth write at ``len % 18`` = 0 and 1, the ring-buffer wrap
    of the shared block's KV cache (reference zamba2.py:93-100)."""
    jp, tp = params
    jm, tm = j_get_model(cfgs[1]), get_model(cfgs[0])
    toks = _tokens((2, 20), cfgs[0].vocab_size, seed=4)
    max_len = 18
    j_prefill = jax.jit(jm.prefill, static_argnums=2)
    j_decode = jax.jit(jm.decode_step)
    lj, cj = j_prefill(jp, {"tokens": jnp.asarray(toks[:, :16])}, max_len)
    lt, ct = tm.prefill(tp, {"tokens": torch.from_numpy(toks[:, :16])},
                        max_len)
    _close(lt, lj, MODEL_TOL)
    assert set(ct) == set(cj) == set(tm.cache_axes())
    for key in cj:
        assert tuple(ct[key].shape) == cj[key].shape, key
        _close(ct[key], cj[key], MODEL_TOL)
    assert ct["k"].shape[2] == max_len
    for step in range(4):
        tok = toks[:, 16 + step:17 + step]
        lj, cj = j_decode(jp, cj, {"tokens": jnp.asarray(tok)})
        lt, ct = tm.decode_step(tp, ct, {"tokens": torch.from_numpy(tok)})
        _close(lt, lj, MODEL_TOL)
        for key in cj:
            _close(ct[key], cj[key], MODEL_TOL)
    assert ct["len"].tolist() == [20, 20]


def test_unported_paths_raise(cfgs, params):
    cfg = cfgs[0]
    tp = params[1]
    # every family of the reference is ported (tests/test_torch_vlm.py); an
    # unknown one is refused, as the reference's get_model refuses it
    with pytest.raises(ValueError, match="unknown family"):
        get_model(cfg.replace(family="rnn"))
    x = torch.zeros(1, cfg.attn_window + 8, cfg.d_model)
    pos = torch.arange(x.shape[1])[None]
    # a prefill past attn_window is ported (the windowed tests below)
    # GQA is ported (tests/test_torch_dense.py); KV heads that do not
    # divide the query heads are refused by the flash kernel's wrapper
    gqa = {k: (v[:, :3] if k in ("wk", "wv") else v)
           for k, v in tp["shared"]["attn"].items()}
    with pytest.raises(ValueError, match="H % KV == 0"):
        L.attention(gqa, x[:, :8], pos[:, :8], theta=cfg.rope_theta)


WINDOW_TOL = 1e-6


@pytest.mark.parametrize("window", [1, 5, 64])
@pytest.mark.parametrize("kv", [4, 2])
def test_flash_attention_ref_window_matches_reference_sdpa(window, kv):
    from repro_torch.kernels.ref import flash_attention_ref

    b, lq, h, d = 2, 80, 4, 16
    rng = np.random.default_rng(window)
    q = rng.normal(size=(b, lq, h, d)).astype(np.float32)
    k, v = (rng.normal(size=(b, lq, kv, d)).astype(np.float32)
            for _ in range(2))
    iq, ik = np.arange(lq)[:, None], np.arange(lq)[None, :]
    mask = (ik <= iq) & (ik > iq - window)
    want = JL._sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                    jnp.asarray(mask[None, None, None]))
    tq, tk, tv = (torch.from_numpy(a).transpose(1, 2) for a in (q, k, v))
    got = flash_attention_ref(tq, tk, tv, True, window).transpose(1, 2)
    _close(got, want, WINDOW_TOL)
    if window == 1:                  # only the diagonal key: v itself
        np.testing.assert_allclose(
            got.numpy(), np.repeat(v, h // kv, axis=2), rtol=0, atol=1e-7)


def test_flash_attention_refuses_bad_windows():
    from repro_torch.kernels import ops

    q = torch.zeros(1, 2, 8, 16)
    with pytest.raises(ValueError, match="window"):
        ops.flash_attention(q, q, q, causal=True, window=-1)
    with pytest.raises(ValueError, match="only where causal"):
        ops.flash_attention(q, q, q, causal=False, window=4)
    assert torch.equal(ops.flash_attention(q, q, q, window=0),
                       ops.flash_attention(q, q, q))


def test_windowed_attention_matches_reference(cfgs, params):
    """The shared attention over 80 tokens, window 64: lk > window."""
    cfg = cfgs[0]
    jp, tp = params
    rng = np.random.default_rng(6)
    lk = cfg.attn_window + 16
    x = rng.normal(size=(2, lk, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(lk, dtype=np.int32), (2, lk))
    want = JL.attention(jp["shared"]["attn"], jnp.asarray(x), jnp.asarray(pos),
                        theta=cfg.rope_theta, causal=True,
                        window=cfg.attn_window)
    got, (k, _) = L.attention(tp["shared"]["attn"], torch.from_numpy(x),
                              torch.from_numpy(pos.copy()),
                              theta=cfg.rope_theta, causal=True,
                              window=cfg.attn_window)
    _close(got, want, LAYER_TOL)
    assert k.shape[1] == lk
    # the window matters at this length: the full causal mask differs
    full, _ = L.attention(tp["shared"]["attn"], torch.from_numpy(x),
                          torch.from_numpy(pos.copy()), theta=cfg.rope_theta)
    assert (full - got).abs().max() > 100 * LAYER_TOL


def test_windowed_prefill_and_decode_through_the_ring(cfgs, params):
    """A 96-token prompt (window 64) into a 128-deep cache, then 4 decode
    steps: the shared block's ring holds the last 64 keys, and each step
    overwrites the oldest."""
    cfg = cfgs[0]
    jp, tp = params
    jm, tm = j_get_model(cfgs[1]), get_model(cfg)
    toks = _tokens((2, 104), cfg.vocab_size, seed=5)
    s, max_len, w = 96, 128, cfg.attn_window
    lj, cj = jax.jit(jm.prefill, static_argnums=2)(
        jp, {"tokens": jnp.asarray(toks[:, :s])}, max_len)
    lt, ct = tm.prefill(tp, {"tokens": torch.from_numpy(toks[:, :s])},
                        max_len)
    _close(lt, lj, MODEL_TOL)
    assert ct["k"].shape[2] == w
    for key in ("ssm", "conv"):
        _close(ct[key], cj[key], MODEL_TOL)
    for key in ("k", "v"):           # position p at slot p % w
        _close(ct[key].roll(-(s % w), 2), cj[key], MODEL_TOL)
    assert ct["len"].tolist() == [s, s] and np.asarray(cj["len"]).tolist() == [w, w]
    want = jax.jit(jm.forward)(jp, {"tokens": jnp.asarray(toks)})
    j_decode = jax.jit(jm.decode_step)
    ref_gap = 0.0
    for step in range(4):
        tok = toks[:, s + step:s + step + 1]
        lt, ct = tm.decode_step(tp, ct, {"tokens": torch.from_numpy(tok)})
        lj, cj = j_decode(jp, cj, {"tokens": jnp.asarray(tok)})
        _close(lt[:, 0], want[:, s + step], MODEL_TOL)
        ref_gap = max(ref_gap, float(jnp.abs(lj[:, 0] - want[:, s + step]).max()))
    assert ct["len"].tolist() == [s + 4, s + 4]
    # the reference's decode after this prompt runs at RoPE positions 64..67
    print(f"reference decode against its forward: max |dlogit| {ref_gap:.3e}")
    assert ref_gap > 100 * MODEL_TOL
