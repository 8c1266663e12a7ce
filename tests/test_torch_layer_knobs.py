"""The three ``ModelConfig`` knobs the dry-run's plans set, in the port's
``models/layers`` against the JAX reference's (``repro.models.layers``,
which sets no XLA flags, imported here directly), on the same numpy
inputs, outside any mesh (``shard_constraint`` does nothing there):

  * ``embed_onehot``: the one-hot matmul lookup, chunked over length,
    bit-identical to the reference's and to the row gather, in fp32 and
    bf16; its table gradient within 1e-6 of the reference's (sums of the
    same terms in another order);
  * ``accum_dtype``: under ``use_accum_dtype("bfloat16")`` the unembedding
    and SwiGLU return what the reference's do, dtypes equal, values within
    one bf16 ulp of the larger plus 1e-2 of the largest (both sides round
    fp32 sums taken in another order); the fused loss keeps fp32 logits
    (1e-5); under ``"float32"`` nothing changes, bit for bit;
  * ``attn_chunk_threshold``: causal self-attention past the threshold on
    the plain path takes the kv-chunked online softmax with its
    flash-style backward, held in fp32 to the reference's
    ``_sdpa_chunked_causal`` (output and ``jax.grad`` of the input and
    every parameter, 1e-5 of the largest), and to the port's own plain
    attention; in bf16 the output within 2e-2 of the largest.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as JL
from repro_torch.models import layers as L

FP32_TOL = 1e-5
BF16_ULP = 2.0 ** -7


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(a) -> np.ndarray:
    """numpy fp64 copy of a jax array or a tensor (bf16 included)."""
    if isinstance(a, torch.Tensor):
        return a.detach().double().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32), dtype=np.float64)


def _pair(a: np.ndarray, dtype: str):
    """(jax array, tensor) of ``a`` in ``dtype``, the same values."""
    j = jnp.asarray(a, dtype=jnp.float32).astype(dtype)
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(
        getattr(torch, dtype))


def _rel(out, want) -> float:
    o, w = _np(out), _np(want)
    return float(np.abs(o - w).max() / max(np.abs(w).max(), 1e-30))


# ------------------------------------------------------------ one-hot embed

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("length", [1024, 100])   # 2 chunks; one ragged
def test_onehot_embed_is_bit_identical(dtype, length):
    rng = np.random.default_rng(0)
    vocab, d = 300, 16
    jw, w = _pair(rng.normal(size=(vocab, d)) * 0.02, dtype)
    tok = rng.integers(0, vocab, size=(2, length)).astype(np.int32)
    got = L.embed({"w": w}, torch.from_numpy(tok), onehot=True)
    want = JL.embed({"w": jw}, jnp.asarray(tok), onehot=True)
    assert got.dtype == w.dtype and tuple(got.shape) == (2, length, d)
    np.testing.assert_array_equal(_np(got), _np(want))
    assert torch.equal(got, L.embed({"w": w}, torch.from_numpy(tok)))


def test_onehot_embed_gradient_matches_reference():
    rng = np.random.default_rng(1)
    vocab, d, length = 64, 8, 1024
    table = rng.normal(size=(vocab, d)).astype(np.float32)
    tok = rng.integers(0, vocab, size=(2, length)).astype(np.int32)
    ct = rng.normal(size=(2, length, d)).astype(np.float32)
    want = jax.grad(lambda w: jnp.sum(
        JL.embed({"w": w}, jnp.asarray(tok), onehot=True) * ct))(
        jnp.asarray(table))
    w = torch.from_numpy(table).requires_grad_(True)
    (L.embed({"w": w}, torch.from_numpy(tok), onehot=True)
     * torch.from_numpy(ct)).sum().backward()
    assert _rel(w.grad, want) <= 1e-6


# ------------------------------------------------------------ accum dtype

def _mlp_params(rng, d, f, dtype):
    names = (("w_gate", (d, f)), ("w_up", (d, f)), ("w_down", (f, d)))
    pairs = {k: _pair(rng.normal(size=s) / np.sqrt(s[0]), dtype)
             for k, s in names}
    return ({k: j for k, (j, _) in pairs.items()},
            {k: t for k, (_, t) in pairs.items()})


def _within_bf16(out, want, slack):
    o, w = _np(out), _np(want)
    bar = BF16_ULP * np.maximum(np.abs(o), np.abs(w)) \
        + slack * np.abs(w).max()
    assert (np.abs(o - w) <= bar).all(), float(np.abs(o - w).max())


def test_accum_dtype_bfloat16_products_match_reference():
    rng = np.random.default_rng(2)
    d, f, vocab = 64, 128, 256
    jx, x = _pair(rng.normal(size=(2, 16, d)), "bfloat16")
    jp, p = _mlp_params(rng, d, f, "bfloat16")
    jemb, emb = _pair(rng.normal(size=(vocab, d)) * 0.1, "bfloat16")
    with JL.use_accum_dtype(jnp.bfloat16):
        want_mlp = JL.mlp(jp, jx)
        want_logits = JL.unembed({"w": jemb}, jx)
    with L.use_accum_dtype("bfloat16"):
        got_mlp = L.mlp(p, x)
        got_logits = L.unembed({"w": emb}, x)
    assert got_logits.dtype == torch.bfloat16 == got_mlp.dtype
    assert str(want_logits.dtype) == "bfloat16"
    _within_bf16(got_mlp, want_mlp, 1e-2)
    _within_bf16(got_logits, want_logits, 1e-2)
    assert L.pet() == torch.float32          # the scope closed


def test_fused_loss_keeps_fp32_logits_under_bfloat16():
    rng = np.random.default_rng(3)
    d, vocab, length = 32, 256, 1024
    jh, h = _pair(rng.normal(size=(2, length, d)), "bfloat16")
    jemb, emb = _pair(rng.normal(size=(vocab, d)) * 0.1, "bfloat16")
    lab = rng.integers(0, vocab, size=(2, length)).astype(np.int32)
    with JL.use_accum_dtype(jnp.bfloat16):
        want = JL.fused_unembed_ce({"w": jemb}, jh, jnp.asarray(lab))
    with L.use_accum_dtype("bfloat16"):
        got = L.fused_unembed_ce({"w": emb}, h, torch.from_numpy(lab))
    assert got.dtype == torch.float32
    assert abs(float(got) - float(want)) <= FP32_TOL * abs(float(want))


def test_accum_dtype_float32_changes_nothing():
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.normal(size=(2, 8, 32))).to(torch.bfloat16)
    _, p = _mlp_params(rng, 32, 64, "bfloat16")
    emb = {"w": torch.from_numpy(rng.normal(size=(128, 32))).to(
        torch.bfloat16)}
    plain = (L.mlp(p, x), L.unembed(emb, x))
    with L.use_accum_dtype("float32"):
        scoped = (L.mlp(p, x), L.unembed(emb, x))
    for a, b in zip(plain, scoped):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert plain[1].dtype == torch.float32


# ------------------------------------------------------- chunked attention

D_MODEL, HEADS, KV, HEAD_DIM, THETA = 32, 4, 2, 16, 10_000.0
SEQ = 2048                     # two 1024-key chunks
THRESHOLD = 1024 * 1024        # SEQ² exceeds it: the chunked path


def _attn_inputs(dtype: str, seed: int = 5):
    rng = np.random.default_rng(seed)
    shapes = {"wq": (D_MODEL, HEADS, HEAD_DIM), "wk": (D_MODEL, KV, HEAD_DIM),
              "wv": (D_MODEL, KV, HEAD_DIM), "wo": (HEADS, HEAD_DIM, D_MODEL)}
    pairs = {k: _pair(rng.normal(size=s) / np.sqrt(s[0] if k != "wo"
                                                     else HEADS * HEAD_DIM),
                      dtype) for k, s in shapes.items()}
    x = _pair(rng.normal(size=(1, SEQ, D_MODEL)), dtype)
    ct = rng.normal(size=(1, SEQ, D_MODEL)).astype(np.float32)
    pos = np.broadcast_to(np.arange(SEQ, dtype=np.int32), (1, SEQ)).copy()
    return pairs, x, ct, pos


def _port_attention(p, x, pos, threshold):
    y, _ = L.attention(p, x, torch.from_numpy(pos), theta=THETA, causal=True,
                       mode="ref", chunk_threshold=threshold)
    return y


def test_chunked_attention_matches_reference_and_plain_in_fp32():
    pairs, (jx, x), ct, pos = _attn_inputs("float32")
    jp = {k: j for k, (j, _) in pairs.items()}

    def ref_loss(p, xx):
        y = JL.attention(p, xx, jnp.asarray(pos), theta=THETA, causal=True,
                         chunk_threshold=THRESHOLD)
        return jnp.sum(y * ct), y

    (_, want_y), (want_gp, want_gx) = jax.value_and_grad(
        ref_loss, argnums=(0, 1), has_aux=True)(jp, jx)

    def port(threshold):
        p = {k: t.clone().requires_grad_(True) for k, (_, t) in pairs.items()}
        xx = x.clone().requires_grad_(True)
        y = _port_attention(p, xx, pos, threshold)
        (y * torch.from_numpy(ct)).sum().backward()
        return y, p, xx

    y, p, xx = port(THRESHOLD)
    assert _rel(y, want_y) <= FP32_TOL
    assert _rel(xx.grad, want_gx) <= FP32_TOL
    for k in p:
        assert _rel(p[k].grad, want_gp[k]) <= FP32_TOL, k
    # the plain (unchunked) path of the port computes the same function
    y0, p0, xx0 = port(SEQ * SEQ)
    assert _rel(y, y0) <= FP32_TOL and _rel(xx.grad, xx0.grad) <= FP32_TOL
    for k in p:
        assert _rel(p[k].grad, p0[k].grad) <= FP32_TOL, k


def test_chunked_attention_bf16_forward_matches_reference():
    pairs, (jx, x), _, pos = _attn_inputs("bfloat16", seed=6)
    want = JL.attention({k: j for k, (j, _) in pairs.items()}, jx,
                        jnp.asarray(pos), theta=THETA, causal=True,
                        chunk_threshold=THRESHOLD)
    got = _port_attention({k: t for k, (_, t) in pairs.items()}, x, pos,
                          THRESHOLD)
    assert got.dtype == torch.bfloat16
    assert _rel(got, want) <= 2e-2


def test_chunked_path_only_past_the_threshold_and_off_the_kernel_path(
        monkeypatch):
    """The chunked twin is taken on the plain path past the threshold
    only; the kernel path (prefill) keeps K6."""
    calls = []
    real = L._SdpaChunkedCausal.apply
    monkeypatch.setattr(L._SdpaChunkedCausal, "apply",
                        lambda *a: calls.append(1) or real(*a))
    pairs, (_, x), _, pos = _attn_inputs("float32")
    p = {k: t for k, (_, t) in pairs.items()}
    with torch.no_grad():
        _port_attention(p, x, pos, SEQ * SEQ)
        assert not calls
        L.attention(p, x, torch.from_numpy(pos), theta=THETA, causal=True,
                    chunk_threshold=THRESHOLD)          # mode None: K6
        assert not calls
        _port_attention(p, x, pos, THRESHOLD)
        assert len(calls) == 1
