"""Flash attention (K6) with grouped-query attention: q (B, H, S, D)
against k, v (B, KV, S, D), query head h reading KV head h // (H // KV).

On the CPU the wrapper runs its plain version (``ref.flash_attention_ref``),
held here to three oracles of the JAX reference on the same numpy inputs
(fp32 within 2e-5 and bf16 within 5e-2, the bars of
tests/test_torch_lm_kernels.py):

  * the model's masked ``_sdpa`` (``repro/models/layers.py``), which groups
    the heads itself, on (B, S, H, D) layouts with a causal mask;
  * its kv-chunked twin ``_sdpa_chunked_causal``;
  * the reference's Pallas kernel (interpret mode), which takes equal
    heads, on K and V repeated per group.

The wrapper refuses H % KV != 0 and hands K and V to the kernel as they
are (no copy per group).  The ``gpu`` cases hold the kernel itself, both
instantiations, to its plain version on the card, at the bars of
``chip_smoke.py``'s phase 7, and run the dense smoke model's kernel path
against its plain path there.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.models import layers as JL
from repro_torch.kernels import ops, ref
from repro_torch.kernels.flash_attention import flash_attention

fa_mod = importlib.import_module("repro_torch.kernels.flash_attention")

# (b, h, kv, s, d): groups of 1, 2 and 5
GQA_SHAPES = [(1, 4, 4, 32, 16), (2, 4, 2, 48, 16), (1, 10, 2, 64, 32)]
DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 5e-2)}
BF16_ULP = 2.0 ** -7


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bshd(b, h, kv, s, d, seed):
    """q (B, S, H, D), k, v (B, S, KV, D): the model's layout."""
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, s, h, d)).astype(np.float32),
            rng.normal(size=(b, s, kv, d)).astype(np.float32),
            rng.normal(size=(b, s, kv, d)).astype(np.float32))


def _ours(q, k, v, tdt, causal=True):
    """The wrapper on (B, H, S, D) views of the model's layout, returned
    in (B, S, H, D)."""
    views = [torch.from_numpy(a).to(tdt).transpose(1, 2) for a in (q, k, v)]
    return flash_attention(*views, causal).transpose(1, 2)


def _close(ours, theirs, tol):
    np.testing.assert_allclose(ours.float().numpy(),
                               np.asarray(theirs, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("b,h,kv,s,d", GQA_SHAPES)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_gqa_plain_matches_reference_sdpa(b, h, kv, s, d, dtype):
    jdt, tdt, tol = DTYPES[dtype]
    q, k, v = _bshd(b, h, kv, s, d, seed=0)
    mask = (np.arange(s)[None, :] <= np.arange(s)[:, None])[None, None, None]
    want = JL._sdpa(*(jnp.asarray(a, jdt) for a in (q, k, v)),
                    jnp.asarray(mask))
    got = _ours(q, k, v, tdt)
    assert got.dtype == tdt and got.shape == (b, s, h, d)
    _close(got, want, tol)


@pytest.mark.parametrize("b,h,kv,s,d", GQA_SHAPES)
def test_gqa_plain_matches_reference_chunked_sdpa(b, h, kv, s, d):
    q, k, v = _bshd(b, h, kv, s, d, seed=1)
    want = JL._sdpa_chunked_causal(*(jnp.asarray(a) for a in (q, k, v)),
                                   16, 1)
    _close(_ours(q, k, v, torch.float32), want, 2e-5)


@pytest.mark.parametrize("b,h,kv,s,d", GQA_SHAPES)
@pytest.mark.parametrize("causal", [True, False])
def test_gqa_plain_matches_pallas_kernel_on_repeated_kv(b, h, kv, s, d,
                                                        causal):
    q, k, v = _bshd(b, h, kv, s, d, seed=2)
    g = h // kv
    # (B, S, H, D) -> (B, H, S, D), K and V repeated per group for the
    # reference kernel, which takes equal heads
    qh, kh, vh = (np.swapaxes(a, 1, 2) for a in (q, k, v))
    want = jops.flash_attention(
        jnp.asarray(qh), jnp.asarray(np.repeat(kh, g, axis=1)),
        jnp.asarray(np.repeat(vh, g, axis=1)), causal=causal,
        force="pallas_interpret", block_q=16, block_kv=16)
    got = flash_attention(*(torch.from_numpy(np.ascontiguousarray(a))
                            for a in (qh, kh, vh)), causal)
    _close(got, want, 2e-5)


def test_gqa_ops_mode_ref_equals_the_wrapper_on_cpu():
    q, k, v = (torch.from_numpy(np.ascontiguousarray(np.swapaxes(a, 1, 2)))
               for a in _bshd(1, 6, 2, 20, 8, seed=3))
    before = ops.launch_counts()
    want = ops.flash_attention(q, k, v, mode="ref")
    torch.testing.assert_close(ops.flash_attention(q, k, v), want,
                               rtol=0, atol=0)
    assert ops.launch_counts() == before
    rep = ref.flash_attention_ref(q, k.repeat_interleave(3, 1),
                                  v.repeat_interleave(3, 1))
    torch.testing.assert_close(want, rep, rtol=0, atol=0)


@pytest.mark.parametrize("h,kv", [(6, 4), (4, 3), (5, 2)])
def test_wrapper_refuses_heads_not_a_multiple_of_kv(h, kv):
    q = torch.zeros(1, h, 8, 16)
    k = torch.zeros(1, kv, 8, 16)
    with pytest.raises(ValueError, match="H % KV == 0"):
        flash_attention(q, k, k)
    with pytest.raises(ValueError, match="H % KV == 0"):
        flash_attention(q, k, torch.zeros(1, kv, 9, 16))   # cross-attention


def test_wrapper_hands_kv_to_the_kernel_without_a_copy(monkeypatch):
    """On the card's dispatch the extension receives k and v themselves:
    the same storage and (B, KV, S, D) shape, no repeat per group."""
    seen = {}

    class FakeExtension:
        def flash_attention(self, q, k, v, out, causal, window):
            seen.update(q=q, k=k, v=v, out=out, causal=causal, window=window)

    monkeypatch.setattr(fa_mod, "device_type", lambda *_: "cuda")
    monkeypatch.setattr(fa_mod._build, "extension", lambda: FakeExtension())
    base = torch.zeros(2, 40, 8, 128, dtype=torch.bfloat16)   # (B, S, KV, D)
    q = torch.zeros(2, 40, 40, 128, dtype=torch.bfloat16).transpose(1, 2)
    k, v = base.transpose(1, 2), base.clone().transpose(1, 2)
    before = fa_mod.flash_attention.launches
    flash_attention(q, k, v, True)
    assert fa_mod.flash_attention.launches == before + 1
    assert seen["k"] is k and seen["v"] is v and seen["q"] is q
    assert seen["k"].data_ptr() == base.data_ptr()
    assert tuple(seen["k"].shape) == (2, 8, 40, 128)
    assert tuple(seen["out"].shape) == (2, 40, 40, 128)
    assert seen["causal"] is True and seen["window"] == 0


# ---- on the card -------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("b,h,kv,s,d", [(1, 40, 8, 512, 128),
                                        (1, 10, 2, 300, 64),
                                        (2, 8, 2, 100, 128),
                                        (1, 5, 1, 1, 64), (1, 4, 4, 130, 64)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gqa_kernel_matches_plain_on_card(cuda, b, h, kv, s, d, causal,
                                          dtype):
    gen = torch.Generator(device=cuda).manual_seed(5)
    q = torch.randn(b, s, h, d, generator=gen, device=cuda).to(dtype)
    k, v = (torch.randn(b, s, kv, d, generator=gen, device=cuda).to(dtype)
            for _ in range(2))
    q, k, v = (t.transpose(1, 2) for t in (q, k, v))
    before = ops.launch_counts()["flash_attention"]
    out = flash_attention(q, k, v, causal)
    torch.cuda.synchronize()
    assert ops.launch_counts()["flash_attention"] == before + 1
    want = ref.flash_attention_ref(q, k, v, causal)
    o, w = out.double(), want.double()
    if dtype == torch.float32:
        assert (o - w).abs().max() <= 2e-5 * w.abs().max()
    else:
        slack = BF16_ULP * ref.flash_attention_ref(
            q.float(), k.float(), v.float().abs(), causal).double()
        assert bool(((o - w).abs() <= BF16_ULP * w.abs() + slack).all())
        assert (o - w).norm() <= BF16_ULP * w.norm()


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["qwen3-14b", "qwen2.5-14b",
                                  "granite-moe-1b-a400m"])
def test_smoke_model_kernel_path_matches_plain_path_on_card(cuda, arch):
    """fp32 smoke model on the card: prefill through K6 against the plain
    path, logits and caches within 1e-4, one K6 launch per layer."""
    from repro_torch.configs import smoke_config
    from repro_torch.models.api import get_model

    cfg = smoke_config(arch)
    model = get_model(cfg)
    gen = torch.Generator(device=cuda).manual_seed(0)
    with torch.inference_mode():
        params = model.init(gen, cuda)
        toks = torch.randint(0, cfg.vocab_size, (2, 40), generator=gen,
                             device=cuda)
        before = ops.launch_counts()["flash_attention"]
        lk, ck = model.prefill(params, {"tokens": toks}, 48)
        torch.cuda.synchronize()
        assert (ops.launch_counts()["flash_attention"]
                == before + cfg.n_layers)
        lp, cp = model.prefill(params, {"tokens": toks}, 48, mode="ref")
    for got, want in ((lk, lp), (ck["k"], cp["k"]), (ck["v"], cp["v"])):
        assert (got - want).abs().max() <= 1e-4 * want.abs().max()
