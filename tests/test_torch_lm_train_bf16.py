"""The port's LM loss and gradients in bf16 (``dtype`` and ``param_dtype``
bfloat16) against the JAX reference, for the smoke configs of the six
families, at (2, 32) tokens (the encoder-decoder's memory 24 frames).

The reference runs op by op (``jax.disable_jit``) and jitted (XLA fuses
and rounds elsewhere).  Bars: the loss within 2e-2 relative and each
leaf's gradient within 5e-2 of its norm (‖Δ‖/‖ref‖; the reference's bf16
kernel bar, ``tests/test_kernels.py``) of the op-by-op reference; against
the jitted reference, within 5e-2 plus the distance of the reference's
own two runs for that leaf.  Measured against the op-by-op reference:
dense 1.3e-4, the encoder-decoder and the VLM 1.3e-2, the MoE 1.9e-2,
the Mamba2 LM 4.36e-2 and Zamba2 4.48e-2, both on ``d_skip``, whose
gradient sums many bf16 products of the SSD: with the SSD's four
deliberate roundings D1-D4 replaced by the reference's
(``tests/test_torch_zamba2_bf16.py``'s twin) they move by less than
1.2e-2, so D1-D4 are not the whole of it; the backward's own roundings
(autograd's cotangent casts against JAX's transposes) are the rest.
Against the jitted reference Zamba2's ``a_log`` is 5.33e-2 away, over a
plain 5e-2, where the reference's own two runs are 4.55e-2 apart.

The MoE: bf16 roundings flip expert choices between the frameworks, and a
flipped choice changes the function.  The port's choices are recorded and
replayed in the op-by-op reference (its ``jax.lax.top_k`` swapped for a
lookup, the gates gathered from its own probabilities); the share of
choices that flip without the replay is printed.

XLA's CPU backend cannot run the reference MoE's batched bf16 dots with
fp32 results, so, as in ``test_torch_moe.py``, its ``einsum`` runs them on
the operands upcast to fp32 (bf16 products are exact in fp32).

On the card (``gpu``) the same comparisons, at the same bars, hold the
port's card path: the loss on K4/K5 and the bf16 products with fp32
output as one GEMM, whose backward (``layers.gemm_f32_grads``) splits the
fp32 cotangent into two bf16 halves where JAX multiplies it in fp32.
The CPU port's distance to the same reference is printed beside it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import moe as JMOE
from repro_torch.models import moe
from repro_torch.models.tree import tree_map
from repro_torch.parallel import gradsync
from test_torch_lm_train import (  # noqa: F401  (cuda: a fixture)
    BF16_GRAD_TOL,
    BF16_LOSS_RTOL,
    FAMILY_ARCHS,
    batch_np,
    cuda,
    leaf_errors,
    models,
    to_jax,
    to_torch,
)

SEQ = 32


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _UpcastBf16Dots:
    """``jax.numpy`` with ``einsum`` taking bf16 operands as fp32 where the
    result is fp32."""

    def __getattr__(self, name):
        return getattr(jnp, name)

    @staticmethod
    def einsum(spec, *operands, preferred_element_type=None, **kw):
        if preferred_element_type == jnp.float32:
            operands = [o.astype(jnp.float32) if o.dtype == jnp.bfloat16
                        else o for o in operands]
        return jnp.einsum(spec, *operands,
                          preferred_element_type=preferred_element_type, **kw)


class _TopK:
    """``jax`` for the reference MoE with ``lax.top_k`` recording its
    choices, or replaying ``replay`` (one (G, T, k) array per call)."""

    def __init__(self, replay=None):
        self.replay = None if replay is None else list(replay)
        self.seen: list[np.ndarray] = []
        outer = self

        class _Lax:
            def __getattr__(self, name):
                return getattr(jax.lax, name)

            @staticmethod
            def top_k(probs, k):
                if outer.replay is None:
                    gate, idx = jax.lax.top_k(probs, k)
                else:
                    idx = jnp.asarray(outer.replay.pop(0), jnp.int32)
                    gate = jnp.take_along_axis(probs, idx, axis=-1)
                outer.seen.append(np.asarray(idx))
                return gate, idx

        self.lax = _Lax()

    def __getattr__(self, name):
        return getattr(jax, name)


def _reference(family, nb, eager):
    _, _, jm, _, jp, _ = models(FAMILY_ARCHS[family], "bfloat16")
    fn = jax.value_and_grad(jm.loss_fn)
    if eager:
        with jax.disable_jit():
            return fn(jp, to_jax(nb, "bfloat16"))
    return jax.jit(fn)(jp, to_jax(nb, "bfloat16"))


def _port(family, nb, device="cpu"):
    """The port's (loss, gradients) on ``device``, returned on the CPU."""
    _, _, _, tm, _, tp = models(FAMILY_ARCHS[family], "bfloat16")
    batch = to_torch(nb, "bfloat16")
    if device != "cpu":
        tp = tree_map(lambda t: t.to(device), tp)
        batch = {k: v.to(device) for k, v in batch.items()}
    loss, grads = gradsync.value_and_grad(tm.loss_fn)(tp, batch)
    return loss.cpu(), tree_map(lambda t: t.cpu(), grads)


BF16_FAMILIES = ["dense", "ssm", "hybrid", "encdec", "vlm"]


@pytest.mark.parametrize("family", BF16_FAMILIES)
def test_bf16_loss_and_grads_match_reference(family):
    cfg = models(FAMILY_ARCHS[family], "bfloat16")[0]
    nb = batch_np(cfg, s=SEQ, mask=family in ("encdec", "vlm"))
    loss, grads = _port(family, nb)
    eager_loss, eager = _reference(family, nb, eager=True)
    jit_loss, jitted = _reference(family, nb, eager=False)
    errs = leaf_errors(grads, eager)
    own = dict((p, e) for e, p in leaf_errors(
        jax.tree.map(lambda a: torch.from_numpy(np.asarray(a, np.float32)),
                     jitted), eager))
    jit_errs = leaf_errors(grads, jitted)
    print(f"{family} bf16: loss {float(loss)} vs op-by-op "
          f"{float(eager_loss)}, jitted {float(jit_loss)}; worst leaves "
          f"against op-by-op {errs[:3]}, against jitted {jit_errs[:3]} "
          f"(the reference's own jit-vs-op-by-op distance on those: "
          f"{[own[p] for _, p in jit_errs[:3]]})")
    assert loss.dtype == torch.float32
    for want in (eager_loss, jit_loss):
        np.testing.assert_allclose(float(loss), float(want),
                                   rtol=BF16_LOSS_RTOL)
    assert errs[0][0] <= BF16_GRAD_TOL, errs[:3]
    for err, path in jit_errs:
        assert err <= BF16_GRAD_TOL + own[path], (path, err, own[path])


@pytest.mark.gpu
@pytest.mark.parametrize("family", BF16_FAMILIES)
def test_bf16_loss_and_grads_on_card_match_reference(cuda, family):
    cfg = models(FAMILY_ARCHS[family], "bfloat16")[0]
    nb = batch_np(cfg, s=SEQ, mask=family in ("encdec", "vlm"))
    loss, grads = _port(family, nb, cuda)
    eager_loss, eager = _reference(family, nb, eager=True)
    errs = leaf_errors(grads, eager)
    cpu_errs = leaf_errors(_port(family, nb)[1], eager)
    print(f"{family} bf16 on the card: loss {float(loss)} vs op-by-op "
          f"{float(eager_loss)}; worst leaves {errs[:3]} (the CPU port's: "
          f"{cpu_errs[:3]})")
    np.testing.assert_allclose(float(loss), float(eager_loss),
                               rtol=BF16_LOSS_RTOL)
    assert errs[0][0] <= BF16_GRAD_TOL, errs[:3]


def _moe_replayed(monkeypatch, device):
    monkeypatch.setattr(JMOE, "jnp", _UpcastBf16Dots())
    cfg = models(FAMILY_ARCHS["moe"], "bfloat16")[0]
    nb = batch_np(cfg, s=SEQ)
    real_top_k, chosen = moe.top_k, []

    def recording(probs, k):
        gate, expert = real_top_k(probs, k)
        chosen.append(expert.cpu().numpy().copy())
        return gate, expert

    monkeypatch.setattr(moe, "top_k", recording)
    loss, grads = _port("moe", nb, device)
    own = _TopK()
    monkeypatch.setattr(JMOE, "jax", own)
    free_loss, free = _reference("moe", nb, eager=True)
    replay = _TopK(chosen)
    monkeypatch.setattr(JMOE, "jax", replay)
    want_loss, want = _reference("moe", nb, eager=True)
    assert replay.replay == [] and len(replay.seen) == cfg.n_layers
    flips = np.mean([np.mean(np.sort(a, -1) != np.sort(b, -1))
                     for a, b in zip(chosen, own.seen)])
    errs = leaf_errors(grads, want)
    print(f"moe bf16 ({device}): {100 * flips:.2f}% of expert choices flip "
          f"between the frameworks; loss {float(loss)} vs replayed "
          f"{float(want_loss)} "
          f"(free-running {float(free_loss)}); worst leaves replayed "
          f"{errs[:3]}, free-running {leaf_errors(grads, free)[:3]}")
    np.testing.assert_allclose(float(loss), float(want_loss),
                               rtol=BF16_LOSS_RTOL)
    assert errs[0][0] <= BF16_GRAD_TOL, errs[:3]


def test_bf16_moe_with_the_ports_choices_replayed(monkeypatch):
    _moe_replayed(monkeypatch, "cpu")


@pytest.mark.gpu
def test_bf16_moe_on_card_with_its_choices_replayed(cuda, monkeypatch):
    _moe_replayed(monkeypatch, cuda)
