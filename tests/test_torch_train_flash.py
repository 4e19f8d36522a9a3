"""flash_attention's gradient (src/repro_torch/kernels/flash_attention.py)
against the JAX package.

``flash_attention_backward_plain`` (the backward kernel's plain version,
fed the plain forward's output and log-sum-exp) and the ``flash_attention``
op under autograd (``FlashAttentionFn``, whose CPU route is that plain
backward) against ``jax.vjp`` of ``ref.attention``, on the same numpy
inputs and output gradient, float32: causal, sliding window, GQA, MHA,
end-aligned Sq != Sk, and ``sk_valid`` < Sk (JAX sees the first sk_valid
keys; the keys past them get a zero gradient).  Rows that see no key,
where ``ref.attention`` averages every key, are held against autograd
through ``flash_attention_plain`` instead.  Tolerance: rtol 1e-5 / atol
1e-5 (float32 sums in another order).  The forward's lse against
``jax.nn.logsumexp`` of the masked scores.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lm_harness import assert_close
from repro.kernels import ref
from repro_torch import kernels as K
from repro_torch.kernels.flash_attention import (
    attention_mask, flash_attention, flash_attention_backward_plain,
    flash_attention_plain)

CASES = [  # B, Hq, Hkv, Sq, Sk, D, causal, window, sk_valid
    (2, 4, 2, 32, 32, 32, True, None, None),     # GQA, causal
    (1, 4, 1, 29, 29, 16, True, 16, None),       # MQA, window, ragged
    (1, 2, 2, 24, 24, 16, False, None, None),    # MHA, full
    (2, 4, 1, 8, 56, 32, True, 20, None),        # Sq != Sk, window
    (1, 8, 2, 20, 40, 16, True, None, 33),       # sk_valid < Sk
    (1, 16, 1, 12, 30, 16, True, 9, 25),         # rep 16, window, sk_valid
    (1, 16, 1, 10, 24, 256, True, 8, 21),        # D 256, as rep 16 above
]


def _inputs(case, seed):
    B, Hq, Hkv, Sq, Sk, D = case[:6]
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Hq, Sq, D)).astype(np.float32)
    k = rng.standard_normal((B, Hkv, Sk, D)).astype(np.float32)
    v = rng.standard_normal((B, Hkv, Sk, D)).astype(np.float32)
    do = rng.standard_normal((B, Hq, Sq, D)).astype(np.float32)
    return q, k, v, do


def _jax_grads(q, k, v, do, causal, window, skv):
    """(out, dq, dk, dv) of ref.attention over the first skv keys; the
    keys past them get zeros."""
    ks, vs = k[:, :, :skv], v[:, :, :skv]

    @jax.jit
    def run(a, b, c, g):
        out, vjp = jax.vjp(lambda x, y, z: ref.attention(
            x, y, z, causal=causal, window=window), a, b, c)
        return (out,) + vjp(g)
    out, dq, dk, dv = run(q, ks, vs, do)
    pad = ((0, 0), (0, 0), (0, k.shape[2] - skv), (0, 0))
    return (np.asarray(out), np.asarray(dq), np.pad(np.asarray(dk), pad),
            np.pad(np.asarray(dv), pad))


@pytest.mark.parametrize("case", CASES, ids=[str(c) for c in CASES])
def test_backward_plain_and_function_match_jax_vjp(case):
    causal, window, sk_valid = case[6:]
    q, k, v, do = _inputs(case, seed=CASES.index(case))
    skv = sk_valid or k.shape[2]
    out, *want = _jax_grads(q, k, v, do, causal, window, skv)
    kw = dict(causal=causal, window=window, sk_valid=sk_valid)
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))

    o, lse = flash_attention_plain(tq, tk, tv, with_lse=True, **kw)
    assert_close(o, out, 1e-5, 1e-5, "out")
    got = flash_attention_backward_plain(tq, tk, tv, o, lse, tdo, **kw)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert_close(g, w, 1e-5, 1e-5, f"plain {name}")

    leaves = [t.clone().requires_grad_() for t in (tq, tk, tv)]
    before = (K.flash_attention.calls, K.flash_attention_backward.calls)
    o2 = flash_attention(*leaves, **kw)
    assert o2.grad_fn is not None
    got = torch.autograd.grad(o2, leaves, tdo)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert_close(g, w, 1e-5, 1e-5, f"function {name}")
    # One forward call and one backward call; the CPU launches nothing.
    assert (K.flash_attention.calls, K.flash_attention_backward.calls) == (
        before[0] + 1, before[1] + 1)
    assert K.flash_attention.launches == 0
    assert K.flash_attention_backward.launches == 0

    scores = np.einsum("bhqd,bhkd->bhqk", np.repeat(
        q, 1, 1), np.repeat(k, q.shape[1] // k.shape[1], 1)) * q.shape[-1] \
        ** -0.5
    mask = attention_mask(q.shape[2], k.shape[2], causal=causal,
                          window=window, sq_valid=q.shape[2],
                          sk_valid=skv).numpy()
    want_lse = jax.nn.logsumexp(jnp.where(mask, scores, -jnp.inf), axis=-1)
    assert_close(lse, np.asarray(want_lse), 1e-5, 1e-5, "lse")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rows_without_keys_get_zero_gradient(dtype):
    """sq_valid > sk_valid: the first rows sit before every key.  Their
    dq is 0, as the plain forward's autograd gives; dk and dv agree."""
    g = torch.Generator().manual_seed(5)
    q = torch.randn(1, 4, 20, 16, generator=g).to(dtype)
    k = torch.randn(1, 2, 30, 16, generator=g).to(dtype)
    v = torch.randn(1, 2, 30, 16, generator=g).to(dtype)
    do = torch.randn(1, 4, 20, 16, generator=g).to(dtype)
    kw = dict(causal=True, window=None, sq_valid=18, sk_valid=6)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    got = torch.autograd.grad(flash_attention(*leaves, **kw), leaves, do)
    ref_leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(flash_attention_plain(*ref_leaves, **kw),
                               ref_leaves, do)
    _, lse = flash_attention_plain(q, k, v, with_lse=True, **kw)
    blind = torch.isinf(lse)
    assert int(blind.sum()) == 4 * 12          # rows 0..11 see no key
    assert bool((got[0][blind] == 0).all())
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == dtype
        tol = 1e-5 if dtype == torch.float32 else 1e-2
        assert_close(a, b, tol, tol, name)


def test_forward_only_call_is_unchanged():
    """Without grad the op is the plain forward (no Function, no lse)."""
    g = torch.Generator().manual_seed(1)
    q, k, v = (torch.randn(1, 2, 9, 16, generator=g) for _ in range(3))
    with torch.no_grad():
        out = flash_attention(q.requires_grad_(), k, v)
    assert out.grad_fn is None
    assert torch.equal(out, flash_attention_plain(q.detach(), k, v))
