"""rwkv6's gradient (src/repro_torch/kernels/rwkv6.py) against the JAX
package.

``rwkv6_backward_plain`` (the backward kernel's plain version: the states
recomputed by the forward's float32 loop, then the reverse walk of dS)
and the ``rwkv6`` op under autograd (``RWKV6Fn``, whose CPU route is that
plain backward) against ``jax.vjp`` of ``ref.rwkv6`` (run eagerly, as
tests/test_torch_train_rglru_grad.py explains), on the same numpy inputs
and cotangents, float32: s0 and ds_last given and absent, S = 1, S off 64
(70, 33), Dk != Dv, and w = 0 and w = 1 exactly.  Tolerance: rtol 1e-5 /
atol 1e-5 (float32 sums in another order).  bfloat16 r, k and v are held
against autograd through ``rwkv6_plain``.
"""
import jax
import numpy as np
import pytest
import torch

from lm_harness import assert_close
from repro.kernels import ref
from repro_torch import kernels as K
from repro_torch.kernels.rwkv6 import rwkv6, rwkv6_backward_plain, rwkv6_plain

NAMES = ("dr", "dk", "dv", "dw", "du", "ds0")
CASES = [  # B, H, S, Dk, Dv, s0 given, ds_last given, decay
    (1, 2, 5, 8, 8, True, True, "uniform"),
    (2, 1, 1, 4, 4, False, False, "uniform"),
    (1, 2, 70, 8, 6, True, False, "model"),
    (2, 1, 33, 4, 12, False, True, "edge"),
]


def _decay(rng, shape, mode):
    """"uniform" w in [0.05, 0.95]; "model" w = exp(-exp(z)), z in
    [-6, 4] (models/recurrent.py's range); "edge" the model's draw with a
    tenth of the steps at w = 0 and a tenth at w = 1 exactly."""
    if mode == "uniform":
        return 0.05 + 0.9 * rng.random(shape)
    w = np.exp(-np.exp(rng.random(shape) * 10.0 - 6.0))
    if mode == "edge":
        pick = rng.random(shape)
        w = np.where(pick < 0.1, 0.0, np.where(pick > 0.9, 1.0, w))
    return w


def _inputs(case, seed):
    B, H, S, Dk, Dv = case[:5]
    rng = np.random.default_rng(seed)
    f = np.float32
    r = (0.5 * rng.standard_normal((B, H, S, Dk))).astype(f)
    k = (0.5 * rng.standard_normal((B, H, S, Dk))).astype(f)
    v = rng.standard_normal((B, H, S, Dv)).astype(f)
    w = _decay(rng, (B, H, S, Dk), case[7]).astype(f)
    u = rng.standard_normal((H, Dk)).astype(f)
    s0 = rng.standard_normal((B, H, Dk, Dv)).astype(f)
    dout = rng.standard_normal((B, H, S, Dv)).astype(f)
    ds_last = rng.standard_normal((B, H, Dk, Dv)).astype(f)
    return r, k, v, w, u, s0, dout, ds_last


@pytest.mark.parametrize("case", CASES, ids=[str(c) for c in CASES])
def test_backward_plain_and_function_match_jax_vjp(case):
    with_s0, with_last = case[5], case[6]
    r, k, v, w, u, s0, dout, ds_last = _inputs(case, seed=CASES.index(case))
    if not with_s0:
        s0 = np.zeros_like(s0)
    if not with_last:
        ds_last = np.zeros_like(ds_last)
    _, vjp = jax.vjp(lambda *a: ref.rwkv6(*a), r, k, v, w, u, s0)
    want = [np.asarray(t) for t in vjp((dout, ds_last))]
    t = [torch.from_numpy(a) for a in (r, k, v, w, u, s0, dout, ds_last)]
    ts0 = t[5] if with_s0 else None
    tdl = t[7] if with_last else None

    got = rwkv6_backward_plain(*t[:5], ts0, t[6], tdl)
    assert (got[5] is None) == (not with_s0)
    for name, g, wnt in zip(NAMES, got, want):
        if g is not None:
            assert_close(g, wnt, 1e-5, 1e-5, f"plain {name}")

    leaves = [a.clone().requires_grad_() for a in t[:5]]
    if with_s0:
        leaves.append(ts0.clone().requires_grad_())
    before = (K.rwkv6.calls, K.rwkv6_backward.calls)
    out, s_last = rwkv6(*leaves)
    assert out.grad_fn is not None
    outs, cots = (([out, s_last], [t[6], tdl]) if with_last
                  else ([out], [t[6]]))
    got = torch.autograd.grad(outs, leaves, cots)
    for name, g, wnt in zip(NAMES, got, want):
        assert_close(g, wnt, 1e-5, 1e-5, f"function {name}")
    # One forward call and one backward call; the CPU launches nothing.
    assert (K.rwkv6.calls, K.rwkv6_backward.calls) == (before[0] + 1,
                                                       before[1] + 1)
    assert K.rwkv6.launches == 0 and K.rwkv6_backward.launches == 0


def test_bfloat16_inputs_follow_autograd_through_the_plain_forward():
    """bf16 r, k, v and dout (out's dtype), the model's decay with w = 0
    and 1 exactly: dr, dk, dv in bf16 within 2e-2 relative of autograd's
    through ``rwkv6_plain`` (the same float32 sums in another order, each
    rounded to bf16 once: at most a bf16 unit apart), dw, du and ds0 in
    float32 within rtol 1e-5 / atol 1e-5."""
    case = (2, 2, 67, 16, 8, True, True, "edge")
    r, k, v, w, u, s0, dout, ds_last = (torch.from_numpy(a) for a in
                                        _inputs(case, seed=9))
    r, k, v, dout = (a.to(torch.bfloat16) for a in (r, k, v, dout))
    leaves = [a.clone().requires_grad_() for a in (r, k, v, w, u, s0)]
    o, sl = rwkv6_plain(*leaves)
    want = torch.autograd.grad([o, sl], leaves, [dout, ds_last])
    plain = rwkv6_backward_plain(r, k, v, w, u, s0, dout, ds_last)
    leaves = [a.clone().requires_grad_() for a in (r, k, v, w, u, s0)]
    fn = torch.autograd.grad(list(rwkv6(*leaves)), leaves, [dout, ds_last])
    for what, got in (("plain", plain), ("function", fn)):
        for name, g, wnt in zip(NAMES, got, want):
            assert g.dtype == wnt.dtype, f"{what} {name}"
            if g.dtype == torch.bfloat16:
                diff = (g.float() - wnt.float()).abs()
                assert bool((diff <= 2 ** -7 * wnt.float().abs()
                             + 1e-5).all()), f"{what} {name}"
            else:
                assert_close(g, wnt, 1e-5, 1e-5, f"{what} {name}")
