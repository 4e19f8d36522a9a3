"""rglru's gradient (src/repro_torch/kernels/rglru.py) against the JAX
package.

``rglru_backward_plain`` (the backward kernel's plain version: the
explicit reverse scan in float32) and the ``rglru`` op under autograd
(``RGLRUFn``, whose CPU route is that plain backward) against
``jax.vjp`` of ``ref.rglru``, on the same numpy inputs and cotangents,
float32: h0 and dh_last given and absent, S = 1, S off the kernel's
64-step tiles (5, 70), a near 1 and log_a <= -20.  Tolerance: rtol 1e-5 /
atol 1e-5 (float32 sums in another order).  a = 1 exactly, where the
gradient of log_a is infinite, and bfloat16 x are held against autograd
through ``rglru_plain``.

Near a = 1 the gradient is ill-conditioned in a itself: b = sqrt(1 - a^2)
loses the bits that 1 - a^2 cancels, so one unit in the last place of
a = exp(log_a), or of a * a, moves dlog_a and dx by up to 1/(1 - a^2) of
it.  Two consequences for the reference:
- ``jax.vjp`` runs eagerly here.  Under ``jax.jit`` XLA fuses 1 - a * a
  into one multiply-add (a * a not rounded), and at log_a near -1e-4 the
  jitted vjp is 1e-3 (in relative terms) from the eager one, which rounds
  each operation as ``ref.rglru`` writes it, as the port does.
- XLA's exp and torch's exp round about one float32 input in ten
  differently; where they do, near a = 1, the eager vjp and torch's own
  autograd through ``rglru_plain`` are 1e-3 apart.  So the "near 1" draw
  keeps the log_a whose exp the two libraries round alike (redrawing the
  others, whose count is held to a band), which holds the backward's
  algebra near a = 1 to the tolerance.
The unfiltered "near 1" draw is held instead to a reference that no
library's float32 exp decides: autograd through ``rglru_plain`` in
float64, on the same float32 inputs, within a tolerance scaled by the
conditioning: rtol 1e-5 + 8 * 2**-24 / (1 - a^2), the largest of the
channel's steps up to t (h_{t-1} carries their rounding).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lm_harness import assert_close
from repro.kernels import ref
from repro_torch import kernels as K
from repro_torch.kernels.rglru import rglru, rglru_backward_plain, rglru_plain

CASES = [  # B, S, D, h0 given, dh_last given, log_a
    (2, 5, 8, True, True, "model"),
    (1, 1, 6, False, False, "model"),
    (2, 70, 5, True, False, "model"),
    (1, 70, 4, False, True, "near 1"),
    (2, 65, 3, True, True, "deep"),
]


def _draw(rng, shape, mode):
    u = rng.random(shape)
    return {"model": -0.5 * (1.0 - u), "near 1": -10.0 ** (-3.0 - 2.0 * u),
            "deep": -20.0 - 10.0 * u}[mode].astype(np.float32)


def _exp_differs(la):
    """Where XLA's float32 exp and torch's round ``la`` differently."""
    return np.asarray(jnp.exp(la)) != torch.exp(torch.from_numpy(la)).numpy()


def _log_a(rng, shape, mode):
    """"model": log_a in [-0.5, 0); "near 1": a within 1e-3 of 1
    (log_a in [-1e-3, -1e-5]), redrawn where XLA's and torch's exp round
    differently (module docstring; the first draw's share of those within
    2% to 25%); "deep": log_a in [-30, -20]."""
    la = _draw(rng, shape, mode)
    if mode == "near 1":
        off = _exp_differs(la)
        assert 0.02 * la.size <= off.sum() <= 0.25 * la.size, off.sum()
        for _ in range(20):
            if not off.any():
                break
            la[off] = _draw(rng, (int(off.sum()),), mode)
            off = _exp_differs(la)
        assert not off.any()
    return la


def _inputs(case, seed):
    B, S, D, _, _, mode = case
    rng = np.random.default_rng(seed)
    la = _log_a(rng, (B, S, D), mode)
    x, dh = (rng.standard_normal((B, S, D)).astype(np.float32)
             for _ in range(2))
    h0, dh_last = (rng.standard_normal((B, D)).astype(np.float32)
                   for _ in range(2))
    return la, x, h0, dh, dh_last


def _jax_grads(la, x, h0, dh, dh_last):
    _, vjp = jax.vjp(lambda p, q, r: ref.rglru(p, q, r), la, x, h0)
    return [np.asarray(t) for t in vjp((dh, dh_last))]


@pytest.mark.parametrize("case", CASES, ids=[str(c) for c in CASES])
def test_backward_plain_and_function_match_jax_vjp(case):
    with_h0, with_last = case[3], case[4]
    la, x, h0, dh, dh_last = _inputs(case, seed=CASES.index(case))
    if not with_h0:
        h0 = np.zeros_like(h0)
    if not with_last:
        dh_last = np.zeros_like(dh_last)
    want = _jax_grads(la, x, h0, dh, dh_last)
    tla, tx, th0, tdh, tdl = (torch.from_numpy(a)
                              for a in (la, x, h0, dh, dh_last))
    th0 = th0 if with_h0 else None
    tdl = tdl if with_last else None

    got = rglru_backward_plain(tla, tx, th0, tdh, tdl)
    assert (got[2] is None) == (not with_h0)
    for name, g, w in zip(("dlog_a", "dx", "dh0"), got, want):
        if g is not None:
            assert_close(g, w, 1e-5, 1e-5, f"plain {name}")

    leaves = [t.clone().requires_grad_() for t in (tla, tx)]
    if with_h0:
        leaves.append(th0.clone().requires_grad_())
    before = (K.rglru.calls, K.rglru_backward.calls)
    h, h_last = rglru(*leaves)
    assert h.grad_fn is not None
    outs, cots = ([h, h_last], [tdh, tdl]) if with_last else ([h], [tdh])
    got = torch.autograd.grad(outs, leaves, cots)
    for name, g, w in zip(("dlog_a", "dx", "dh0"), got, want):
        assert_close(g, w, 1e-5, 1e-5, f"function {name}")
    # One forward call and one backward call; the CPU launches nothing.
    assert (K.rglru.calls, K.rglru_backward.calls) == (before[0] + 1,
                                                       before[1] + 1)
    assert K.rglru.launches == 0 and K.rglru_backward.launches == 0


def _autograd_plain(la, x, h0, dh, dh_last):
    leaves = [t.clone().requires_grad_() for t in (la, x, h0)]
    h, h_last = rglru_plain(*leaves)
    return torch.autograd.grad([h, h_last], leaves, [dh, dh_last])


def _same_nonfinite_then_close(got, want, what):
    """Inf of the same sign and NaN at the same places; the finite values
    within rtol 1e-5 / atol 1e-5."""
    assert torch.equal(torch.isnan(got), torch.isnan(want)), what
    assert torch.equal(torch.where(torch.isinf(got), got, 0.0),
                       torch.where(torch.isinf(want), want, 0.0)), what
    fin = torch.isfinite(want)
    assert_close(got[fin], want[fin], 1e-5, 1e-5, what)


def test_a_equal_to_one_follows_autograd_through_clamp_and_sqrt():
    """log_a = 0 on a third of the elements: b = 0 there, so dlog_a is
    +-inf, or NaN where g * x = 0 (x = 0 on a few of them), as autograd
    through ``rglru_plain`` gives; dx and dh0 stay finite."""
    rng = np.random.default_rng(11)
    B, S, D = 2, 9, 6
    la = _log_a(rng, (B, S, D), "model")
    la[rng.random((B, S, D)) < 1 / 3] = 0.0
    x = rng.standard_normal((B, S, D)).astype(np.float32)
    x[(la == 0.0) & (rng.random((B, S, D)) < 0.2)] = 0.0
    tla, tx = torch.from_numpy(la), torch.from_numpy(x)
    th0, tdl = (torch.from_numpy(rng.standard_normal((B, D)).astype(
        np.float32)) for _ in range(2))
    tdh = torch.from_numpy(rng.standard_normal((B, S, D)).astype(
        np.float32))
    want = _autograd_plain(tla, tx, th0, tdh, tdl)
    assert bool(torch.isinf(want[0]).any()) and bool(
        torch.isnan(want[0]).any())
    plain = rglru_backward_plain(tla, tx, th0, tdh, tdl)
    leaves = [t.clone().requires_grad_() for t in (tla, tx, th0)]
    fn = torch.autograd.grad(list(rglru(*leaves)), leaves, [tdh, tdl])
    for what, got in (("plain", plain), ("function", fn)):
        _same_nonfinite_then_close(got[0], want[0], f"{what} dlog_a")
        for name, g, w in zip(("dx", "dh0"), got[1:], want[1:]):
            assert bool(torch.isfinite(g).all())
            assert_close(g, w, 1e-5, 1e-5, f"{what} {name}")


def test_bfloat16_x_follows_autograd_through_the_plain_forward():
    """bf16 x and dh (h's dtype): dx in bf16 equal to autograd's through
    ``rglru_plain`` (the same product, rounded once), dlog_a and dh0
    within rtol 1e-5 / atol 1e-5."""
    g = torch.Generator().manual_seed(3)
    B, S, D = 2, 67, 6
    la = -0.5 * torch.rand((B, S, D), generator=g)
    x = torch.randn((B, S, D), generator=g).to(torch.bfloat16)
    h0, dl = torch.randn((2, B, D), generator=g)
    dh = torch.randn((B, S, D), generator=g).to(torch.bfloat16)
    want = _autograd_plain(la, x, h0, dh, dl)
    plain = rglru_backward_plain(la, x, h0, dh, dl)
    leaves = [t.clone().requires_grad_() for t in (la, x, h0)]
    fn = torch.autograd.grad(list(rglru(*leaves)), leaves, [dh, dl])
    for what, got in (("plain", plain), ("function", fn)):
        assert got[1].dtype == torch.bfloat16
        assert torch.equal(got[1], want[1]), f"{what} dx"
        assert_close(got[0], want[0], 1e-5, 1e-5, f"{what} dlog_a")
        assert_close(got[2], want[2], 1e-5, 1e-5, f"{what} dh0")


def test_near_one_unfiltered_within_its_conditioning_of_float64():
    """The "near 1" draw as it comes, XLA's and torch's exp differing on
    some of it: the plain backward, the Function and JAX's eager vjp, each
    against autograd through ``rglru_plain`` in float64 on the same
    float32 inputs; |got - ref| <= 1e-5 + (1e-5 + 8 * 2**-24 * k) |ref|,
    k the largest 1 / (1 - a^2) of the channel's steps up to t (of all
    its steps for dh0)."""
    rng = np.random.default_rng(7)
    B, S, D = CASES[3][:3]       # the "near 1" case's shape
    la = _draw(rng, (B, S, D), "near 1")
    assert _exp_differs(la).any()
    x, dh = (rng.standard_normal((B, S, D)).astype(np.float32)
             for _ in range(2))
    h0, dh_last = (rng.standard_normal((B, D)).astype(np.float32)
                   for _ in range(2))
    t32 = [torch.from_numpy(a) for a in (la, x, h0, dh, dh_last)]
    ref64 = _autograd_plain(*(t.double() for t in t32))
    a = np.exp(la.astype(np.float64))
    kappa = np.maximum.accumulate(1.0 / (1.0 - a * a), axis=1)
    rtol = 1e-5 + 8 * 2.0 ** -24 * torch.from_numpy(kappa)   # [B, S, D]
    leaves = [t.clone().requires_grad_() for t in t32[:3]]
    candidates = {
        "plain": rglru_backward_plain(*t32),
        "function": torch.autograd.grad(list(rglru(*leaves)), leaves,
                                        t32[3:]),
        "jax": [torch.tensor(g) for g in _jax_grads(la, x, h0, dh,
                                                         dh_last)]}
    for what, got in candidates.items():
        for name, g, r in zip(("dlog_a", "dx", "dh0"), got, ref64):
            tol = rtol if g.dim() == 3 else rtol[:, -1]
            err = (g.double() - r).abs()
            share = err / (1e-5 + tol * r.abs())
            assert bool((share <= 1).all()), (
                f"{what} {name}: {float(share.max())} of its bound")
