"""The numerics of rwkv6_backward's chunked route, settled on the CPU.

``csrc/rwkv6_bwd.cu`` serves bfloat16 backwards with S >= 64 split in
time: two boundary chains over the 64-token chunks on the tensor cores
(S_end = diag(W) S0 + (k * e)^T V forward, dS_start = diag(W) dS_end +
(r * d)^T dOut backward, by Horner over 16-token sub-blocks with running
products of w anchored at a sub-block boundary and the float32 operand
split into three bf16 parts against the exact bf16 V or dOut: three
part-products; no product of the route takes two split operands), then a
pass over each chunk that walks its 64 tokens exactly from the chunk's S0
and dS_end, rounding every multiply and add as the plain version does
(the recompute of an interval from its checkpoint repeats the same
operations, so it gives the states of one walk), and du's sum over b and
the chunks.  None of it runs here, so this file emulates it step for step
in float32 and holds the emulation, on numpy inputs made from a seed,
against ``rwkv6_backward_plain`` and against ``jax.vjp`` of ``ref.rwkv6``.

Tolerances: dw, du and ds0 (float32) within relative L2 1e-4, the card's
float32 gate (chip_smoke.RECURRENT_BWD_RTOL): the chains' states differ
from a sequential walk's by float32 rounding; dr, dk and dv (bfloat16)
within 2 bf16 ulps, where both sides round float32 values that agree to
float32 precision, values within 1e-5 of the largest magnitude of each
other passing too (near 0 one float32 rounding step spans many bf16
units).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lm_harness import assert_bf16_close
from repro.kernels import ref
from repro_torch.kernels.rwkv6 import CHUNK, route, rwkv6_backward_plain

L, SUB = CHUNK, 16
NAMES = ("dr", "dk", "dv", "dw", "du", "ds0")
F32_RTOL = 1e-4
#: (label, B, H, S, Dk, Dv, decay, s0 given, ds_last given)
CASES = [
    ("S=64", 1, 2, 64, 64, 64, "model", True, True),
    ("S=65 edge", 2, 1, 65, 64, 64, "edge", True, True),
    ("S=128 1e-24", 1, 2, 128, 64, 64, "1e-24", True, True),
    ("S=200 no s0", 1, 2, 200, 64, 64, "model", False, True),
    ("S=200 edge no ds_last", 1, 2, 200, 64, 64, "edge", True, False),
    ("Dk32 Dv48", 1, 2, 130, 32, 48, "model", True, True),
    ("Dk32 Dv48 S=65 edge neither", 1, 2, 65, 32, 48, "edge", False, False),
]


def _decay(rng, shape, mode):
    """"model": w = exp(-exp(z)), z in [-6, 4] (models/recurrent.py's
    range: 1.9e-24 to 0.9975); "edge": that draw with a tenth of the steps
    at w = 0 and a tenth at w = 1 exactly; "1e-24": a third of the steps
    at exp(-exp(4)) = 1.9e-24 and a third at 1 exactly."""
    w = np.exp(-np.exp(rng.random(shape) * 10.0 - 6.0))
    pick = rng.random(shape)
    if mode == "edge":
        w = np.where(pick < 0.1, 0.0, np.where(pick > 0.9, 1.0, w))
    elif mode == "1e-24":
        w = np.where(pick < 1 / 3, np.exp(-np.exp(4.0)),
                     np.where(pick > 2 / 3, 1.0, w))
    return w.astype(np.float32)


def _inputs(case, seed):
    """(r, k, v bf16, w, u float32, s0 float32 or None, dout bf16,
    ds_last float32 or None) as torch tensors, from numpy."""
    _, B, H, S, Dk, Dv, decay, with_s0, with_last = case
    rng = np.random.default_rng(seed)

    def normal(shape, scale=1.0):
        return torch.from_numpy((scale * rng.standard_normal(shape))
                                .astype(np.float32))
    r = normal((B, H, S, Dk), 0.5).to(torch.bfloat16)
    k = normal((B, H, S, Dk), 0.5).to(torch.bfloat16)
    v = normal((B, H, S, Dv)).to(torch.bfloat16)
    w = torch.from_numpy(_decay(rng, (B, H, S, Dk), decay))
    u = normal((H, Dk))
    s0 = normal((B, H, Dk, Dv))
    dout = normal((B, H, S, Dv)).to(torch.bfloat16)
    ds_last = normal((B, H, Dk, Dv))
    return (r, k, v, w, u, s0 if with_s0 else None, dout,
            ds_last if with_last else None)


# ----------------------------------------------------------- the emulation
def _split(x: torch.Tensor) -> list:
    """x = hi + mid + lo, three bfloat16 values (as float32)."""
    parts = []
    for _ in range(3):
        p = x.to(torch.bfloat16).float()
        parts.append(p)
        x = x - p
    return parts


def _mm_one(a, b):
    """a . b with a split and b exact in bfloat16: three part-products."""
    return sum(p @ b for p in _split(a))


def _pad(t, n, value=0.0):
    return torch.nn.functional.pad(t, (0, 0, 0, n - t.shape[2]), value=value)


def chains(k, v, w, r, dout, s0, ds_last):
    """rwkv6_bwd_chain_kernel in float32: S0 of every chunk (forward, X =
    k, Y = v, running products from each token to its sub-block's end) and
    dS_end of every chunk (backward, X = r, Y = dout, from its sub-block's
    start to the token), Horner over the 16-token sub-blocks; and ds0 =
    dS_start of chunk 0.  Steps past S are identity steps (w = 1, X = 0).
    """
    B, H, S, Dk = k.shape
    Dv = v.shape[-1]
    NC = -(-S // L)
    k, v, r, dout = (_pad(t.float(), NC * L) for t in (k, v, r, dout))
    w = _pad(w, NC * L, 1.0)
    zeros = torch.zeros(B, H, Dk, Dv)

    def take(state, X, Y, c, back):
        for j in (range(L // SUB - 1, -1, -1) if back else range(L // SUB)):
            blk = slice(c * L + j * SUB, c * L + (j + 1) * SUB)
            Xb, Wb = X[:, :, blk], w[:, :, blk]
            Xh = torch.empty_like(Xb)
            p = torch.ones(B, H, Dk)
            for jj in range(SUB):
                t = jj if back else SUB - 1 - jj
                Xh[:, :, t] = Xb[:, :, t] * p
                p = p * Wb[:, :, t]
            state = p[..., None] * state + _mm_one(Xh.transpose(-1, -2),
                                                   Y[:, :, blk])
        return state

    S0, state = [], zeros if s0 is None else s0.clone()
    for c in range(NC):
        S0.append(state)
        if c < NC - 1:
            state = take(state, k, v, c, back=False)
    dE, dstate = [None] * NC, zeros if ds_last is None else ds_last.clone()
    for c in range(NC - 1, -1, -1):
        dE[c] = dstate
        dstate = take(dstate, r, dout, c, back=True)
    return S0, dE, dstate


def chunked_emulation(r, k, v, w, u, s0, dout, ds_last):
    """The chunked route in float32: the chains, then every chunk's exact
    walk from its S0 and dS_end (the plain version's rounding, sums over a
    row or column in another order than the kernel's), the u terms, and
    du's sum over b and the chunks in (b, chunk) order."""
    B, H, S, Dk = r.shape
    Dv = v.shape[-1]
    S0, dE, ds0 = chains(k, v, w, r, dout, s0, ds_last)
    rs, ks, vs, ds_ = (t.float() for t in (r, k, v, dout))
    dr = torch.empty(B, H, S, Dk)
    dk, dw = torch.empty_like(dr), torch.empty_like(dr)
    dv = torch.empty(B, H, S, Dv)
    for c, t0 in enumerate(range(0, S, L)):
        n = min(L, S - t0)
        st, prev = S0[c], []
        for t in range(t0, t0 + n):
            prev.append(st)
            st = (w[:, :, t, :, None] * st
                  + ks[:, :, t, :, None] * vs[:, :, t, None, :])
        ds = dE[c]
        for t in range(t0 + n - 1, t0 - 1, -1):
            p = prev[t - t0]
            dk[:, :, t] = (ds * vs[:, :, t, None, :]).sum(-1)
            dw[:, :, t] = (ds * p).sum(-1)
            dr[:, :, t] = (p * ds_[:, :, t, None, :]).sum(-1)
            dv[:, :, t] = (ds * ks[:, :, t, :, None]).sum(-2)
            ds = (w[:, :, t, :, None] * ds
                  + rs[:, :, t, :, None] * ds_[:, :, t, None, :])
    uu = u[None, :, None, :]
    vd = (vs * ds_).sum(-1, keepdim=True)
    dk = dk + (uu * rs) * vd
    dr = dr + (uu * ks) * vd
    dv = dv + (rs * uu * ks).sum(-1, keepdim=True) * ds_
    du = torch.zeros(H, Dk)
    for b in range(B):
        for t0 in range(0, S, L):
            du = du + (rs[b, :, t0:t0 + L] * ks[b, :, t0:t0 + L]
                       * vd[b, :, t0:t0 + L]).sum(1)
    return (dr.to(torch.bfloat16), dk.to(torch.bfloat16),
            dv.to(torch.bfloat16), dw, du, None if s0 is None else ds0)


# --------------------------------------------------------------- the refs
def _jax(t: torch.Tensor):
    j = jnp.asarray(t.float().numpy())
    return j.astype(jnp.bfloat16) if t.dtype == torch.bfloat16 else j


def jax_vjp(r, k, v, w, u, s0, dout, ds_last):
    """jax.vjp of ref.rwkv6 (eager), zeros for an absent s0 or ds_last;
    ds0 None without s0."""
    B, H, _, Dk = r.shape
    Dv = v.shape[-1]
    zeros = jnp.zeros((B, H, Dk, Dv), jnp.float32)
    prim = [_jax(t) for t in (r, k, v, w, u)] + [
        zeros if s0 is None else _jax(s0)]
    _, vjp = jax.vjp(lambda *a: ref.rwkv6(*a), *prim)
    grads = vjp((_jax(dout), zeros if ds_last is None else _jax(ds_last)))
    out = []
    for g in grads:
        t = torch.from_numpy(np.array(g.astype(jnp.float32)))
        out.append(t.to(torch.bfloat16) if g.dtype == jnp.bfloat16 else t)
    if s0 is None:
        out[5] = None
    return out


def rel_l2(a, b) -> float:
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm().clamp_min(1e-300))


def check(got, want, what):
    for name, g, wnt in zip(NAMES, got, want):
        assert (g is None) == (wnt is None), f"{what} {name}"
        if g is None:
            continue
        assert g.dtype == wnt.dtype and g.shape == wnt.shape, f"{what} {name}"
        assert bool(torch.isfinite(g.float()).all()), f"{what} {name}"
        if g.dtype == torch.bfloat16:
            scale = float(wnt.float().abs().max())
            assert_bf16_close(g, wnt, ulps=2, atol=1e-5 * scale,
                              what=f"{what} {name}")
        else:
            err = rel_l2(g, wnt)
            assert err <= F32_RTOL, f"{what} {name}: relative L2 {err}"


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_chunked_algebra_meets_the_card_gate(case):
    args = _inputs(case, seed=CASES.index(case))
    assert route(torch.bfloat16, case[3]) == "chunked"
    got = chunked_emulation(*args)
    check(got, rwkv6_backward_plain(*args), f"{case[0]} vs plain")
    check(got, jax_vjp(*args), f"{case[0]} vs jax.vjp")


def test_edge_decays_reach_zero_one_and_1e24():
    for mode in ("edge", "1e-24"):
        w = _decay(np.random.default_rng(0), (2, 64, 64), mode)
        assert (w == 1).any() and w.min() < 1e-20
        assert mode == "1e-24" or (w == 0).any()


def test_backward_route_by_dtype_and_length():
    """The backward takes the forward's route: bfloat16 from CHUNK tokens
    on splits in time; float32, and S = 63, keep the recurrent kernel."""
    assert route(torch.bfloat16, CHUNK) == "chunked"
    assert route(torch.bfloat16, 4097) == "chunked"
    assert route(torch.bfloat16, CHUNK - 1) == "recurrent"
    assert route(torch.bfloat16, 1) == "recurrent"
    assert route(torch.float32, 4096) == "recurrent"
    assert route(torch.float32, CHUNK - 1) == "recurrent"
