"""The numerics of the redesigned rwkv6 and rglru kernels, settled on the CPU.

``csrc/rwkv6.cu`` serves bfloat16 prefills (S >= 64) with a chunked kernel
on the tensor cores; ``csrc/rglru.cu`` walks each channel as one chain fed
through a staged ring.  Neither runs here, so this file holds what they
stand on against the JAX oracles, on inputs made from a seed:

(a) ``rwkv6_plain`` against ``ref.rwkv6`` on decays drawn as the model
    draws them (w = exp(-exp(z)), z in [-6, 4], 1.9e-24 to 0.9975) with
    steps at w = 0 and w = 1 exactly, at S = L - 1, L, L + 1 and a ragged
    S: the yardstick the card compares against is itself right there.
(b) A float32 emulation of the chunked kernel's algebra, step for step:
    64-token chunks, 16-token sub-blocks, every decay factor a running
    product of w anchored at a sub-block boundary between the positions it
    joins, float32 operands split into three bfloat16 parts with float32
    accumulation (six part-products where both operands are split, three
    where one is exact), the state updated by Horner over the sub-blocks.
    Held against ``ref.rwkv6`` under the card's gate, so the numerics are
    settled before any card call.
(c) ``chip_smoke``'s new rglru and rwkv6 cases at reduced sizes, through
    the plain versions against ``ref.rglru`` / ``ref.rwkv6``.

Tolerances (tests/lm_harness.py, and chip_smoke.LMCheck on the card):
float32 rtol 1e-5 / atol 1e-5; bfloat16 within 2 bf16 ulps (values within
1e-5 of each other pass).  One exception, in (c): the RG-LRU chain near
a = 1 amplifies a one-ulp difference of a (XLA's exp and contractions
against torch's) by about 1 / (1 - a), so over 130 steps of log_a in
[-0.1, 0) the plain version meets ``ref.rglru`` within lm_harness's
whole-model tolerance (rtol 1e-4, atol 1e-4 of the largest magnitude; 2
bf16 ulps or that atol for h).  On the card the gate is stricter: the
kernel equals the plain version bit for bit.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import chip_smoke
from lm_harness import assert_bf16_close, assert_close, assert_scaled_close
from repro.kernels import ref
from repro_torch.kernels.rglru import rglru_plain
from repro_torch.kernels.rwkv6 import CHUNK, route, rwkv6_plain

L, SUB = 64, 16
#: (A's part, B's part) of the part-products kept where both operands are
#: split: down to 2^-18 of the product.
PRODUCTS = ((0, 0), (0, 1), (1, 0), (0, 2), (2, 0), (1, 1))


def _jax(t: torch.Tensor):
    """The same values as a JAX array (bfloat16 carried bit for bit)."""
    j = jnp.asarray(t.float().numpy())
    return j.astype(jnp.bfloat16) if t.dtype == torch.bfloat16 else j


def _torch(j) -> torch.Tensor:
    t = torch.from_numpy(np.array(j.astype(jnp.float32)))
    return t.to(torch.bfloat16) if j.dtype == jnp.bfloat16 else t


def rwkv_case(B, H, S, Dk, Dv, decay, dtype, seed):
    """chip_smoke's rwkv6 inputs on the CPU, from ``seed``."""
    g = torch.Generator().manual_seed(seed)
    s = dict(B=B, H=H, S=S, Dk=Dk, Dv=Dv, decay=decay)
    return chip_smoke.rwkv_inputs(s, dtype, torch.device("cpu"), g)[0]


def ref_rwkv6(r, k, v, w, u, s0):
    out, s_last = ref.rwkv6(*(_jax(t) for t in (r, k, v, w, u, s0)))
    return _torch(out), _torch(s_last)


def check_rwkv6(got, want, what):
    """The card's gate: out within 2 bf16 ulps (bfloat16) or rtol / atol
    1e-5 (float32), s_last rtol / atol 1e-5."""
    (out, s_last), (w_out, w_last) = got, want
    assert out.dtype == w_out.dtype and out.shape == w_out.shape, what
    if out.dtype == torch.bfloat16:
        assert_bf16_close(out, w_out, ulps=2, atol=1e-5, what=f"{what} out")
    else:
        assert_close(out, w_out, 1e-5, 1e-5, f"{what} out")
    assert_close(s_last, w_last, 1e-5, 1e-5, f"{what} s_last")


# ------------------------------------------------------------------ (a)
A_CASES = [(S, dt) for S in (L - 1, L, L + 1, 150)
           for dt in (torch.float32, torch.bfloat16)]


@pytest.mark.parametrize("S,dtype", A_CASES,
                         ids=[f"S{S}-{str(dt)[6:]}" for S, dt in A_CASES])
def test_rwkv6_plain_matches_ref_on_model_decays(S, dtype):
    args = rwkv_case(1, 2, S, 64, 64, "edge", dtype, seed=S)
    w = args[3]
    assert bool((w == 0).any()) and bool((w == 1).any())
    assert float(w[(w > 0) & (w < 1)].min()) < 1e-20
    check_rwkv6(rwkv6_plain(*args), ref_rwkv6(*args), f"plain S={S}")


# ------------------------------------------------------------------ (b)
def _split(x: torch.Tensor) -> list:
    """x = hi + mid + lo, three bfloat16 values (as float32)."""
    parts = []
    for _ in range(3):
        p = x.to(torch.bfloat16).float()
        parts.append(p)
        x = x - p
    return parts


def _mm_both(a, b):
    """a . b with both float32 operands split, six part-products."""
    pa, pb = _split(a), _split(b)
    return sum(pa[i] @ pb[j] for i, j in PRODUCTS)


def _mm_one(a, b):
    """a . b with a split and b exact in bfloat16: three part-products."""
    return sum(p @ b for p in _split(a))


def _prod(ws, like):
    out = torch.ones_like(like)
    for x in ws:
        out = out * x
    return out


def chunked_emulation(r, k, v, w, u, s0):
    """csrc/rwkv6.cu's chunked kernel, in float32 on the CPU: the same
    chunks, sub-blocks, anchors, splits and order of the state update
    (sums over k in another order than the tensor cores')."""
    B, H, S, Dk = r.shape
    r, k, v, w = (t.float() for t in (r, k, v, w))
    state = s0.float().clone()
    out = torch.empty(B, H, S, v.shape[-1])
    nb = L // SUB
    for c0 in range(0, S, L):
        n = min(L, S - c0)
        pad = (0, 0, 0, L - n)
        rc, kc, vc = (F.pad(t[:, :, c0:c0 + n], pad) for t in (r, k, v))
        wc = F.pad(w[:, :, c0:c0 + n], pad, value=1.0)  # identity steps
        # (1) forward r * f, backward K-hat = k * g, sub-block products W.
        RF, Kh, W = torch.empty_like(rc), torch.empty_like(kc), []
        for i in range(nb):
            pf = torch.ones(B, H, Dk)
            pb = torch.ones(B, H, Dk)
            for j in range(SUB):
                tf, tb = i * SUB + j, i * SUB + SUB - 1 - j
                RF[:, :, tf] = rc[:, :, tf] * pf
                Kh[:, :, tb] = kc[:, :, tb] * pb
                pf = pf * wc[:, :, tf]
                pb = pb * wc[:, :, tb]
            W.append(pf)
        Kh = sum(_split(Kh))      # the kernel keeps K-hat as three parts

        def rows(i, scale):
            return RF[:, :, i * SUB:(i + 1) * SUB] * scale[:, :, None]

        # (2a) out = (r * d) . S0, d = prod_{m < i} W_m * f.
        o = _mm_both(torch.cat([rows(i, _prod(W[:i], W[0]))
                                for i in range(nb)], 2), state)
        # (2b) A off the diagonal: (r * f * prod_{j < m < i} W_m) . K-hat.
        A = torch.zeros(B, H, L, L)
        for j in range(nb - 1):
            khj = Kh[:, :, j * SUB:(j + 1) * SUB].transpose(-1, -2)
            for i in range(j + 1, nb):
                A[..., i * SUB:(i + 1) * SUB, j * SUB:(j + 1) * SUB] = \
                    _mm_both(rows(i, _prod(W[j + 1:i], W[0])), khj)
        # (2c) the diagonal sub-blocks, the factor accumulated step by step.
        for i in range(nb):
            for s in range(i * SUB, (i + 1) * SUB):
                A[..., s, s] = (rc[:, :, s] * u * kc[:, :, s]).sum(-1)
                f = torch.ones(B, H, Dk)
                for t in range(s + 1, (i + 1) * SUB):
                    A[..., t, s] = (rc[:, :, t] * (kc[:, :, s] * f)).sum(-1)
                    f = f * wc[:, :, t]
        # (3a) out += A . V; (2d) the state by Horner over the sub-blocks.
        o = o + _mm_one(A, vc)
        for j in range(nb):
            blk = slice(j * SUB, (j + 1) * SUB)
            state = W[j][..., None] * state + _mm_one(
                Kh[:, :, blk].transpose(-1, -2), vc[:, :, blk])
        out[:, :, c0:c0 + n] = o[:, :, :n]
    return out.to(torch.bfloat16), state


B_CASES = [
    ("S=L", dict(S=L, Dk=64, Dv=64, decay="model")),
    ("S=L+1", dict(S=L + 1, Dk=64, Dv=64, decay="model")),
    ("ragged S", dict(S=150, Dk=64, Dv=64, decay="model")),
    ("w 0 and 1", dict(S=200, Dk=64, Dv=64, decay="edge")),
    ("Dk16", dict(S=100, Dk=16, Dv=16, decay="model")),
    ("Dk32 Dv48", dict(S=130, Dk=32, Dv=48, decay="edge")),
    ("Dk128", dict(S=70, Dk=128, Dv=128, decay="model")),
]


@pytest.mark.parametrize("case", B_CASES, ids=[c[0] for c in B_CASES])
def test_chunk_algebra_meets_the_card_gate_against_ref(case):
    label, s = case
    args = rwkv_case(1, 2, dtype=torch.bfloat16, seed=len(label), **s)
    assert route(torch.bfloat16, s["S"]) == "chunked"
    check_rwkv6(chunked_emulation(*args), ref_rwkv6(*args),
                f"emulation {label}")


def test_rwkv6_route_by_dtype_and_length():
    assert route(torch.bfloat16, CHUNK - 1) == "recurrent"
    assert route(torch.bfloat16, CHUNK) == "chunked"
    assert route(torch.bfloat16, 1) == "recurrent"
    assert route(torch.float32, 3072) == "recurrent"


# ------------------------------------------------------------------ (c)
def _reduced(cases, **caps):
    return [(label, {k: min(v, caps[k]) if k in caps else v
                     for k, v in s.items()}, dt) for label, s, dt in cases]


#: The cases added with the redesign, cut to CPU size: S and D keep
#: their raggedness against the 64-step / 64-channel tiles.
RGLRU_NEW = _reduced(chip_smoke.RGLRU_CASES[4:], B=2, S=130) + [
    ("D=4104 cut", dict(B=1, S=70, D=72), torch.bfloat16)]
RWKV_NEW = _reduced(chip_smoke.RWKV_CASES[6:], B=1, H=2, S=150)


@pytest.mark.parametrize("case", RGLRU_NEW, ids=[c[0] for c in RGLRU_NEW])
def test_rglru_plain_matches_ref_on_card_cases(case):
    label, s, dtype = case
    g = torch.Generator().manual_seed(7)
    log_a, x, h0 = chip_smoke.rglru_inputs(s, dtype, torch.device("cpu"),
                                           g)[0]
    h, h_last = rglru_plain(log_a, x, h0)
    want_h, want_last = ref.rglru(_jax(log_a), _jax(x), _jax(h0))
    want_h, want_last = _torch(want_h), _torch(want_last)
    assert h.dtype == dtype and h.shape == x.shape
    assert_bf16_close(h, want_h, ulps=2,
                      atol=1e-4 * float(want_h.float().abs().max()),
                      what=f"{label} h")
    assert_scaled_close(h_last, want_last, 1e-4, 1e-4, f"{label} h_last")


@pytest.mark.parametrize("case", RWKV_NEW, ids=[c[0] for c in RWKV_NEW])
def test_rwkv6_plain_matches_ref_on_card_cases(case):
    label, s, dtype = case
    g = torch.Generator().manual_seed(9)
    args = chip_smoke.rwkv_inputs(s, dtype, torch.device("cpu"), g)[0]
    check_rwkv6(rwkv6_plain(*args), ref_rwkv6(*args), label)


def test_new_card_cases_reach_both_rwkv6_kernels_and_the_rglru_edges():
    """The rwkv6 cases straddle the chunk length in bfloat16 and cover
    every key width on the chunked kernel; the rglru cases hold a = 1,
    a below 2e-9, ragged tiles and a block with fewer channels than 64."""
    bf = [s for _, s, dt in chip_smoke.RWKV_CASES if dt == torch.bfloat16]
    assert {L - 1, L, L + 1, 1000} <= {s["S"] for s in bf}
    assert {16, 32, 64, 128} <= {s["Dk"] for s in bf if s["S"] >= L}
    assert {"model", "edge"} <= {s.get("decay") for s in bf}
    rg = [s for _, s, _ in chip_smoke.RGLRU_CASES]
    assert {"zero", "deep"} <= {s.get("log_a") for s in rg}
    assert any(s["S"] % 64 for s in rg if s["S"] > 64)
    assert any(s["D"] % 64 and s["D"] % 8 == 0 for s in rg)
    assert any(s["D"] % 8 for s in rg if s["D"] > 64)
    assert any(s["B"] * s["D"] < 64 for s in rg)
