"""The language-model kernels' plain versions against the JAX package.

``flash_attention_plain``, ``rglru_plain`` and ``rwkv6_plain``
(src/repro_torch/kernels/) against the JAX oracles (``ref.attention``,
``ref.rglru``, ``ref.rwkv6``) and against the Pallas kernels run in
interpret mode (``ops.*(..., use_pallas=True)``, chunked with the state
carried where S exceeds the chunk), on the same numpy inputs: every case
against the oracle, the float32 cases and the first bfloat16 case of each
kernel against the Pallas kernel too (interpret mode costs seconds a
case).
Tolerances (tests/lm_harness.py): float32 rtol 1e-5 / atol 1e-5;
bfloat16 outputs within 2 bf16 ulps.  On the CPU the wrappers run the
plain versions and count calls, never launches.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lm_harness import assert_bf16_close, assert_close
from repro.kernels import ops, ref
from repro.kernels.flash_attention import flash_attention_pallas
from repro_torch import kernels as K
from repro_torch.kernels.flash_attention import flash_attention_plain
from repro_torch.kernels.rglru import rglru_plain
from repro_torch.kernels.rwkv6 import rwkv6_plain

DT = {"f32": (np.float32, jnp.float32, torch.float32),
      "bf16": (np.float32, jnp.bfloat16, torch.bfloat16)}


def _pair(x: np.ndarray, dt: str):
    """The same values as a JAX array and a torch tensor of dtype ``dt``
    (bf16 rounded once, in JAX, and carried bit for bit)."""
    _, jdt, tdt = DT[dt]
    j = jnp.asarray(x, jnp.float32).astype(jdt)
    t = torch.from_numpy(np.array(j.astype(jnp.float32))).to(tdt)
    return j, t


def _check(port: torch.Tensor, want, dt: str, what: str):
    want = torch.from_numpy(np.array(jnp.asarray(want).astype(
        jnp.float32)))
    if dt == "bf16":
        assert port.dtype == torch.bfloat16, what
        assert_bf16_close(port, want, ulps=2, atol=1e-5, what=what)
    else:
        assert port.dtype == torch.float32, what
        assert_close(port, want, 1e-5, 1e-5, what)


# --------------------------------------------------------- flash attention
FLASH = [  # B, Hq, Hkv, Sq, Sk, D, causal, window
    (2, 4, 2, 32, 32, 32, True, None),      # GQA, causal
    (1, 4, 1, 29, 29, 16, True, 16),        # MQA, sliding window, ragged
    (1, 2, 2, 24, 24, 16, False, None),     # MHA, full
    (2, 4, 1, 8, 56, 32, True, 20),         # Sq != Sk, end-aligned, window
    (1, 16, 1, 1, 37, 16, False, None),     # decode-shaped: one query row
]


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("case", FLASH, ids=[f"flash{i}" for i in
                                              range(len(FLASH))])
def test_flash_attention_plain_matches_ref_and_pallas(case, dt):
    B, Hq, Hkv, Sq, Sk, D, causal, window = case
    rng = np.random.default_rng(sum(case[:6]))
    qj, qt = _pair(rng.standard_normal((B, Hq, Sq, D)) * D ** -0.25, dt)
    kj, kt = _pair(rng.standard_normal((B, Hkv, Sk, D)) * D ** -0.25, dt)
    vj, vt = _pair(rng.standard_normal((B, Hkv, Sk, D)), dt)
    port = flash_attention_plain(qt, kt, vt, causal=causal, window=window)
    _check(port, ref.attention(qj, kj, vj, causal=causal, window=window),
           dt, "vs ref.attention")
    if dt == "f32" or case == FLASH[0]:
        pallas = ops.flash_attention(qj, kj, vj, causal=causal,
                                     window=window, block_q=32, block_k=32,
                                     use_pallas=True)
        _check(port, pallas, dt, "vs flash_attention_pallas")


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_flash_attention_sk_valid_matches_the_pallas_kernel(dt):
    """sk_valid < Sk masks the padded keys and end-aligns the queries on
    the valid ones, as the Pallas kernel on padded inputs; sq_valid < Sq
    shifts the rows' positions the same way."""
    B, Hq, Hkv, Sq, Sk, D = 1, 2, 1, 32, 64, 16
    rng = np.random.default_rng(7)
    qj, qt = _pair(rng.standard_normal((B, Hq, Sq, D)) * 0.5, dt)
    kj, kt = _pair(rng.standard_normal((B, Hkv, Sk, D)) * 0.5, dt)
    vj, vt = _pair(rng.standard_normal((B, Hkv, Sk, D)), dt)
    subcases = ((32, 45, None), (20, 45, 12), (32, 64, 30))
    for sq_valid, sk_valid, window in subcases[:3 if dt == "f32" else 1]:
        port = flash_attention_plain(qt, kt, vt, causal=True, window=window,
                                     sq_valid=sq_valid, sk_valid=sk_valid)
        pallas = flash_attention_pallas(
            qj, kj, vj, causal=True, window=window, sq_valid=sq_valid,
            sk_valid=sk_valid, block_q=32, block_k=32, interpret=True)
        what = f"sq_valid {sq_valid} sk_valid {sk_valid} window {window}"
        _check(port[:, :, :sq_valid], pallas[:, :, :sq_valid], dt, what)
        want = ref.attention(qj[:, :, :sq_valid], kj[:, :, :sk_valid],
                             vj[:, :, :sk_valid], causal=True,
                             window=window)
        _check(port[:, :, :sq_valid], want, dt, what + " vs ref")


def test_flash_attention_row_without_keys_gives_zero():
    q = torch.ones((1, 1, 4, 16))
    k = torch.ones((1, 1, 4, 16))
    out = flash_attention_plain(q, k, k, causal=True, sq_valid=4,
                                sk_valid=2)
    # Rows 0 and 1 sit at positions -2 and -1: no key is visible.
    assert torch.equal(out[0, 0, :2], torch.zeros((2, 16)))
    assert torch.equal(out[0, 0, 2:], torch.ones((2, 16)))


# ------------------------------------------------------------------ RG-LRU
RGLRU = [(2, 40, 64, 16), (1, 1, 32, 16), (3, 33, 48, 8)]  # B, S, D, chunk


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("case", RGLRU, ids=["chunked", "decode", "ragged"])
def test_rglru_plain_matches_ref_and_pallas(case, dt):
    B, S, D, chunk = case
    rng = np.random.default_rng(S * D)
    la = -np.abs(rng.standard_normal((B, S, D))).astype(np.float32) * 0.3
    lj, lt = _pair(la, "f32")
    xj, xt = _pair(rng.standard_normal((B, S, D)), dt)
    hj, ht = _pair(rng.standard_normal((B, D)), "f32")
    h, h_last = rglru_plain(lt, xt, ht)
    want, want_last = ref.rglru(lj, xj, h0=hj)
    _check(h, want, dt, "h vs ref.rglru")
    assert_close(h_last, want_last, 1e-5, 1e-5, "h_last vs ref.rglru")
    if dt == "bf16" and case != RGLRU[0]:
        return
    pal, pal_last = ops.rglru(lj, xj, h0=hj, chunk=chunk, use_pallas=True)
    _check(h, pal, dt, "h vs rglru_pallas")
    assert_close(h_last, pal_last, 1e-5, 1e-5, "h_last vs rglru_pallas")


def test_rglru_carries_its_state_across_calls():
    """Two calls of 17 and 23 steps, the second from the first's h_last,
    give one call's 40 steps (the decode path's carry)."""
    rng = np.random.default_rng(3)
    la = torch.from_numpy(-np.abs(rng.standard_normal((2, 40, 32))
                                  ).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((2, 40, 32)).astype(
        np.float32))
    h, last = rglru_plain(la, x)
    h1, l1 = rglru_plain(la[:, :17], x[:, :17])
    h2, l2 = rglru_plain(la[:, 17:], x[:, 17:], l1)
    assert torch.equal(torch.cat([h1, h2], dim=1), h)
    assert torch.equal(l2, last)


# ------------------------------------------------------------------ RWKV-6
RWKV = [(2, 3, 40, 16, 16, 16), (1, 2, 1, 32, 32, 8),
        (1, 2, 21, 16, 8, 8)]  # B, H, S, Dk, Dv, chunk


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("case", RWKV, ids=["chunked", "decode", "dk-ne-dv"])
def test_rwkv6_plain_matches_ref_and_pallas(case, dt):
    """r, k, v in ``dt``; w, u and the state float32 (the model's mix)."""
    B, H, S, Dk, Dv, chunk = case
    rng = np.random.default_rng(S * Dk + Dv)
    rj, rt = _pair(rng.standard_normal((B, H, S, Dk)) * 0.5, dt)
    kj, kt = _pair(rng.standard_normal((B, H, S, Dk)) * 0.5, dt)
    vj, vt = _pair(rng.standard_normal((B, H, S, Dv)), dt)
    wj, wt = _pair(rng.random((B, H, S, Dk)) * 0.9 + 0.05, "f32")
    uj, ut = _pair(rng.standard_normal((H, Dk)), "f32")
    sj, st = _pair(rng.standard_normal((B, H, Dk, Dv)), "f32")
    out, s_last = rwkv6_plain(rt, kt, vt, wt, ut, st)
    want, want_s = ref.rwkv6(rj, kj, vj, wj, uj, s0=sj)
    _check(out, want, dt, "out vs ref.rwkv6")
    assert_close(s_last, want_s, 1e-5, 1e-5, "s_last vs ref.rwkv6")
    if dt == "bf16" and case != RWKV[0]:
        return
    pal, pal_s = ops.rwkv6(rj, kj, vj, wj, uj, s0=sj, chunk=chunk,
                           use_pallas=True)
    _check(out, pal, dt, "out vs rwkv6_pallas")
    assert_close(s_last, pal_s, 1e-5, 1e-5, "s_last vs rwkv6_pallas")


# ----------------------------------------------------------------- wrappers
def test_wrappers_run_plain_versions_on_cpu_and_count_no_launch():
    K.reset_launches()
    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.standard_normal((1, 2, 8, 16)).astype(
        np.float32))
    assert torch.equal(K.flash_attention(q, q, q, window=4),
                       flash_attention_plain(q, q, q, window=4))
    la = -q[0].abs()
    assert all(torch.equal(a, b) for a, b in zip(K.rglru(la, q[0]),
                                                 rglru_plain(la, q[0])))
    w = torch.full_like(q, 0.5)
    u = torch.zeros((2, 16))
    assert all(torch.equal(a, b) for a, b in zip(
        K.rwkv6(q, q, q, w, u), rwkv6_plain(q, q, q, w, u)))
    assert K.launch_counts() == {op: 0 for op in K.WRAPPERS}
    calls = K.call_counts()
    assert (calls["flash_attention"], calls["rglru"], calls["rwkv6"]) == (
        1, 1, 1)
    K.reset_launches()


def test_wrappers_refuse_devices_without_a_kernel():
    m = torch.zeros((1, 1, 4, 16), device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        K.flash_attention(m, m, m)
    with pytest.raises(ValueError, match="no kernel for device"):
        K.rglru(m[0], m[0])
    with pytest.raises(ValueError, match="no kernel for device"):
        K.rwkv6(m, m, m, m, torch.zeros((1, 16), device="meta"))
