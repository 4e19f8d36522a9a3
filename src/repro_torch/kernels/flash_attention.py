"""Masked softmax attention: causal, sliding window, GQA, end-aligned;
its forward with the row log-sum-exp and its backward.

Replaces the TPU kernel ``flash_attention_pallas``
(src/repro/kernels/flash_attention.py); the semantics are the JAX oracle
``ref.attention`` with the Pallas kernel's ``sk_valid`` masking and end
alignment.  q is [B, Hq, Sq, D], k and v [B, Hkv, Sk, D] with
Hq % Hkv == 0; query head h reads kv head ``h // (Hq // Hkv)``.  Query row
i sits at absolute position ``i + sk_valid - sq_valid``; key j is visible
to it when ``j < sk_valid``, ``j <= pos`` (causal) and
``j > pos - window`` (window).  Scores are ``q.k * scale`` in float32; the
output is the softmax-weighted sum of v in float32, cast to q's dtype.  A
row that sees no key gives 0, as the Pallas kernel does.

The model's self-attention (``models/attention._flash``) runs it with q
already scaled and ``scale=1.0``.

CUDA tensors launch ``csrc/flash_attention.cu``, whose kernel is chosen
by dtype.  bfloat16: the tensor cores through ``wgmma``, one block of two
warpgroups per 128 query rows of one head (64 rows a warpgroup), Q in
shared memory once, 64-key K/V tiles through a two-stage ``cp.async``
ring in the 128-byte-swizzled layout ``wgmma`` reads, scores, online
softmax and output in float32 registers, P split into bf16 hi + lo for
P.V; 193 KB of shared memory at D = 256 (head widths 16 and 32 padded to
64).  float32: scalar FMAs, one block of 256 threads per 64 query rows.
Both skip key tiles outside the causal band or the window whole.  CPU
tensors take ``flash_attention_plain``.

Training: when grad is enabled and q, k or v requires it, ``flash_attention``
goes through ``FlashAttentionFn``: its forward is the same launch writing
also the float32 log-sum-exp of each row (``lse`` [B, Hq, Sq], -inf for a
row that sees no key); its backward is ``flash_attention_backward``, which
launches ``csrc/flash_attention_bwd.cu`` (a kernel of the port's own: the
JAX package differentiates its jnp attention and has no backward kernel)
and on the CPU takes ``flash_attention_backward_plain``.  Both recompute P
from ``lse``: ``Di = rowsum(dO * O)``, ``dS = P * (dO.V^T - Di)``,
``dQ = scale dS.K``, ``dK = scale dS^T.Q`` and ``dV = P^T.dO`` summed over
the query heads of each kv head, all accumulated in float32, with no float
atomics (a call's bits repeat).  The kernel is chosen by
``tensor_core_backward``: bfloat16 (the trained dtype) runs every product
on the tensor cores through ``wgmma`` (a dK/dV pass per 128 keys of one
query head, float32 partials summed over the query heads of a kv head in
head order, and a dQ pass per 128 rows; at D 256 per 64 keys or rows,
the head's columns split between the two warpgroups; P and dS rounded to
bf16 once for the A operand); float32 keeps scalar float32 FMAs.  Check
it on the card with ``python3 chip_smoke.py`` (its
``flash_backward_phase``) or ``python -m pytest -q tests/test_torch_cuda.py
-k backward``.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIG = {"repro_flash_attention": [_P] * 5 + [_I] * 6 + [_I, _I, _I]
        + [ctypes.c_float, _I, _I, _I, _P]}
_BWD_SIG = {"repro_flash_attention_bwd": [_P] * 10 + [_I] * 6 + [_I, _I, _I]
            + [ctypes.c_float, _I, _I, _I, _P]}

NEG_INF = -1e30
#: Head widths the kernel is compiled for.
HEAD_DIMS = (16, 32, 64, 128, 256)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def tensor_core_backward(dtype: torch.dtype, D: int) -> bool:
    """Whether the backward runs on the tensor cores (bf16, every head
    width of HEAD_DIMS) rather than on scalar FMAs (float32)."""
    return dtype == torch.bfloat16 and D in HEAD_DIMS


def bwd_scratch_numel(q_shape, k_shape, dtype: torch.dtype) -> int:
    """float32 elements of the backward's scratch: Di of every row, then,
    on the tensor-core route with Hq > Hkv, from the next multiple of 4,
    the dK and dV partials of every query head (2 x [B, Hq, Sk, D]), as
    csrc/flash_attention_bwd.cu lays them out."""
    B, Hq, Sq, D = q_shape
    Hkv, Sk = k_shape[1], k_shape[2]
    n = B * Hq * Sq
    if tensor_core_backward(dtype, D) and Hq > Hkv:
        n = -(-n // 4) * 4 + 2 * B * Hq * Sk * D
    return n


def _valid(Sq: int, Sk: int, sq_valid, sk_valid) -> tuple[int, int]:
    sq_valid = Sq if sq_valid is None else int(sq_valid)
    sk_valid = Sk if sk_valid is None else int(sk_valid)
    if not (0 < sq_valid <= Sq and 0 <= sk_valid <= Sk):
        raise ValueError(f"need 0 < sq_valid <= {Sq} and 0 <= sk_valid <= "
                         f"{Sk}, got {sq_valid}, {sk_valid}")
    return sq_valid, sk_valid


def attention_mask(Sq: int, Sk: int, *, causal: bool, window: Optional[int],
                   sq_valid: int, sk_valid: int,
                   device=None) -> torch.Tensor:
    """bool[Sq, Sk]: which keys each query row sees."""
    qi = torch.arange(Sq, device=device)[:, None] + (sk_valid - sq_valid)
    ki = torch.arange(Sk, device=device)[None, :]
    mask = ki < sk_valid
    if causal:
        mask = mask & (ki <= qi)
    if window is not None:
        mask = mask & (ki > qi - window)
    return mask


def flash_attention_plain(q, k, v, *, causal: bool = True,
                          window: Optional[int] = None,
                          scale: Optional[float] = None,
                          sq_valid: Optional[int] = None,
                          sk_valid: Optional[int] = None,
                          with_lse: bool = False):
    """Plain PyTorch version: ``ref.attention``'s float32 (float64 for
    float64 q) masked softmax over the whole score matrix; rows that see no key give 0.
    ``with_lse`` returns (out, lse float32 [B, Hq, Sq], -inf for a row
    that sees no key)."""
    B, Hq, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    sq_valid, sk_valid = _valid(Sq, Sk, sq_valid, sk_valid)
    rep = Hq // Hkv
    ft = torch.promote_types(q.dtype, torch.float32)   # float64 stays
    kf, vf = k.to(ft), v.to(ft)
    if rep > 1:
        kf = kf.repeat_interleave(rep, dim=1)
        vf = vf.repeat_interleave(rep, dim=1)
    s = scale if scale is not None else 1.0 / (D ** 0.5)
    logits = torch.einsum("bhqd,bhkd->bhqk", q.to(ft), kf) * s
    mask = attention_mask(Sq, Sk, causal=causal, window=window,
                          sq_valid=sq_valid, sk_valid=sk_valid,
                          device=q.device)
    p = torch.softmax(torch.where(mask, logits, NEG_INF), dim=-1)
    p = torch.where(mask.any(dim=-1, keepdim=True), p, 0.0)
    out = torch.einsum("bhqk,bhkd->bhqd", p, vf).to(q.dtype)
    if not with_lse:
        return out
    return out, torch.logsumexp(torch.where(mask, logits, -torch.inf),
                                dim=-1)


def flash_attention_backward_plain(q, k, v, o, lse, do, *,
                                   causal: bool = True,
                                   window: Optional[int] = None,
                                   scale: Optional[float] = None,
                                   sq_valid: Optional[int] = None,
                                   sk_valid: Optional[int] = None):
    """Plain PyTorch version of the backward, by its explicit formulas in
    float32: P = exp(q.k scale - lse) on visible pairs, Di = rowsum(dO *
    O), dS = P * (dO.V^T - Di); (dq, dk, dv) in q's dtype, dk and dv
    summed over the query heads of each kv head."""
    B, Hq, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    sq_valid, sk_valid = _valid(Sq, Sk, sq_valid, sk_valid)
    rep = Hq // Hkv
    s = scale if scale is not None else 1.0 / (D ** 0.5)
    qf, of, dof = q.float(), o.float(), do.float()
    kf = k.float().repeat_interleave(rep, dim=1)
    vf = v.float().repeat_interleave(rep, dim=1)
    mask = attention_mask(Sq, Sk, causal=causal, window=window,
                          sq_valid=sq_valid, sk_valid=sk_valid,
                          device=q.device)
    logits = torch.einsum("bhqd,bhkd->bhqk", qf, kf) * s
    p = torch.where(mask, torch.exp(logits - lse.float()[..., None]), 0.0)
    di = (dof * of).sum(dim=-1, keepdim=True)
    ds = p * (torch.einsum("bhqd,bhkd->bhqk", dof, vf) - di)
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kf) * s
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, qf) * s
    dv = torch.einsum("bhqk,bhqd->bhkd", p, dof)
    dk = dk.reshape(B, Hkv, rep, Sk, D).sum(dim=2)
    dv = dv.reshape(B, Hkv, rep, Sk, D).sum(dim=2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _checked(q, k, v, window, sq_valid, sk_valid):
    """The launch device and (sq_valid, sk_valid), after the checks that
    both kernels share."""
    dev = build.launch_device(q)
    B, Hq, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    if q.dtype not in DTYPE_CODES:
        raise TypeError(f"flash_attention takes float32 or bfloat16, got "
                        f"{q.dtype}")
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head width {D} not in "
                         f"{HEAD_DIMS}")
    if Hkv < 1 or Hq % Hkv:
        raise ValueError(f"flash_attention: {Hq} query heads over {Hkv} kv "
                         f"heads")
    if window is not None and window < 1:
        raise ValueError(f"flash_attention: window {window} < 1")
    sq_valid, sk_valid = _valid(Sq, Sk, sq_valid, sk_valid)
    build.check("q", q, q.dtype, (B, Hq, Sq, D), dev)
    build.check("k", k, q.dtype, (B, Hkv, Sk, D), dev)
    build.check("v", v, q.dtype, (B, Hkv, Sk, D), dev)
    return dev, sq_valid, sk_valid


def flash_attention_forward(q, k, v, *, causal, window, scale, sq_valid,
                            sk_valid, with_lse: bool):
    """The forward on q's device: out, or (out, lse) with ``with_lse``.
    The launch behind ``flash_attention`` and ``FlashAttentionFn``: it
    counts launches, the op counts calls."""
    kw = dict(causal=causal, window=window, scale=scale, sq_valid=sq_valid,
              sk_valid=sk_valid)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, with_lse=with_lse, **kw)
    dev, sq_valid, sk_valid = _checked(q, k, v, window, sq_valid, sk_valid)
    B, Hq, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    if q.dtype == torch.bfloat16:
        for name, t in (("q", q), ("k", k), ("v", v)):
            if t.data_ptr() % 16:
                raise ValueError(f"flash_attention: {name} must start on a "
                                 f"16-byte boundary (cp.async rows)")
    out = torch.empty_like(q)
    lse = (torch.empty((B, Hq, Sq), dtype=torch.float32, device=dev)
           if with_lse else None)
    s = scale if scale is not None else 1.0 / (D ** 0.5)
    lib = build.load("flash_attention", _SIG)
    with torch.cuda.device(dev):
        rc = lib.repro_flash_attention(
            build.ptr(q), build.ptr(k), build.ptr(v), build.ptr(out),
            build.ptr(lse), B, Hq, Hkv, Sq, Sk, D, int(causal),
            int(window is not None), int(window or 0), ctypes.c_float(s),
            sq_valid, sk_valid, DTYPE_CODES[q.dtype], build.stream(dev))
    build.raise_on_error("flash_attention", rc)
    flash_attention.launches += 1
    return (out, lse) if with_lse else out


class FlashAttentionFn(torch.autograd.Function):
    """``flash_attention`` under autograd: the forward saves q, k, v, the
    output and its row log-sum-exp; the backward is
    ``flash_attention_backward``."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, scale, sq_valid, sk_valid):
        kw = dict(causal=causal, window=window, scale=scale,
                  sq_valid=sq_valid, sk_valid=sk_valid)
        out, lse = flash_attention_forward(q, k, v, with_lse=True, **kw)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.kw = kw
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_backward(q, k, v, out, lse,
                                              dout.contiguous(), **ctx.kw)
        return dq, dk, dv, None, None, None, None, None


def flash_attention(q, k, v, *, causal: bool = True,
                    window: Optional[int] = None,
                    scale: Optional[float] = None,
                    sq_valid: Optional[int] = None,
                    sk_valid: Optional[int] = None) -> torch.Tensor:
    """[B, Hq, Sq, D] attention output in q's dtype; differentiable in q,
    k and v (``FlashAttentionFn``) when grad is enabled and one of them
    requires it."""
    flash_attention.calls += 1
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttentionFn.apply(q, k, v, causal, window, scale,
                                      sq_valid, sk_valid)
    return flash_attention_forward(q, k, v, causal=causal, window=window,
                                   scale=scale, sq_valid=sq_valid,
                                   sk_valid=sk_valid, with_lse=False)


flash_attention.launches = 0
flash_attention.calls = 0


def flash_attention_backward(q, k, v, o, lse, do, *, causal: bool = True,
                             window: Optional[int] = None,
                             scale: Optional[float] = None,
                             sq_valid: Optional[int] = None,
                             sk_valid: Optional[int] = None):
    """(dq, dk, dv) in q's dtype, from the forward's inputs, its output
    ``o``, its ``lse`` and the output's gradient ``do``."""
    flash_attention_backward.calls += 1
    kw = dict(causal=causal, window=window, scale=scale, sq_valid=sq_valid,
              sk_valid=sk_valid)
    if q.device.type == "cpu":
        return flash_attention_backward_plain(q, k, v, o, lse, do, **kw)
    dev, sq_valid, sk_valid = _checked(q, k, v, window, sq_valid, sk_valid)
    B, Hq, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    build.check("o", o, q.dtype, (B, Hq, Sq, D), dev)
    build.check("do", do, q.dtype, (B, Hq, Sq, D), dev)
    build.check("lse", lse, torch.float32, (B, Hq, Sq), dev)
    if tensor_core_backward(q.dtype, D):
        for name, t in (("q", q), ("k", k), ("v", v), ("o", o), ("do", do)):
            if t.data_ptr() % 16:
                raise ValueError(f"flash_attention_backward: {name} must "
                                 f"start on a 16-byte boundary (cp.async "
                                 f"rows)")
    dq, dk, dv = (torch.empty_like(q), torch.empty_like(k),
                  torch.empty_like(v))
    scratch = torch.empty((bwd_scratch_numel(q.shape, k.shape, q.dtype),),
                          dtype=torch.float32, device=dev)
    s = scale if scale is not None else 1.0 / (D ** 0.5)
    lib = build.load("flash_attention_bwd", _BWD_SIG)
    with torch.cuda.device(dev):
        rc = lib.repro_flash_attention_bwd(
            *(build.ptr(t) for t in (q, k, v, o, lse, do, dq, dk, dv,
                                     scratch)),
            B, Hq, Hkv, Sq, Sk, D, int(causal), int(window is not None),
            int(window or 0), ctypes.c_float(s), sq_valid, sk_valid,
            DTYPE_CODES[q.dtype], build.stream(dev))
    build.raise_on_error("flash_attention_backward", rc)
    flash_attention_backward.launches += 1
    return dq, dk, dv


flash_attention_backward.launches = 0
flash_attention_backward.calls = 0
