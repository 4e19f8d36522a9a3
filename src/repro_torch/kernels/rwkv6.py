"""The RWKV-6 ("Finch") wkv recurrence with data-dependent decay.

Per head, a [Dk, Dv] state S is updated per token:

    out_t = (S_{t-1} + (u * k_t) v_t^T)^T r_t
    S_t   = diag(w_t) S_{t-1} + k_t v_t^T

Replaces the TPU kernel ``rwkv6_pallas`` (src/repro/kernels/rwkv6_scan.py);
the semantics are the JAX oracle ``ref.rwkv6``.  r and k are [B, H, S, Dk]
and v [B, H, S, Dv] in float32 or bfloat16 (one dtype); w is float32
[B, H, S, Dk], u float32 [H, Dk], s0 float32 [B, H, Dk, Dv] (zeros when
None).  Returns (out [B, H, S, Dv] in r's dtype, s_last float32), for
any S in one launch: the JAX wrapper's chunks are a VMEM limit, and its
padded steps (w = 1, k = 0) are identity steps.

CUDA tensors launch ``csrc/rwkv6.cu`` (one block per (b, h), each thread
holding 16 rows of one state column in registers); CPU tensors take
``rwkv6_plain``.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import DTYPE_CODES

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIG = {"repro_rwkv6": [_P] * 8 + [_I] * 5 + [_I, _P]}

#: Key widths the kernel is compiled for (16 state rows per thread), and
#: the widest value row it stages in shared memory.
KEY_DIMS = (16, 32, 64, 128)
MAX_VALUE_DIM = 1024


def rwkv6_plain(r, k, v, w, u, s0: Optional[torch.Tensor] = None):
    """Plain PyTorch version: a float32 loop over t, as ``ref.rwkv6``'s
    scan."""
    B, H, S, Dk = r.shape
    Dv = v.shape[-1]
    state = (torch.zeros((B, H, Dk, Dv), dtype=torch.float32,
                         device=r.device) if s0 is None else s0.float())
    rs, ks, vs, ws = (t.float() for t in (r, k, v, w))
    uu = u.float()[None, :, :, None]
    outs = torch.empty((B, H, S, Dv), dtype=torch.float32, device=r.device)
    for t in range(S):
        kv = ks[:, :, t, :, None] * vs[:, :, t, None, :]
        outs[:, :, t] = torch.einsum("bhkv,bhk->bhv", state + uu * kv,
                                     rs[:, :, t])
        state = ws[:, :, t, :, None] * state + kv
    return outs.to(r.dtype), state


def rwkv6(r, k, v, w, u, s0: Optional[torch.Tensor] = None):
    """(out [B, H, S, Dv] in r.dtype, s_last [B, H, Dk, Dv] float32)."""
    rwkv6.calls += 1
    if r.device.type == "cpu":
        return rwkv6_plain(r, k, v, w, u, s0)
    dev = build.launch_device(r)
    B, H, S, Dk = r.shape
    Dv = v.shape[-1]
    if r.dtype not in DTYPE_CODES:
        raise TypeError(f"rwkv6 takes float32 or bfloat16 r, k, v, got "
                        f"{r.dtype}")
    if Dk not in KEY_DIMS:
        raise ValueError(f"rwkv6: key width {Dk} not in {KEY_DIMS}")
    if not 1 <= Dv <= MAX_VALUE_DIM:
        raise ValueError(f"rwkv6: value width {Dv} outside [1, "
                         f"{MAX_VALUE_DIM}]")
    if s0 is None:
        s0 = torch.zeros((B, H, Dk, Dv), dtype=torch.float32, device=dev)
    build.check("r", r, r.dtype, (B, H, S, Dk), dev)
    build.check("k", k, r.dtype, (B, H, S, Dk), dev)
    build.check("v", v, r.dtype, (B, H, S, Dv), dev)
    build.check("w", w, torch.float32, (B, H, S, Dk), dev)
    build.check("u", u, torch.float32, (H, Dk), dev)
    build.check("s0", s0, torch.float32, (B, H, Dk, Dv), dev)
    out = torch.empty((B, H, S, Dv), dtype=r.dtype, device=dev)
    s_last = torch.empty((B, H, Dk, Dv), dtype=torch.float32, device=dev)
    lib = build.load("rwkv6", _SIG)
    with torch.cuda.device(dev):
        rc = lib.repro_rwkv6(
            build.ptr(r), build.ptr(k), build.ptr(v), build.ptr(w),
            build.ptr(u), build.ptr(s0), build.ptr(out), build.ptr(s_last),
            B, H, S, Dk, Dv, DTYPE_CODES[r.dtype], build.stream(dev))
    build.raise_on_error("rwkv6", rc)
    rwkv6.launches += 1
    return out, s_last


rwkv6.launches = 0
rwkv6.calls = 0
