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

CUDA tensors launch one of two kernels of ``csrc/rwkv6.cu``, by dtype and
length (``route``):

- ``"chunked"``: bfloat16 r, k, v with S >= ``CHUNK`` (the served
  prefill).  The chunked form on the tensor cores: per chunk of 64 tokens
  and block of (b, h, 64 state columns), the inter-chunk output, the
  intra-chunk scores and the state update are ``wgmma`` products, every
  decay factor a running product of w anchored at a 16-token sub-block
  boundary between the positions it joins (no logarithm, no division),
  float32 operands split into three bf16 parts.  It needs Dv a multiple
  of 8 and 16-byte-aligned r, k, v and w.
- ``"recurrent"``: float32 r, k, v, or S < ``CHUNK`` (decode, short
  prompts).  One block per (b, h) walks t, each thread holding 16 rows of
  one state column in registers.

A failure to build or launch raises; nothing falls back.  CPU tensors
take ``rwkv6_plain``, which autograd differentiates.  The kernels have no
backward yet: a CUDA call under autograd with an input that requires
grad raises ``NotImplementedError`` (ROADMAP A.12.3b) rather than return
an output without a gradient.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import DTYPE_CODES

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIG = {"repro_rwkv6": [_P] * 8 + [_I] * 5 + [_I, _P],
        "repro_rwkv6_chunked": [_P] * 8 + [_I] * 5 + [_P]}

#: Key widths both kernels are compiled for, and the widest value row the
#: recurrent kernel stages in shared memory.
KEY_DIMS = (16, 32, 64, 128)
MAX_VALUE_DIM = 1024
#: Tokens a chunk of the chunked kernel; shorter bfloat16 inputs take the
#: recurrent kernel.
CHUNK = 64


def route(dtype: torch.dtype, S: int) -> str:
    """The kernel that serves a CUDA call: "chunked" for bfloat16 r, k, v
    and S >= CHUNK, else "recurrent"."""
    if dtype == torch.bfloat16 and S >= CHUNK:
        return "chunked"
    return "recurrent"


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
    build.refuse_grad("rwkv6", r, k, v, w, u, s0)
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
    chunked = route(r.dtype, S) == "chunked"
    if chunked:
        if Dv % 8:
            raise ValueError(f"rwkv6: the chunked kernel takes value widths "
                             f"that are multiples of 8, got {Dv}")
        for name, t in (("r", r), ("k", k), ("v", v), ("w", w)):
            if t.data_ptr() % 16:
                raise ValueError(f"rwkv6: {name} must be 16-byte aligned "
                                 f"for the chunked kernel")
    out = torch.empty((B, H, S, Dv), dtype=r.dtype, device=dev)
    s_last = torch.empty((B, H, Dk, Dv), dtype=torch.float32, device=dev)
    lib = build.load("rwkv6", _SIG)
    args = [build.ptr(t) for t in (r, k, v, w, u, s0, out, s_last)]
    with torch.cuda.device(dev):
        if chunked:
            rc = lib.repro_rwkv6_chunked(*args, B, H, S, Dk, Dv,
                                         build.stream(dev))
        else:
            rc = lib.repro_rwkv6(*args, B, H, S, Dk, Dv,
                                 DTYPE_CODES[r.dtype], build.stream(dev))
    build.raise_on_error("rwkv6", rc)
    rwkv6.launches += 1
    return out, s_last


rwkv6.launches = 0
rwkv6.calls = 0
