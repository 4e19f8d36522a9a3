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
take ``rwkv6_plain``.

Training: when grad is enabled and an input requires it, ``rwkv6`` goes
through ``RWKV6Fn`` on either device: the forward above (either kernel),
saving its inputs; the backward ``rwkv6_backward`` (a kernel of the port's
own, ``csrc/rwkv6_bwd.cu``: the JAX package differentiates ``ops.rwkv6``
by autodiff of its scan), which on the CPU takes ``rwkv6_backward_plain``.
Its gradient: dS_T = ds_last, dS_{t-1} = diag(w_t) dS_t + r_t dout_t^T,
dr_t = S_{t-1} dout_t + u k_t (v_t . dout_t), dk_t = dS_t v_t +
u r_t (v_t . dout_t), dv_t = dS_t^T k_t + (sum_i r u k) dout_t,
dw_t = rowsum(dS_t * S_{t-1}), du = sum_{b, t} r k (v . dout), ds0 = dS_0;
dr, dk, dv in r's dtype, dw, du, ds0 float32.  CUDA tensors take one of
two kernels of ``csrc/rwkv6_bwd.cu``, by the forward's ``route``:

- ``"chunked"``: bfloat16 r, k, v with S >= ``CHUNK``, split in time.  A
  chain over the chunks on ``wgmma`` (the forward's anchored running
  products and three-part splits) gives each 64-token chunk's start state
  and end gradient, then one block per (b, h, chunk) walks its 64 tokens
  exactly from them (dw has no chunked form without a logarithm or a
  division), and a last launch sums du.  It needs Dv a multiple of 8 and
  16-byte-aligned r, k, v, w and dout.
- ``"recurrent"``: float32 r, k, v, or S < ``CHUNK``.  One block per
  (b, h) recomputes the float32 states S_{t-1} from checkpoints every few
  tokens and walks back over the whole sequence.  It takes Dv up to
  ``MAX_BWD_VALUE_DIM`` (even for bfloat16) and 4-byte-aligned tensors.

A failure to build or launch raises; neither route falls back.
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
_BWD_SIG = {"repro_rwkv6_bwd": [_P] * 15 + [_I] * 6 + [_P],
            "repro_rwkv6_bwd_scratch": [_I] * 6
            + [ctypes.POINTER(ctypes.c_longlong)],
            "repro_rwkv6_bwd_chunked": [_P] * 15 + [_I] * 5 + [_P],
            "repro_rwkv6_bwd_chunked_scratch": [_I] * 5
            + [ctypes.POINTER(ctypes.c_longlong)]}

#: Key widths both kernels are compiled for, and the widest value row the
#: recurrent kernel stages in shared memory.
KEY_DIMS = (16, 32, 64, 128)
MAX_VALUE_DIM = 1024
#: Tokens a chunk of the chunked kernel; shorter bfloat16 inputs take the
#: recurrent kernel.
CHUNK = 64
#: The widest value row the backward kernels take (the recurrent one: 16
#: state columns a thread, at most 8 threads a state row).
MAX_BWD_VALUE_DIM = 128


def route(dtype: torch.dtype, S: int) -> str:
    """The kernel that serves a CUDA call, forward and backward: "chunked"
    for bfloat16 r, k, v and S >= CHUNK, else "recurrent"."""
    if dtype == torch.bfloat16 and S >= CHUNK:
        return "chunked"
    return "recurrent"


def rwkv6_plain(r, k, v, w, u, s0: Optional[torch.Tensor] = None):
    """Plain PyTorch version: a float32 (float64 for float64 r) loop over
    t, as ``ref.rwkv6``'s scan."""
    B, H, S, Dk = r.shape
    Dv = v.shape[-1]
    ft = torch.promote_types(r.dtype, torch.float32)   # float64 stays
    state = (torch.zeros((B, H, Dk, Dv), dtype=ft, device=r.device)
             if s0 is None else s0.to(ft))
    rs, ks, vs, ws = (t.to(ft) for t in (r, k, v, w))
    uu = u.to(ft)[None, :, :, None]
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (r, k, v, w, u, s0)):
        # Under autograd: the tokens' views by unbind and the outputs by
        # stack, so the backward writes no full-size gradient a token.
        outs = []
        for rt, kt, vt, wt in zip(*(t.unbind(2) for t in (rs, ks, vs, ws))):
            kv = kt[..., None] * vt[..., None, :]
            outs.append(torch.einsum("bhkv,bhk->bhv", state + uu * kv, rt))
            state = wt[..., None] * state + kv
        return torch.stack(outs, 2).to(r.dtype), state
    outs = torch.empty((B, H, S, Dv), dtype=ft, device=r.device)
    for t in range(S):
        kv = ks[:, :, t, :, None] * vs[:, :, t, None, :]
        outs[:, :, t] = torch.einsum("bhkv,bhk->bhv", state + uu * kv,
                                     rs[:, :, t])
        state = ws[:, :, t, :, None] * state + kv
    return outs.to(r.dtype), state


def rwkv6_backward_plain(r, k, v, w, u, s0, dout, ds_last=None):
    """Plain PyTorch version of the backward: the states S_{t-1} by the
    forward's float32 loop, then the reverse walk of dS in float32.
    Returns (dr, dk, dv in r's dtype, dw float32, du float32 [H, Dk],
    ds0 float32, or None without s0)."""
    B, H, S, Dk = r.shape
    Dv = v.shape[-1]
    dev = r.device
    rs, ks, vs, ws, dos = (t.float() for t in (r, k, v, w, dout))
    uu = u.float()[None, :, None, :]
    state = (torch.zeros((B, H, Dk, Dv), dtype=torch.float32, device=dev)
             if s0 is None else s0.float())
    prev = torch.empty((B, H, S, Dk, Dv), dtype=torch.float32, device=dev)
    for t in range(S):
        prev[:, :, t] = state
        kv = ks[:, :, t, :, None] * vs[:, :, t, None, :]
        state = ws[:, :, t, :, None] * state + kv
    vd = (vs * dos).sum(-1, keepdim=True)              # v_t . dout_t
    dr = torch.einsum("bhskv,bhsv->bhsk", prev, dos) + uu * ks * vd
    ds = (torch.zeros((B, H, Dk, Dv), dtype=torch.float32, device=dev)
          if ds_last is None else ds_last.float())
    dk = torch.empty((B, H, S, Dk), dtype=torch.float32, device=dev)
    dv = torch.empty((B, H, S, Dv), dtype=torch.float32, device=dev)
    dw = torch.empty((B, H, S, Dk), dtype=torch.float32, device=dev)
    for t in range(S - 1, -1, -1):
        dk[:, :, t] = torch.einsum("bhkv,bhv->bhk", ds, vs[:, :, t])
        dv[:, :, t] = torch.einsum("bhkv,bhk->bhv", ds, ks[:, :, t])
        dw[:, :, t] = (ds * prev[:, :, t]).sum(-1)
        ds = (ws[:, :, t, :, None] * ds
              + rs[:, :, t, :, None] * dos[:, :, t, None, :])
    dk = dk + uu * rs * vd
    dv = dv + (rs * uu * ks).sum(-1, keepdim=True) * dos
    du = (rs * ks * vd).sum(dim=(0, 2))
    return (dr.to(r.dtype), dk.to(k.dtype), dv.to(v.dtype), dw, du,
            None if s0 is None else ds)


def rwkv6_forward(r, k, v, w, u, s0: Optional[torch.Tensor] = None):
    """The forward on r's device: the launch behind ``rwkv6`` and
    ``RWKV6Fn`` (it counts launches, the op counts calls)."""
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


class RWKV6Fn(torch.autograd.Function):
    """``rwkv6`` under autograd: the forward saves r, k, v, w, u and s0;
    the backward is ``rwkv6_backward``."""

    @staticmethod
    def forward(ctx, r, k, v, w, u, s0):
        ctx.save_for_backward(r, k, v, w, u, s0)
        return rwkv6_forward(r, k, v, w, u, s0)

    @staticmethod
    def backward(ctx, dout, ds_last):
        return rwkv6_backward(*ctx.saved_tensors, dout.contiguous(),
                              ds_last.contiguous())


def rwkv6(r, k, v, w, u, s0: Optional[torch.Tensor] = None):
    """(out [B, H, S, Dv] in r.dtype, s_last [B, H, Dk, Dv] float32);
    differentiable (``RWKV6Fn``) when grad is enabled and an input
    requires it."""
    rwkv6.calls += 1
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (r, k, v, w, u, s0)):
        return RWKV6Fn.apply(r, k, v, w, u, s0)
    return rwkv6_forward(r, k, v, w, u, s0)


rwkv6.launches = 0
rwkv6.calls = 0


def rwkv6_backward(r, k, v, w, u, s0, dout, ds_last=None):
    """(dr, dk, dv in r.dtype, dw float32, du float32 [H, Dk], ds0 float32
    or None without s0) from the forward's inputs, out's gradient ``dout``
    (r's dtype) and s_last's ``ds_last`` (float32; zeros when None)."""
    rwkv6_backward.calls += 1
    if r.device.type == "cpu":
        return rwkv6_backward_plain(r, k, v, w, u, s0, dout, ds_last)
    dev = build.launch_device(r)
    B, H, S, Dk = r.shape
    Dv = v.shape[-1]
    if r.dtype not in DTYPE_CODES:
        raise TypeError(f"rwkv6_backward takes float32 or bfloat16 r, k, v, "
                        f"got {r.dtype}")
    if Dk not in KEY_DIMS:
        raise ValueError(f"rwkv6_backward: key width {Dk} not in "
                         f"{KEY_DIMS}")
    if not 1 <= Dv <= MAX_BWD_VALUE_DIM or (r.dtype == torch.bfloat16
                                            and Dv % 2):
        raise ValueError(f"rwkv6_backward: value width {Dv} outside [1, "
                         f"{MAX_BWD_VALUE_DIM}] (even for bfloat16)")
    for name, t, dt, shape in (
            ("r", r, r.dtype, (B, H, S, Dk)), ("k", k, r.dtype, (B, H, S, Dk)),
            ("v", v, r.dtype, (B, H, S, Dv)),
            ("w", w, torch.float32, (B, H, S, Dk)),
            ("u", u, torch.float32, (H, Dk)),
            ("dout", dout, r.dtype, (B, H, S, Dv))):
        build.check(name, t, dt, shape, dev)
        if t.data_ptr() % 4:
            raise ValueError(f"rwkv6_backward: {name} must be 4-byte "
                             f"aligned (cp.async words)")
    for name, t in (("s0", s0), ("ds_last", ds_last)):
        if t is not None:
            build.check(name, t, torch.float32, (B, H, Dk, Dv), dev)
    chunked = route(r.dtype, S) == "chunked"
    if chunked:
        if Dv % 8:
            raise ValueError(f"rwkv6_backward: the chunked kernel takes value "
                             f"widths that are multiples of 8, got {Dv}")
        for name, t in (("r", r), ("k", k), ("v", v), ("w", w),
                        ("dout", dout)):
            if t.data_ptr() % 16:
                raise ValueError(f"rwkv6_backward: {name} must be 16-byte "
                                 f"aligned for the chunked kernel")
    dr, dk = torch.empty_like(r), torch.empty_like(k)
    dv = torch.empty_like(v)
    dw = torch.empty((B, H, S, Dk), dtype=torch.float32, device=dev)
    du = torch.empty((H, Dk), dtype=torch.float32, device=dev)
    ds0 = (None if s0 is None
           else torch.empty((B, H, Dk, Dv), dtype=torch.float32, device=dev))
    lib = build.load("rwkv6_bwd", _BWD_SIG)
    n = ctypes.c_longlong(0)
    if chunked:
        rc = lib.repro_rwkv6_bwd_chunked_scratch(B, H, S, Dk, Dv,
                                                 ctypes.byref(n))
    else:
        rc = lib.repro_rwkv6_bwd_scratch(B, H, S, Dk, Dv,
                                         DTYPE_CODES[r.dtype],
                                         ctypes.byref(n))
    build.raise_on_error("rwkv6_backward", rc)
    scratch = torch.empty((n.value,), dtype=torch.float32, device=dev)
    ptrs = [build.ptr(t) for t in (r, k, v, w, u, s0, dout, ds_last, dr, dk,
                                   dv, dw, du, ds0, scratch)]
    with torch.cuda.device(dev):
        if chunked:
            rc = lib.repro_rwkv6_bwd_chunked(*ptrs, B, H, S, Dk, Dv,
                                             build.stream(dev))
        else:
            rc = lib.repro_rwkv6_bwd(*ptrs, B, H, S, Dk, Dv,
                                     DTYPE_CODES[r.dtype], build.stream(dev))
    build.raise_on_error("rwkv6_backward", rc)
    rwkv6_backward.launches += 1
    return dr, dk, dv, dw, du, ds0


rwkv6_backward.launches = 0
rwkv6_backward.calls = 0
