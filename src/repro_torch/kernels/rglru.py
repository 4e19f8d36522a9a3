"""The RG-LRU recurrence of recurrentgemma's recurrent blocks, and its
gradient.

    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * x_t,    a_t = exp(log_a_t)

Replaces the TPU kernel ``rglru_pallas`` (src/repro/kernels/rglru_scan.py);
the semantics are the JAX oracle ``ref.rglru``.  log_a is float32
[B, S, D], x [B, S, D] in float32 or bfloat16, h0 float32 [B, D] (zeros
when None).  Returns (h [B, S, D] in x's dtype, h_last [B, D] float32),
for any S in one launch: the JAX wrapper's 2,048-step chunks are a VMEM
limit of the TPU, and its padded steps are identity steps.

CUDA tensors launch ``csrc/rglru.cu``: each channel stays one sequential
chain with the plain version's separately rounded operations, so h and
h_last are bit-identical to ``rglru_plain``; a block of 64 channels streams
64-step tiles of log_a and x through a three-stage cp.async ring in shared
memory, computes a and g * x of a whole tile in parallel, walks the two-op
h chain a thread a channel, and writes h back in coalesced rows.  CPU
tensors take ``rglru_plain``.

Training: when grad is enabled and an input requires it, ``rglru`` goes
through ``RGLRUFn`` on either device: the forward above, saving log_a, x
and h0; the backward ``rglru_backward``, which launches
``csrc/rglru_bwd.cu`` (a kernel of the port's own: the JAX package
differentiates ``ops.rglru`` by autodiff of its scan) and on the CPU takes
``rglru_backward_plain``.  Both recompute h from the inputs, since h is
stored in x's dtype: g_t = dh_t + a_{t+1} g_{t+1} (g_T = dh_T + dh_last),
dx = g b, dlog_a = a (g h_{t-1} + g x db/da) with db/da = -2 a (0.5 / b)
where 1 - a^2 >= 0 (autograd's rule through clamp and sqrt: infinite at
a = 1 exactly; the products in the order of JAX's vjp of ``ref.rglru``)
and 0 below, dh0 = a_1 g_1.  The kernel keeps the plain version's
operations and order, so its three outputs are bit-identical to it.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import DTYPE_CODES

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIG = {"repro_rglru": [_P] * 5 + [_I] * 4 + [_P]}
_BWD_SIG = {"repro_rglru_bwd": [_P] * 9 + [_I] * 4 + [_P]}
#: Steps a tile of csrc/rglru_bwd.cu: its scratch holds h at the start of
#: every tile, float32 [B, ceil(S / TILE), D].
TILE = 64


def rglru_plain(log_a: torch.Tensor, x: torch.Tensor,
                h0: Optional[torch.Tensor] = None):
    """Plain PyTorch version: a float32 (float64 for float64 x) loop over
    t, one multiply and one add per step, as ``ref.rglru``'s scan;
    differentiable (the same operations without ``out=``) when an input
    requires grad."""
    B, S, D = x.shape
    ft = torch.promote_types(x.dtype, torch.float32)   # float64 stays
    a = torch.exp(log_a.to(ft))
    gx = torch.sqrt(torch.clamp(1.0 - a * a, min=0.0)) * x.to(ft)
    a, gx = a.transpose(0, 1).contiguous(), gx.transpose(0, 1).contiguous()
    h = (torch.zeros((B, D), dtype=ft, device=x.device)
         if h0 is None else h0.to(ft))
    if torch.is_grad_enabled() and (log_a.requires_grad or x.requires_grad
                                    or (h0 is not None and h0.requires_grad)):
        steps = []              # under autograd: no out=, views by unbind
        for at, gt in zip(a.unbind(0), gx.unbind(0)):
            h = at * h + gt
            steps.append(h)
        return torch.stack(steps).transpose(0, 1).to(x.dtype), h
    hs = torch.empty((S, B, D), dtype=ft, device=x.device)
    for t in range(S):
        h = torch.add(a[t] * h, gx[t], out=hs[t])
    return hs.transpose(0, 1).to(x.dtype), h.clone()


def rglru_backward_plain(log_a: torch.Tensor, x: torch.Tensor,
                         h0: Optional[torch.Tensor], dh: torch.Tensor,
                         dh_last: Optional[torch.Tensor] = None):
    """Plain PyTorch version of the backward: the explicit reverse scan in
    float32, each multiply and add rounded on its own.  Returns (dlog_a
    float32, dx in x's dtype, dh0 float32, or None without h0)."""
    B, S, D = x.shape
    a = torch.exp(log_a.float())
    cp = 1.0 - a * a
    b = torch.sqrt(torch.clamp(cp, min=0.0))
    xf = x.float()
    gx = b * xf
    aT, gxT = a.transpose(0, 1), gx.transpose(0, 1)
    h = (torch.zeros((B, D), dtype=torch.float32, device=x.device)
         if h0 is None else h0.float())
    hp = torch.empty((S, B, D), dtype=torch.float32, device=x.device)
    for t in range(S):                  # h_{t-1}: the forward's chain
        hp[t] = h
        h = aT[t] * h + gxT[t]
    carry = (torch.zeros((B, D), dtype=torch.float32, device=x.device)
             if dh_last is None else dh_last.float())
    g = torch.empty((S, B, D), dtype=torch.float32, device=x.device)
    dhT = dh.float().transpose(0, 1)
    for t in range(S - 1, -1, -1):
        g[t] = dhT[t] + carry
        carry = aT[t] * g[t]
    g, hp = g.transpose(0, 1), hp.transpose(0, 1)
    dx = (g * b).to(x.dtype)
    db = torch.where(cp >= 0, -2.0 * (((g * xf) * (0.5 / b)) * a), 0.0)
    dlog_a = (g * hp + db) * a
    return dlog_a, dx, (None if h0 is None else carry)


def rglru_forward(log_a: torch.Tensor, x: torch.Tensor,
                  h0: Optional[torch.Tensor] = None):
    """The forward on x's device: the launch behind ``rglru`` and
    ``RGLRUFn`` (it counts launches, the op counts calls)."""
    if x.device.type == "cpu":
        return rglru_plain(log_a, x, h0)
    dev = build.launch_device(x)
    B, S, D = x.shape
    if x.dtype not in DTYPE_CODES:
        raise TypeError(f"rglru takes float32 or bfloat16 x, got {x.dtype}")
    if h0 is None:
        h0 = torch.zeros((B, D), dtype=torch.float32, device=dev)
    build.check("log_a", log_a, torch.float32, (B, S, D), dev)
    build.check("x", x, x.dtype, (B, S, D), dev)
    build.check("h0", h0, torch.float32, (B, D), dev)
    h = torch.empty_like(x)
    h_last = torch.empty((B, D), dtype=torch.float32, device=dev)
    lib = build.load("rglru", _SIG)
    with torch.cuda.device(dev):
        rc = lib.repro_rglru(
            build.ptr(log_a), build.ptr(x), build.ptr(h0), build.ptr(h),
            build.ptr(h_last), B, S, D, DTYPE_CODES[x.dtype],
            build.stream(dev))
    build.raise_on_error("rglru", rc)
    rglru.launches += 1
    return h, h_last


class RGLRUFn(torch.autograd.Function):
    """``rglru`` under autograd: the forward saves log_a, x and h0; the
    backward is ``rglru_backward``."""

    @staticmethod
    def forward(ctx, log_a, x, h0):
        ctx.save_for_backward(log_a, x, h0)
        return rglru_forward(log_a, x, h0)

    @staticmethod
    def backward(ctx, dh, dh_last):
        log_a, x, h0 = ctx.saved_tensors
        return rglru_backward(log_a, x, h0, dh.contiguous(),
                              dh_last.contiguous())


def rglru(log_a: torch.Tensor, x: torch.Tensor,
          h0: Optional[torch.Tensor] = None):
    """(h [B, S, D] in x.dtype, h_last [B, D] float32); differentiable
    (``RGLRUFn``) when grad is enabled and an input requires it."""
    rglru.calls += 1
    if torch.is_grad_enabled() and (log_a.requires_grad or x.requires_grad
                                    or (h0 is not None and h0.requires_grad)):
        return RGLRUFn.apply(log_a, x, h0)
    return rglru_forward(log_a, x, h0)


rglru.launches = 0
rglru.calls = 0


def rglru_backward(log_a: torch.Tensor, x: torch.Tensor,
                   h0: Optional[torch.Tensor], dh: torch.Tensor,
                   dh_last: Optional[torch.Tensor] = None):
    """(dlog_a float32, dx in x.dtype, dh0 float32 or None without h0)
    from the forward's inputs, h's gradient ``dh`` (x's dtype) and
    h_last's ``dh_last`` (float32; zeros when None)."""
    rglru_backward.calls += 1
    if x.device.type == "cpu":
        return rglru_backward_plain(log_a, x, h0, dh, dh_last)
    dev = build.launch_device(x)
    B, S, D = x.shape
    if x.dtype not in DTYPE_CODES:
        raise TypeError(f"rglru_backward takes float32 or bfloat16 x, got "
                        f"{x.dtype}")
    build.check("log_a", log_a, torch.float32, (B, S, D), dev)
    build.check("x", x, x.dtype, (B, S, D), dev)
    build.check("dh", dh, x.dtype, (B, S, D), dev)
    for name, t in (("h0", h0), ("dh_last", dh_last)):
        if t is not None:
            build.check(name, t, torch.float32, (B, D), dev)
    dlog_a = torch.empty((B, S, D), dtype=torch.float32, device=dev)
    dx = torch.empty_like(x)
    dh0 = (None if h0 is None
           else torch.empty((B, D), dtype=torch.float32, device=dev))
    ckpt = torch.empty((B * -(-S // TILE) * D,), dtype=torch.float32,
                       device=dev)
    lib = build.load("rglru_bwd", _BWD_SIG)
    with torch.cuda.device(dev):
        rc = lib.repro_rglru_bwd(
            *(build.ptr(t) for t in (log_a, x, h0, dh, dh_last, dlog_a, dx,
                                     dh0, ckpt)),
            B, S, D, DTYPE_CODES[x.dtype], build.stream(dev))
    build.raise_on_error("rglru_backward", rc)
    rglru_backward.launches += 1
    return dlog_a, dx, dh0


rglru_backward.launches = 0
rglru_backward.calls = 0
