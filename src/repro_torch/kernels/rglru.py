"""The RG-LRU recurrence of recurrentgemma's recurrent blocks.

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
tensors take ``rglru_plain``, which autograd differentiates.  The kernel
has no backward yet: a CUDA call under autograd with an input that
requires grad raises ``NotImplementedError`` (ROADMAP A.12.3b) rather
than return an h without a gradient.
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


def rglru_plain(log_a: torch.Tensor, x: torch.Tensor,
                h0: Optional[torch.Tensor] = None):
    """Plain PyTorch version: a float32 loop over t, one multiply and one
    add per step, as ``ref.rglru``'s scan; differentiable (the same
    operations without ``out=``) when an input requires grad."""
    B, S, D = x.shape
    a = torch.exp(log_a.float())
    gx = torch.sqrt(torch.clamp(1.0 - a * a, min=0.0)) * x.float()
    a, gx = a.transpose(0, 1).contiguous(), gx.transpose(0, 1).contiguous()
    h = (torch.zeros((B, D), dtype=torch.float32, device=x.device)
         if h0 is None else h0.float())
    if torch.is_grad_enabled() and (log_a.requires_grad or x.requires_grad
                                    or (h0 is not None and h0.requires_grad)):
        steps = []                      # under autograd: no out=
        for t in range(S):
            h = a[t] * h + gx[t]
            steps.append(h)
        return torch.stack(steps).transpose(0, 1).to(x.dtype), h
    hs = torch.empty((S, B, D), dtype=torch.float32, device=x.device)
    for t in range(S):
        h = torch.add(a[t] * h, gx[t], out=hs[t])
    return hs.transpose(0, 1).to(x.dtype), h.clone()


def rglru(log_a: torch.Tensor, x: torch.Tensor,
          h0: Optional[torch.Tensor] = None):
    """(h [B, S, D] in x.dtype, h_last [B, D] float32)."""
    rglru.calls += 1
    if x.device.type == "cpu":
        return rglru_plain(log_a, x, h0)
    build.refuse_grad("rglru", log_a, x, h0)
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


rglru.launches = 0
rglru.calls = 0
