"""Claim scatter: pack claim words and scatter-min them into a claim table.

Replaces the TPU kernel ``claim_scatter_pallas``
(src/repro/kernels/claim_scatter.py); the semantics are the JAX oracle
``ref.claim_scatter``: for every masked op with a cell inside the table,
``table[key, group] = min(table[key, group], (inv_wave << 16) | prio16)``
with uint32 order.  The table is updated in place.

CUDA tensors launch ``csrc/claim_scatter.cu`` (one thread per op,
``atomicMin``); CPU tensors take ``claim_scatter_plain``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.claimword import claim_word
from repro_torch.kernels import build
from repro_torch.kernels.scatter import scatter_u32

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIG = {"repro_claim_scatter": [_P] * 6 + [_I] * 3 + [_P]}


def claim_scatter_plain(table: torch.Tensor, keys: torch.Tensor,
                        groups: torch.Tensor, prio: torch.Tensor, wave,
                        mask: torch.Tensor) -> None:
    scatter_u32(table, keys, groups, claim_word(wave, prio), mask, "amin")


def claim_scatter(table: torch.Tensor, keys: torch.Tensor,
                  groups: torch.Tensor, prio: torch.Tensor, wave,
                  mask: torch.Tensor) -> None:
    """In-place scatter-min of the masked ops' claim words; ``wave`` is
    a 0-d int64 tensor (or an int), read by the kernel on the device."""
    claim_scatter.calls += 1
    if keys.device.type == "cpu":
        return claim_scatter_plain(table, keys, groups, prio, wave, mask)
    dev = build.launch_device(keys)
    N, G = table.shape
    shape = tuple(keys.shape)
    build.check("table", table, torch.int32, (N, G), dev)
    build.check("keys", keys, torch.int32, shape, dev)
    build.check("groups", groups, torch.int32, shape, dev)
    build.check("prio", prio, torch.int32, shape, dev)
    build.check("mask", mask, torch.bool, shape, dev)
    w = build.scalar("wave", wave, dev)
    lib = build.load("claim_scatter", _SIG)
    with torch.cuda.device(dev):
        rc = lib.repro_claim_scatter(
            build.ptr(table), build.ptr(keys), build.ptr(groups),
            build.ptr(prio), build.ptr(mask), build.ptr(w), keys.numel(), N,
            G, build.stream(dev))
    build.raise_on_error("claim_scatter", rc)
    claim_scatter.launches += 1


claim_scatter.launches = 0
claim_scatter.calls = 0
