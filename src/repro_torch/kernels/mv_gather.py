"""Snapshot version select on the multi-version ring.

Replaces the TPU kernel ``mv_gather_pallas``
(src/repro/kernels/mv_gather.py); the semantics are the JAX oracle
``ref.mv_gather``: per op, the newest slot of its record's ring whose
begin stamp fits under the snapshot ``ts``.  Fine visibility reads the
op's own group's begin (0 for a group out of range), coarse the slot's max
over groups.  A slot is visible when ``eff <= ts``; its score is
``eff + 1`` (uint32) and the highest score wins, ties to the lowest slot.
Returns ``(slot int32[T, K], ok bool[T, K])``: ``ok`` is False when no
slot is visible (the version was reclaimed) or the key lies outside
``[0, N)`` (a masked op, as in the Pallas kernel), and the slot is then
0.

The begin words are uint32 bit patterns in int32 tensors and ``MV_EMPTY``
is -1 there, so every compare and max is unsigned: the plain version
widens to int64, the kernel reads ``unsigned``.

CUDA tensors launch ``csrc/mv_gather.cu`` (one thread per op over its
D x G begin words); CPU tensors take ``mv_gather_plain``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.claimword import U32_MASK
from repro_torch.kernels import build
from repro_torch.kernels.scatter import gather_rows

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIG = {"repro_mv_gather": [_P] * 6 + [_I] * 5 + [_P]}


def mv_gather_plain(begin: torch.Tensor, keys: torch.Tensor,
                    groups: torch.Tensor, ts, fine: bool):
    N, D, G = begin.shape
    rows, valid = gather_rows(begin.view(N, D * G), keys)
    rows = rows.view(keys.shape + (D, G))                 # [T, K, D, G]
    if fine:
        sel = torch.arange(G, device=keys.device) == groups[..., None, None]
        eff = torch.where(sel, rows, 0).amax(dim=-1)
    else:
        eff = rows.amax(dim=-1)                           # [T, K, D]
    score = torch.where(eff <= (ts & U32_MASK), (eff + 1) & U32_MASK, 0)
    score = torch.where(valid[..., None], score, 0)
    best = score.amax(dim=-1)
    idx = torch.arange(D, dtype=torch.int32, device=keys.device)
    slot = torch.where(score == best[..., None], idx, D).amin(dim=-1)
    return slot.to(torch.int32), best > 0


def mv_gather(begin: torch.Tensor, keys: torch.Tensor, groups: torch.Tensor,
              ts, fine: bool):
    """(slot int32[T, K], ok bool[T, K]) of the newest version visible at
    snapshot ``ts``, a 0-d int64 tensor (or an int) that the kernel reads
    on the device."""
    mv_gather.calls += 1
    if keys.device.type == "cpu":
        return mv_gather_plain(begin, keys, groups, ts, fine)
    dev = build.launch_device(keys)
    N, D, G = begin.shape
    shape = tuple(keys.shape)
    build.check("begin", begin, torch.int32, (N, D, G), dev)
    build.check("keys", keys, torch.int32, shape, dev)
    build.check("groups", groups, torch.int32, shape, dev)
    slot = torch.empty(shape, dtype=torch.int32, device=dev)
    ok = torch.empty(shape, dtype=torch.bool, device=dev)
    stamp = build.scalar("ts", ts, dev)
    lib = build.load("mv_gather", _SIG)
    with torch.cuda.device(dev):
        rc = lib.repro_mv_gather(
            build.ptr(begin), build.ptr(keys), build.ptr(groups),
            build.ptr(slot), build.ptr(ok), build.ptr(stamp), keys.numel(),
            N, D, G, int(bool(fine)), build.stream(dev))
    build.raise_on_error("mv_gather", rc)
    mv_gather.launches += 1
    return slot, ok


mv_gather.launches = 0
mv_gather.calls = 0
