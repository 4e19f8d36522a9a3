"""Per-op timestamp observation (TicToc's wts/rts reads).

Replaces the TPU kernel ``ts_gather_pallas`` (src/repro/kernels/ts_gather.py);
the semantics are the JAX oracle ``ref.ts_gather``: fine granularity reads
``table[key, group]``, coarse reads the row max (one timestamp per record);
masked ops (key outside ``[0, N)``) read 0.  Returns the uint32 bit
patterns as int32[T, K].

CUDA tensors launch ``csrc/ts_gather.cu`` (one thread per op); CPU tensors
take ``ts_gather_plain``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.claimword import to_i32
from repro_torch.kernels import build
from repro_torch.kernels.scatter import gather_rows, pick_group

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIG = {"repro_ts_gather": [_P] * 4 + [_I] * 4 + [_P]}


def ts_gather_plain(table: torch.Tensor, keys: torch.Tensor,
                    groups: torch.Tensor, fine: bool) -> torch.Tensor:
    rows, valid = gather_rows(table, keys)
    v = pick_group(rows, groups, 0) if fine else rows.amax(dim=-1)
    return to_i32(torch.where(valid, v, 0))


def ts_gather(table: torch.Tensor, keys: torch.Tensor, groups: torch.Tensor,
              fine: bool) -> torch.Tensor:
    """int32[T, K] timestamp bit patterns observed per op."""
    ts_gather.calls += 1
    if keys.device.type == "cpu":
        return ts_gather_plain(table, keys, groups, fine)
    dev = build.launch_device(keys)
    N, G = table.shape
    shape = tuple(keys.shape)
    build.check("table", table, torch.int32, (N, G), dev)
    build.check("keys", keys, torch.int32, shape, dev)
    build.check("groups", groups, torch.int32, shape, dev)
    out = torch.empty(shape, dtype=torch.int32, device=dev)
    lib = build.load("ts_gather", _SIG)
    with torch.cuda.device(dev):
        rc = lib.repro_ts_gather(
            build.ptr(table), build.ptr(keys), build.ptr(groups),
            build.ptr(out), keys.numel(), N, G, int(fine), build.stream(dev))
    build.raise_on_error("ts_gather", rc)
    ts_gather.launches += 1
    return out


ts_gather.launches = 0
ts_gather.calls = 0
