"""Monotone scatter-max timestamp install (TicToc's wts/rts advance).

Replaces the TPU kernel ``ts_install_max_pallas``
(src/repro/kernels/ts_install.py); the semantics are the JAX oracle
``ref.ts_install_max``: for every masked op with a key in ``[0, N)``,
``table[key, group] = max(table[key, group], val)`` with uint32 order;
``whole_row`` raises every group of the record (the coarse rts extension).
``vals`` carries uint32 bit patterns in int32.  The table is updated in
place and returned.

CUDA tensors launch ``csrc/ts_install.cu`` (one thread per op,
``atomicMax``); CPU tensors take ``ts_install_max_plain``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.claimword import u32
from repro_torch.kernels import build
from repro_torch.kernels.scatter import scatter_u32

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIG = {"repro_ts_install_max": [_P] * 5 + [_I] * 4 + [_P]}


def ts_install_max_plain(table: torch.Tensor, keys: torch.Tensor,
                         groups: torch.Tensor, vals: torch.Tensor,
                         mask: torch.Tensor,
                         whole_row: bool = False) -> torch.Tensor:
    return scatter_u32(table, keys, groups, u32(vals), mask, "amax",
                       whole_row)


def ts_install_max(table: torch.Tensor, keys: torch.Tensor,
                   groups: torch.Tensor, vals: torch.Tensor,
                   mask: torch.Tensor,
                   whole_row: bool = False) -> torch.Tensor:
    """In-place monotone scatter-max; returns ``table``."""
    ts_install_max.calls += 1
    if keys.device.type == "cpu":
        return ts_install_max_plain(table, keys, groups, vals, mask,
                                    whole_row)
    dev = build.launch_device(keys)
    N, G = table.shape
    shape = tuple(keys.shape)
    build.check("table", table, torch.int32, (N, G), dev)
    build.check("keys", keys, torch.int32, shape, dev)
    build.check("groups", groups, torch.int32, shape, dev)
    build.check("vals", vals, torch.int32, shape, dev)
    build.check("mask", mask, torch.bool, shape, dev)
    lib = build.load("ts_install", _SIG)
    with torch.cuda.device(dev):
        rc = lib.repro_ts_install_max(
            build.ptr(table), build.ptr(keys), build.ptr(groups),
            build.ptr(vals), build.ptr(mask), keys.numel(), N, G,
            int(whole_row), build.stream(dev))
    build.raise_on_error("ts_install_max", rc)
    ts_install_max.launches += 1
    return table


ts_install_max.launches = 0
ts_install_max.calls = 0
