"""Monotone scatter-max timestamp install (TicToc's wts/rts advance).

Replaces the TPU kernel ``ts_install_max_pallas``
(src/repro/kernels/ts_install.py); the semantics are the JAX oracle
``ref.ts_install_max``: for every masked op with a key in ``[0, N)``,
``table[key, group] = max(table[key, group], val)`` with uint32 order;
``whole_row`` raises every group of the record (the coarse rts extension).
``vals`` carries uint32 bit patterns in int32.  The table is updated in
place and returned.

With ``rts`` and ``ext`` one call is a TicToc wave's three installs, in
the JAX package's order (src/repro/core/cc/tictoc.py): ``table`` (wts)
and ``rts`` take each op's value at ``mask``, then ``rts`` takes it at
``ext``, every group of the record with ``ext_whole_row``.  That form
takes ``commit_ts`` (int64[T]) and ``n_chain`` (float32[T, K]), as
TicToc's wave gives them, in place of ``vals``: each op's value is its
chained install stamp ``chain_stamps(commit_ts, n_chain)``.  Given
values and ``whole_row`` belong to the one-table form.

CUDA tensors launch ``csrc/ts_install.cu`` (one thread per op,
``atomicMax``; the three installs are one launch); CPU tensors take
``ts_install_max_plain``, once per install (``ts_install_tictoc_plain``).
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.core.claimword import to_i32, u32
from repro_torch.kernels import build
from repro_torch.kernels.scatter import scatter_u32

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIG = {"repro_ts_install_max": [_P] * 5 + [_I] * 4 + [_P],
        "repro_ts_install_tictoc": [_P] * 8 + [_I] * 5 + [_P]}


def chain_stamps(commit_ts: torch.Tensor,
                 n_chain: torch.Tensor) -> torch.Tensor:
    """TicToc's install stamps int32[T, K]: n same-cell committed writers
    chain their installs, so each op's value is ``commit_ts[t] + 2 *
    (max(n_chain, 1) - 1)`` mod 2**32."""
    cts = (commit_ts[:, None]
           + 2 * (torch.clamp(n_chain, min=1.0).to(torch.int64) - 1))
    return to_i32(cts)


def ts_install_max_plain(table: torch.Tensor, keys: torch.Tensor,
                         groups: torch.Tensor, vals: torch.Tensor,
                         mask: torch.Tensor,
                         whole_row: bool = False) -> torch.Tensor:
    return scatter_u32(table, keys, groups, u32(vals), mask, "amax",
                       whole_row)


def ts_install_tictoc_plain(table: torch.Tensor, keys: torch.Tensor,
                            groups: torch.Tensor, mask: torch.Tensor,
                            rts: torch.Tensor, ext: torch.Tensor,
                            ext_whole_row: bool, commit_ts: torch.Tensor,
                            n_chain: torch.Tensor) -> torch.Tensor:
    """The three-install form as the JAX package makes it: the stamps,
    then ``ts_install_max_plain`` on wts, on rts and on rts at ``ext``."""
    vals = chain_stamps(commit_ts, n_chain)
    ts_install_max_plain(table, keys, groups, vals, mask)
    ts_install_max_plain(rts, keys, groups, vals, mask)
    ts_install_max_plain(rts, keys, groups, vals, ext, ext_whole_row)
    return table


def ts_install_max(table: torch.Tensor, keys: torch.Tensor,
                   groups: torch.Tensor, vals: Optional[torch.Tensor],
                   mask: torch.Tensor, whole_row: bool = False, *,
                   rts: Optional[torch.Tensor] = None,
                   ext: Optional[torch.Tensor] = None,
                   ext_whole_row: bool = False,
                   commit_ts: Optional[torch.Tensor] = None,
                   n_chain: Optional[torch.Tensor] = None) -> torch.Tensor:
    """In-place monotone scatter-max; returns ``table``.  With ``rts``,
    ``ext``, ``commit_ts`` and ``n_chain``, TicToc's three installs in
    one call (module docstring)."""
    ts_install_max.calls += 1
    three = rts is not None
    if {three} != {ext is not None, commit_ts is not None,
                   n_chain is not None}:
        raise ValueError("ts_install_max: rts, ext, commit_ts and n_chain "
                         "come together")
    if three and (vals is not None or whole_row):
        raise ValueError("ts_install_max: the three-install form takes no "
                         "vals and no whole_row")
    if not three and vals is None:
        raise ValueError("ts_install_max: the one-table form takes vals")
    if three and keys.dim() != 2:
        raise ValueError("ts_install_max: the three-install form takes "
                         "keys of shape [T, K]")
    if keys.device.type == "cpu":
        if three:
            return ts_install_tictoc_plain(table, keys, groups, mask, rts,
                                           ext, ext_whole_row, commit_ts,
                                           n_chain)
        return ts_install_max_plain(table, keys, groups, vals, mask,
                                    whole_row)
    dev = build.launch_device(keys)
    N, G = table.shape
    shape = tuple(keys.shape)
    build.check("table", table, torch.int32, (N, G), dev)
    build.check("keys", keys, torch.int32, shape, dev)
    build.check("groups", groups, torch.int32, shape, dev)
    build.check("mask", mask, torch.bool, shape, dev)
    lib = build.load("ts_install", _SIG)
    if three:
        build.check("rts", rts, torch.int32, (N, G), dev)
        build.check("ext", ext, torch.bool, shape, dev)
        build.check("commit_ts", commit_ts, torch.int64, shape[:1], dev)
        build.check("n_chain", n_chain, torch.float32, shape, dev)
        with torch.cuda.device(dev):
            rc = lib.repro_ts_install_tictoc(
                build.ptr(table), build.ptr(rts), build.ptr(keys),
                build.ptr(groups), build.ptr(commit_ts), build.ptr(n_chain),
                build.ptr(mask), build.ptr(ext), keys.numel(), shape[1], N,
                G, int(ext_whole_row), build.stream(dev))
    else:
        build.check("vals", vals, torch.int32, shape, dev)
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
