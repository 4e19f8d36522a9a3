"""Interval (scan) validation: the phantom check.

Replaces the TPU kernel ``iterate_validate_pallas``
(src/repro/kernels/iterate_validate.py); the semantics are the JAX oracle
``ref.iterate_validate``: an op with ``check`` set and a key >= 0 covers
``[key, key + extent)`` and conflicts when a row of its validated interval
carries a live claim of this wave stronger than ``myprio``:

- fine: the rows of ``[key, key + extent)``, each at the op's group;
- coarse: the bucket-expanded rows ``[floor(key/B)*B, ceil((key+extent)/B)*B)``
  with the whole-row minimum (one claim word per bucket of B records).

Only the first ``scan_span(ext_cap, fine, B)`` rows are walked; rows past
the table's edge read as no claimant.  Returns bool[T, K]; the table is
only read.

CUDA tensors launch ``csrc/iterate_validate.cu`` (a warp walks its ops'
intervals one op after another, 128 rows a batch with every load in
flight before a test); CPU tensors take ``iterate_validate_plain``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.claimword import NO_PRIO, inv_wave, live_prio, u32
from repro_torch.kernels import build
from repro_torch.kernels.scatter import pick_group

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIG = {"repro_iterate_validate": [_P] * 7 + [_I] * 7 + [_P]}


def scan_span(ext_cap: int, fine: bool, bucket_size: int) -> int:
    """Rows walked per op: ``ext_cap`` for the exact (fine) interval; for
    coarse the bucket expansion of a worst-aligned interval, a first
    bucket plus ceil((ext_cap - 1) / B) further buckets of B rows."""
    if fine or ext_cap <= 1:
        return ext_cap
    return (1 + -(-(ext_cap - 1) // bucket_size)) * bucket_size


def iterate_validate_plain(table: torch.Tensor, keys: torch.Tensor,
                           extents: torch.Tensor, groups: torch.Tensor,
                           myprio: torch.Tensor, check: torch.Tensor,
                           wave: int, fine: bool, bucket_size: int,
                           ext_cap: int) -> torch.Tensor:
    N = table.shape[0]
    out = torch.zeros(keys.shape, dtype=torch.bool, device=keys.device)
    act = check & (keys >= 0)
    if not bool(act.any()):
        return out
    k = keys[act].to(torch.int64)
    ext = torch.clamp(extents[act], min=1).to(torch.int64)
    if fine:
        start, width = k, ext
    else:
        B = bucket_size
        start = (k // B) * B
        width = ((k + ext + B - 1) // B) * B - start
    span = scan_span(ext_cap, fine, bucket_size)
    j = torch.arange(span, device=keys.device)
    row = start[:, None] + j[None, :]                      # [n, span]
    on = (j[None, :] < width[:, None]) & (row >= 0) & (row < N)
    rows = u32(table[torch.where(on, row, 0)])            # [n, span, G]
    pr = torch.where(on[..., None], live_prio(rows, inv_wave(wave)), NO_PRIO)
    if fine:
        g = groups[act][:, None].expand(row.shape)
        wprio = pick_group(pr, g, NO_PRIO)
    else:
        wprio = pr.amin(dim=-1)
    out[act] = (wprio < u32(myprio[act])[:, None]).any(dim=1)
    return out


def iterate_validate(table: torch.Tensor, keys: torch.Tensor,
                     extents: torch.Tensor, groups: torch.Tensor,
                     myprio: torch.Tensor, check: torch.Tensor, wave: int,
                     fine: bool, bucket_size: int,
                     ext_cap: int) -> torch.Tensor:
    """Phantom conflict flags, bool[T, K]."""
    iterate_validate.calls += 1
    if keys.device.type == "cpu":
        return iterate_validate_plain(table, keys, extents, groups, myprio,
                                      check, wave, fine, bucket_size,
                                      ext_cap)
    dev = build.launch_device(keys)
    N, G = table.shape
    shape = tuple(keys.shape)
    build.check("table", table, torch.int32, (N, G), dev)
    build.check("keys", keys, torch.int32, shape, dev)
    build.check("extents", extents, torch.int32, shape, dev)
    build.check("groups", groups, torch.int32, shape, dev)
    build.check("myprio", myprio, torch.int32, shape, dev)
    build.check("check", check, torch.bool, shape, dev)
    if bucket_size < 1:
        raise ValueError(f"bucket_size must be >= 1, got {bucket_size}")
    out = torch.empty(shape, dtype=torch.bool, device=dev)
    lib = build.load("iterate_validate", _SIG)
    with torch.cuda.device(dev):
        rc = lib.repro_iterate_validate(
            build.ptr(table), build.ptr(keys), build.ptr(extents),
            build.ptr(groups), build.ptr(myprio), build.ptr(check),
            build.ptr(out), keys.numel(), N, G, inv_wave(wave),
            int(bool(fine)), bucket_size,
            scan_span(ext_cap, fine, bucket_size), build.stream(dev))
    build.raise_on_error("iterate_validate", rc)
    iterate_validate.launches += 1
    return out


iterate_validate.launches = 0
iterate_validate.calls = 0
