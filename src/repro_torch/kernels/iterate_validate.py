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

With ``words`` (int32[D, ceil(M/16)], the sharded owner's verdict words
of keys [D, M] in the wire format of kernels/verdict_pack.py) the call
ORs each conflict into bit ``bit`` (0 or 1) of its op's field, in place,
and returns ``words``: the owner's scan verdicts (bit 0 for OCC, bit 1
for MV-OCC) folded into the words its claim launch wrote.  The plain
version of that form is the chain it replaces: the flags, shifted, packed
with ``verdict_pack_plain`` and OR-ed in.

With ``point`` (the wave's point conflicts, bool[T, K]), ``wts`` (the
version table, the claim table's shape) and ``do`` (the write mask) the
call returns ``point | phantom`` and adds 1 to ``wts[key, group]``
(uint32, wrapping) for every ``do`` op with its cell in the table whose
lane has no conflict: a scan wave's phantom pass and its version bumps.
Its plain version is the chain it replaces: ``iterate_validate_plain |
point``, then ``commit_install_plain(do & ~any)``.

CUDA tensors launch ``csrc/iterate_validate.cu`` (a warp walks its ops'
intervals one op after another, 128 rows a batch with every load in
flight before a test; the bump form in blocks of whole lanes); CPU tensors
take ``iterate_validate_plain``.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.core.claimword import NO_PRIO, inv_wave, live_prio, u32
from repro_torch.kernels import build
from repro_torch.kernels.occ_commit import commit_install_plain
from repro_torch.kernels.scatter import pick_group
from repro_torch.kernels.verdict_pack import n_words, verdict_pack_plain

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIG = {"repro_iterate_validate": [_P] * 9 + [_I] * 9 + [_P],
        "repro_iterate_validate_bump": [_P] * 11 + [_I] * 7 + [_P]}


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
                           wave, fine: bool, bucket_size: int,
                           ext_cap: int,
                           point: Optional[torch.Tensor] = None,
                           wts: Optional[torch.Tensor] = None,
                           do: Optional[torch.Tensor] = None) -> torch.Tensor:
    if point is not None:
        out = iterate_validate_plain(table, keys, extents, groups, myprio,
                                     check, wave, fine, bucket_size,
                                     ext_cap) | point
        commit_install_plain(wts, keys, groups,
                             do & ~out.any(dim=1, keepdim=True))
        return out
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
                     myprio: torch.Tensor, check: torch.Tensor, wave,
                     fine: bool, bucket_size: int, ext_cap: int, *,
                     words: Optional[torch.Tensor] = None,
                     bit: int = 0, point: Optional[torch.Tensor] = None,
                     wts: Optional[torch.Tensor] = None,
                     do: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Phantom conflict flags, bool[T, K]; with ``words``, the flags
    OR-ed into bit ``bit`` of the packed verdict words, which it
    returns; with ``point``, ``wts`` and ``do``, ``point | phantom``,
    and ``wts`` bumped in place for the committed lanes' ``do`` ops.
    ``wave`` is a 0-d int64 tensor (or an int), read by the kernel on the
    device."""
    iterate_validate.calls += 1
    bump = point is not None
    if bump != (wts is not None) or bump != (do is not None):
        raise ValueError("iterate_validate: point, wts and do come together")
    if bump and (words is not None or keys.dim() != 2):
        raise ValueError(f"iterate_validate: the bump form takes keys [T, "
                         f"K] and no words, got keys {tuple(keys.shape)}")
    if words is not None and (bit not in (0, 1) or keys.dim() != 2):
        raise ValueError(f"iterate_validate: the words form takes bit 0 or "
                         f"1 and keys [D, M], got bit={bit} and keys "
                         f"{tuple(keys.shape)}")
    if keys.device.type == "cpu":
        out = iterate_validate_plain(table, keys, extents, groups, myprio,
                                     check, wave, fine, bucket_size, ext_cap,
                                     point, wts, do)
        if words is None:
            return out
        return words.bitwise_or_(verdict_pack_plain(out.to(torch.int8)
                                                    << bit))
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
    span = scan_span(ext_cap, fine, bucket_size)
    out, row, W = None, 0, 0
    if words is None:
        out = torch.empty(shape, dtype=torch.bool, device=dev)
    else:
        row, W = shape[1], n_words(shape[1])
        build.check("words", words, torch.int32, (shape[0], W), dev)
    if bump:
        build.check("point", point, torch.bool, shape, dev)
        build.check("do", do, torch.bool, shape, dev)
        build.check("wts", wts, torch.int32, (N, G), dev)
    w = build.scalar("wave", wave, dev)
    lib = build.load("iterate_validate", _SIG)
    with torch.cuda.device(dev):
        if bump:
            rc = lib.repro_iterate_validate_bump(
                build.ptr(table), build.ptr(keys), build.ptr(extents),
                build.ptr(groups), build.ptr(myprio), build.ptr(check),
                build.ptr(point), build.ptr(do), build.ptr(wts),
                build.ptr(out), build.ptr(w), shape[0], shape[1], N, G,
                int(bool(fine)), bucket_size, span, build.stream(dev))
        else:
            rc = lib.repro_iterate_validate(
                build.ptr(table), build.ptr(keys), build.ptr(extents),
                build.ptr(groups), build.ptr(myprio), build.ptr(check),
                build.ptr(out), build.ptr(words), build.ptr(w), keys.numel(),
                N, G, int(bool(fine)), bucket_size, span, row, W, bit,
                build.stream(dev))
    build.raise_on_error("iterate_validate", rc)
    iterate_validate.launches += 1
    return out if words is None else words


iterate_validate.launches = 0
iterate_validate.calls = 0
