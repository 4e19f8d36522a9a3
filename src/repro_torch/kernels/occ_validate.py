"""Read validation against claim tables: one verdict at one granularity
(``validate``, on one table or, per op, on one or two of a pair of
tables) or fine and coarse verdicts from one row read (``validate_dual``).

Replaces the TPU kernels ``occ_validate_pallas`` and
``occ_validate_dual_pallas`` (src/repro/kernels/occ_validate.py); the
semantics are the JAX oracles ``ref.occ_validate`` and
``ref.occ_validate_dual``: per op,

  fine   = check & (live prio16 of the op's own cell        < myprio)
  coarse = check & (min live prio16 over the record's row   < myprio)

``validate`` returns the one its ``fine`` flag names, ``validate_dual``
both.  A masked key gives no conflict; an out-of-range group gives none
on the fine side (the oracle's fill reads as no claimant).  The tables
are only read.

``validate`` takes an optional second channel (``claim_r``,
``check_r``): it then returns ``(check & verdict(claim_w)) | (check_r &
verdict(claim_r))`` per op, in one launch.  With the second channel it
also takes the wave's two claim installs (``install_w``, ``install_r``):
first, for every op with ``install_w`` (``install_r``) set and its cell
in the table, ``claim_w`` (``claim_r``) ``[key, group] = min(...,
(inv_wave << 16) | prio16)`` in place, as ``claim_scatter`` does; then
the check on the installed tables.  ``myprio`` is then the lane priority
int32[T] (op i of lane t is checked against ``myprio[t]``), not the
per-op int32[T, K].  The multi-version waves install both claim channels
and validate their writes against both, and MV-OCC its reads against
the writer table, with this one call (``cc/mvcc.py``, ``cc/mvocc.py``).
That form also takes the version ring (``begin`` int32[N, D, G], the
snapshot ``snap_ts``): it then returns ``(conflict, ok)``, ``ok`` bool[T,
K] being ``mv_gather(begin, keys, groups, snap_ts, fine)[1]`` for every
op, the wave's snapshot read folded into the same launch.

``validate_dual`` takes AutoGran's write-claim install the same way
(``install``): first, for every op with ``install`` set and its cell in
the table, ``claim_w[key, group] = min(..., (inv_wave << 16) | prio16)``
in place, then both verdicts on the installed table, ``myprio`` the lane
priority int32[T].  AutoGran's wave makes that one call
(``cc/autogran.py``).

CUDA tensors launch ``csrc/occ_validate.cu``: one thread per op reading the
rows its checks name, and with the installs one cooperative launch
(installs, a grid barrier, the check); CPU tensors take the plain versions
(with the installs: ``claim_scatter_plain`` on each table, then the check,
then ``mv_gather_plain`` with the ring). The file's third TPU kernel,
``claim_probe_pallas``, is the ``probe`` op (``kernels/claim_probe.py``).
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.core.claimword import NO_PRIO, inv_wave, live_prio, u32
from repro_torch.kernels import build
from repro_torch.kernels.claim_scatter import claim_scatter_plain
from repro_torch.kernels.mv_gather import mv_gather_plain
from repro_torch.kernels.scatter import gather_rows, pick_group

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIG = {"repro_validate_dual": [_P] * 8 + [_I] * 3 + [_P],
        "repro_validate_dual_install": [_P] * 9 + [_I] * 4 + [_P],
        "repro_validate": [_P] * 7 + [_I] * 4 + [_P],
        "repro_validate_pair": [_P] * 9 + [_I] * 4 + [_P],
        "repro_validate_install": [_P] * 14 + [_I] * 6 + [_P]}


def validate_plain(claim_w: torch.Tensor, keys: torch.Tensor,
                   groups: torch.Tensor, myprio: torch.Tensor,
                   check: torch.Tensor, wave, fine: bool,
                   claim_r: Optional[torch.Tensor] = None,
                   check_r: Optional[torch.Tensor] = None,
                   install_w: Optional[torch.Tensor] = None,
                   install_r: Optional[torch.Tensor] = None,
                   begin: Optional[torch.Tensor] = None,
                   snap_ts=None):
    if begin is not None:
        conflict = validate_plain(claim_w, keys, groups, myprio, check, wave,
                                  fine, claim_r, check_r, install_w,
                                  install_r)
        return conflict, mv_gather_plain(begin, keys, groups, snap_ts,
                                         fine)[1]
    if install_w is not None:
        myprio = myprio[:, None].expand(keys.shape)
        claim_scatter_plain(claim_w, keys, groups, myprio, wave, install_w)
        claim_scatter_plain(claim_r, keys, groups, myprio, wave, install_r)
    if claim_r is not None:
        return (validate_plain(claim_w, keys, groups, myprio, check, wave,
                               fine)
                | validate_plain(claim_r, keys, groups, myprio, check_r,
                                 wave, fine))
    rows, valid = gather_rows(claim_w, keys)
    pr = torch.where(valid[..., None], live_prio(rows, inv_wave(wave)),
                     NO_PRIO)
    wprio = pick_group(pr, groups, NO_PRIO) if fine else pr.amin(dim=-1)
    return check & (wprio < u32(myprio))


def validate(claim_w: torch.Tensor, keys: torch.Tensor, groups: torch.Tensor,
             myprio: torch.Tensor, check: torch.Tensor, wave,
             fine: bool, claim_r: Optional[torch.Tensor] = None,
             check_r: Optional[torch.Tensor] = None,
             install_w: Optional[torch.Tensor] = None,
             install_r: Optional[torch.Tensor] = None,
             begin: Optional[torch.Tensor] = None,
             snap_ts=None):
    """Conflict flags bool[T, K]: checked ops whose cell (fine) or row
    (coarse) a strictly stronger lane claimed this wave in ``claim_w``,
    or, with the second channel, ``check_r`` ops whose cell or row a
    stronger lane claimed in ``claim_r``.  With ``install_w`` and
    ``install_r`` the call first installs those ops' claims into the two
    tables (in place) and ``myprio`` is the lane priority int32[T]; with
    the ring ``begin`` and ``snap_ts`` as well it returns (conflict, ok),
    ``ok`` the snapshot read's visibility flag per op.  ``wave`` and
    ``snap_ts`` are 0-d int64 tensors (or ints), read by the kernel on the
    device."""
    validate.calls += 1
    if (claim_r is None) != (check_r is None):
        raise ValueError("validate: claim_r and check_r come together")
    installs = install_w is not None
    if installs != (install_r is not None) or (installs and claim_r is None):
        raise ValueError("validate: install_w and install_r come together, "
                         "with claim_r and check_r")
    ring = begin is not None
    if ring != (snap_ts is not None) or (ring and not installs):
        raise ValueError("validate: begin and snap_ts come together, with "
                         "the installs")
    if installs and keys.dim() != 2:
        raise ValueError("validate: the installs take keys of shape [T, K]")
    if keys.device.type == "cpu":
        return validate_plain(claim_w, keys, groups, myprio, check, wave,
                              fine, claim_r, check_r, install_w, install_r,
                              begin, snap_ts)
    dev = build.launch_device(keys)
    N, G = claim_w.shape
    shape = tuple(keys.shape)
    build.check("claim_w", claim_w, torch.int32, (N, G), dev)
    build.check("keys", keys, torch.int32, shape, dev)
    build.check("groups", groups, torch.int32, shape, dev)
    build.check("myprio", myprio, torch.int32,
                shape[:1] if installs else shape, dev)
    build.check("check", check, torch.bool, shape, dev)
    out = torch.empty(shape, dtype=torch.bool, device=dev)
    ok, ts, D = None, None, 0
    w = build.scalar("wave", wave, dev)
    lib = build.load("occ_validate", _SIG)
    with torch.cuda.device(dev):
        if installs:
            build.check("claim_r", claim_r, torch.int32, (N, G), dev)
            build.check("check_r", check_r, torch.bool, shape, dev)
            build.check("install_w", install_w, torch.bool, shape, dev)
            build.check("install_r", install_r, torch.bool, shape, dev)
            if ring:
                _, D, _ = begin.shape
                build.check("begin", begin, torch.int32, (N, D, G), dev)
                ok = torch.empty(shape, dtype=torch.bool, device=dev)
                ts = build.scalar("snap_ts", snap_ts, dev)
            rc = lib.repro_validate_install(
                build.ptr(claim_w), build.ptr(claim_r), build.ptr(keys),
                build.ptr(groups), build.ptr(myprio), build.ptr(install_w),
                build.ptr(install_r), build.ptr(check), build.ptr(check_r),
                build.ptr(out), build.ptr(begin), build.ptr(ok), build.ptr(w),
                build.ptr(ts), shape[0], shape[1], N, G, D, int(bool(fine)),
                build.stream(dev))
        elif claim_r is None:
            rc = lib.repro_validate(
                build.ptr(claim_w), build.ptr(keys), build.ptr(groups),
                build.ptr(myprio), build.ptr(check), build.ptr(out),
                build.ptr(w), keys.numel(), N, G, int(bool(fine)),
                build.stream(dev))
        else:
            build.check("claim_r", claim_r, torch.int32, (N, G), dev)
            build.check("check_r", check_r, torch.bool, shape, dev)
            rc = lib.repro_validate_pair(
                build.ptr(claim_w), build.ptr(claim_r), build.ptr(keys),
                build.ptr(groups), build.ptr(myprio), build.ptr(check),
                build.ptr(check_r), build.ptr(out), build.ptr(w),
                keys.numel(), N, G, int(bool(fine)), build.stream(dev))
    build.raise_on_error("validate", rc)
    validate.launches += 1
    return (out, ok) if ring else out


validate.launches = 0
validate.calls = 0


def validate_dual_plain(claim_w: torch.Tensor, keys: torch.Tensor,
                        groups: torch.Tensor, myprio: torch.Tensor,
                        check: torch.Tensor, wave,
                        install: Optional[torch.Tensor] = None):
    if install is not None:
        myprio = myprio[:, None].expand(keys.shape)
        claim_scatter_plain(claim_w, keys, groups, myprio, wave, install)
    rows, valid = gather_rows(claim_w, keys)
    pr = torch.where(valid[..., None], live_prio(rows, inv_wave(wave)),
                     NO_PRIO)
    p = u32(myprio)
    fine = check & (pick_group(pr, groups, NO_PRIO) < p)
    coarse = check & (pr.amin(dim=-1) < p)
    return fine, coarse


def validate_dual(claim_w: torch.Tensor, keys: torch.Tensor,
                  groups: torch.Tensor, myprio: torch.Tensor,
                  check: torch.Tensor, wave,
                  install: Optional[torch.Tensor] = None):
    """(fine, coarse) conflict flags, bool[T, K] each.  With ``install``
    the call first installs those ops' write claims into ``claim_w`` (in
    place) and ``myprio`` is the lane priority int32[T].  ``wave`` is a
    0-d int64 tensor (or an int), read by the kernel on the device."""
    validate_dual.calls += 1
    want = tuple(keys.shape[:1]) if install is not None else \
        tuple(keys.shape)
    if (install is not None and keys.dim() != 2) or \
            tuple(myprio.shape) != want:
        raise ValueError(f"validate_dual: myprio is the lane priority [T] "
                         f"with install (keys [T, K]), else per op; got "
                         f"myprio {tuple(myprio.shape)}, keys "
                         f"{tuple(keys.shape)}, install "
                         f"{install is not None}")
    if keys.device.type == "cpu":
        return validate_dual_plain(claim_w, keys, groups, myprio, check, wave,
                                   install)
    dev = build.launch_device(keys)
    N, G = claim_w.shape
    shape = tuple(keys.shape)
    build.check("claim_w", claim_w, torch.int32, (N, G), dev)
    build.check("keys", keys, torch.int32, shape, dev)
    build.check("groups", groups, torch.int32, shape, dev)
    build.check("myprio", myprio, torch.int32, want, dev)
    build.check("check", check, torch.bool, shape, dev)
    fine = torch.empty(shape, dtype=torch.bool, device=dev)
    coarse = torch.empty(shape, dtype=torch.bool, device=dev)
    w = build.scalar("wave", wave, dev)
    lib = build.load("occ_validate", _SIG)
    with torch.cuda.device(dev):
        if install is not None:
            build.check("install", install, torch.bool, shape, dev)
            rc = lib.repro_validate_dual_install(
                build.ptr(claim_w), build.ptr(keys), build.ptr(groups),
                build.ptr(myprio), build.ptr(install), build.ptr(check),
                build.ptr(fine), build.ptr(coarse), build.ptr(w), shape[0],
                shape[1], N, G, build.stream(dev))
        else:
            rc = lib.repro_validate_dual(
                build.ptr(claim_w), build.ptr(keys), build.ptr(groups),
                build.ptr(myprio), build.ptr(check), build.ptr(fine),
                build.ptr(coarse), build.ptr(w), keys.numel(), N, G,
                build.stream(dev))
    build.raise_on_error("validate_dual", rc)
    validate_dual.launches += 1
    return fine, coarse


validate_dual.launches = 0
validate_dual.calls = 0
