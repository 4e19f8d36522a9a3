"""Ring-slot claim and version publish on the multi-version ring.

Replaces the TPU kernel ``mv_install_pallas``
(src/repro/kernels/mv_install.py); the semantics are the JAX oracle
``ref.mv_install``: for every record with at least one op whose ``do`` is
set (key inside ``[0, N)``), resolved against the PRE-wave head:

  h_new = (head[key] + 1) % D
  begin[key, h_new, :] = begin[key, head[key], :]   (carry forward)
  begin[key, h_new, g] = ts   for every such op's group g (in range)
  head[key] = h_new

so each written record gets exactly one new slot per wave, however many
ops write it.  ``begin`` and ``head`` are updated in place.  Precondition
(the engine keeps it): every begin of an installed-into record is
``MV_EMPTY`` or below ``ts``; the plain version checks it and raises, as
``ref.check_mv_begin_monotone`` does.

With ``words`` (the packed commit words of keys [D, M], as
``commit_install`` takes them) an op installs only where ``do`` is set
AND its 2-bit field is non-zero: the sharded MV owner's install, the
owner's ``verdict_unpack``, compare and mask folded into this launch.
The plain version of that form is that chain, then ``mv_install_plain``.

CUDA tensors launch ``csrc/mv_install.cu`` (one cooperative launch:
copy, a grid barrier, stamp); CPU tensors take ``mv_install_plain``.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.core.claimword import U32_MASK, to_i32, u32
from repro_torch.core.mvstore import MV_EMPTY
from repro_torch.kernels import build
from repro_torch.kernels.verdict_pack import check_words, \
    verdict_unpack_plain

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIG = {"repro_mv_install": [_P] * 8 + [_I] * 6 + [_P],
        "repro_mv_install_capacity": [ctypes.POINTER(ctypes.c_int)]}


def check_mv_begin_monotone(begin: torch.Tensor, keys: torch.Tensor,
                            do: torch.Tensor, ts) -> None:
    """Raise if a ring row that ``do`` installs into already holds a begin
    >= ``ts`` (other than ``MV_EMPTY``)."""
    N = begin.shape[0]
    m = do & (keys >= 0) & (keys < N)
    rows = u32(begin[keys[m].to(torch.int64)])
    bad = (rows != MV_EMPTY) & (rows >= (ts & U32_MASK))
    if bool(bad.any()):
        raise ValueError(
            f"mv_install precondition violated: {int(bad.sum())} begin "
            f"cell(s) in installed-into rows already hold >= ts={int(ts)}: "
            "install timestamps must advance strictly per wave "
            "(core/mvstore.install_ts)")


def mv_install_plain(begin: torch.Tensor, head: torch.Tensor,
                     keys: torch.Tensor, groups: torch.Tensor,
                     do: torch.Tensor, ts,
                     words: Optional[torch.Tensor] = None) -> None:
    if words is not None:
        do = do & (verdict_unpack_plain(words, keys.shape[1]) > 0)
    check_mv_begin_monotone(begin, keys, do, ts)
    N, D, G = begin.shape
    m = do & (keys >= 0) & (keys < N)
    k = keys[m].to(torch.int64)
    g = groups[m].to(torch.int64)
    h_old = head[k].to(torch.int64)
    h_new = torch.remainder(h_old + 1, D)
    # A head outside [0, D) reads a zero row, as the oracle's fill does.
    hv = (h_old >= 0) & (h_old < D)
    old = torch.where(hv[:, None], begin[k, torch.where(hv, h_old, 0)], 0)
    # Duplicates of a record copy the same pre-wave row and stamp the same
    # value, so the unordered writes are deterministic.
    begin[k, h_new] = old
    gv = (g >= 0) & (g < G)
    begin[k[gv], h_new[gv], g[gv]] = to_i32(
        torch.as_tensor(ts, device=begin.device))  # ts's int32 bit pattern
    head[k] = h_new.to(torch.int32)


def mv_install(begin: torch.Tensor, head: torch.Tensor, keys: torch.Tensor,
               groups: torch.Tensor, do: torch.Tensor, ts, *,
               words: Optional[torch.Tensor] = None) -> None:
    """In place: one new ring slot per record that a ``do`` op writes
    (with ``words``, a ``do`` op whose packed field is non-zero), stamped
    ``ts`` in the written groups.  ``ts`` is a 0-d int64 tensor (or an
    int), read by the kernel on the device."""
    mv_install.calls += 1
    row, W = check_words("mv_install", words, keys)
    if keys.device.type == "cpu":
        return mv_install_plain(begin, head, keys, groups, do, ts, words)
    dev = build.launch_device(keys)
    N, D, G = begin.shape
    shape = tuple(keys.shape)
    build.check("begin", begin, torch.int32, (N, D, G), dev)
    build.check("head", head, torch.int32, (N,), dev)
    build.check("keys", keys, torch.int32, shape, dev)
    build.check("groups", groups, torch.int32, shape, dev)
    build.check("do", do, torch.bool, shape, dev)
    stamp = build.scalar("ts", ts, dev)
    lib = build.load("mv_install", _SIG)
    n = keys.numel()
    with torch.cuda.device(dev):
        # A wave of more ops than the co-resident grid has threads keeps
        # the later ops' new slots in a scratch vector.
        scratch = None
        if n > capacity(lib, dev):
            scratch = torch.empty(shape, dtype=torch.int32, device=dev)
        rc = lib.repro_mv_install(
            build.ptr(begin), build.ptr(head), build.ptr(keys),
            build.ptr(groups), build.ptr(do), build.ptr(words),
            build.ptr(scratch), build.ptr(stamp), n, N, D, G, row, W,
            build.stream(dev))
    build.raise_on_error("mv_install", rc)
    mv_install.launches += 1


mv_install.launches = 0
mv_install.calls = 0


def capacity(lib: ctypes.CDLL, dev: torch.device) -> int:
    """Ops one launch of the kernel takes on ``dev`` without scratch: the
    threads of its co-resident grid (the library queries the occupancy
    once per device)."""
    ops = ctypes.c_int(0)
    with torch.cuda.device(dev):
        build.raise_on_error("mv_install", lib.repro_mv_install_capacity(
            ctypes.byref(ops)))
    return ops.value
