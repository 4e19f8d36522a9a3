"""Per-op timestamp observation (TicToc's wts/rts reads).

Replaces the TPU kernel ``ts_gather_pallas`` (src/repro/kernels/ts_gather.py);
the semantics are the JAX oracle ``ref.ts_gather``: fine granularity reads
``table[key, group]``, coarse reads the row max (one timestamp per record);
masked ops (key outside ``[0, N)``) read 0.  Returns the uint32 bit
patterns as int32[T, K].

With ``rts``, ``rd``, ``wr`` and ``extent`` one call is a TicToc wave's
whole observation: both gathers (``table`` is wts) and the arithmetic the
wave did on them, as the JAX package's TicToc computes it in uint32
(src/repro/core/cc/tictoc.py):

  term      = wr ? (rts_op + 1) mod 2**32 : rd ? wts_op : 0
  commit_ts = max over the lane's ops of term              int64[T]
  ext_need  = rd & (commit_ts > rts_op) & (extent <= 1)    bool[T, K]

and returns ``(commit_ts, ext_need)``.

CUDA tensors launch ``csrc/ts_gather.cu`` (one thread per op; the TicToc
form one block per lane, one plain launch); CPU tensors take
``ts_gather_plain`` (the TicToc form ``tictoc_observe_plain``: the two
plain gathers, then the arithmetic).
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.core.claimword import U32_MASK, to_i32, u32
from repro_torch.kernels import build
from repro_torch.kernels.scatter import gather_rows, pick_group

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIG = {"repro_ts_gather": [_P] * 4 + [_I] * 4 + [_P],
        "repro_ts_gather_tictoc": [_P] * 9 + [_I] * 5 + [_P]}


def ts_gather_plain(table: torch.Tensor, keys: torch.Tensor,
                    groups: torch.Tensor, fine: bool) -> torch.Tensor:
    rows, valid = gather_rows(table, keys)
    v = pick_group(rows, groups, 0) if fine else rows.amax(dim=-1)
    return to_i32(torch.where(valid, v, 0))


def tictoc_observe_plain(wts: torch.Tensor, rts: torch.Tensor,
                         keys: torch.Tensor, groups: torch.Tensor, fine: bool,
                         rd: torch.Tensor, wr: torch.Tensor,
                         extent: torch.Tensor, gather=ts_gather_plain):
    """(commit_ts int64[T], ext_need bool[T, K]) as TicToc's wave computed
    them: two one-table gathers (``gather``, the plain one unless a
    timing passes another), then the arithmetic in int64 on the unsigned
    values, masked back to 32 bits."""
    wts_op = u32(gather(wts, keys, groups, fine))
    rts_op = u32(gather(rts, keys, groups, fine))
    ts_term = torch.where(wr, (rts_op + 1) & U32_MASK,
                          torch.where(rd, wts_op, 0))
    commit_ts = ts_term.amax(dim=1)
    ext_need = rd & (commit_ts[:, None] > rts_op) & (extent <= 1)
    return commit_ts, ext_need


def ts_gather(table: torch.Tensor, keys: torch.Tensor, groups: torch.Tensor,
              fine: bool, *, rts: Optional[torch.Tensor] = None,
              rd: Optional[torch.Tensor] = None,
              wr: Optional[torch.Tensor] = None,
              extent: Optional[torch.Tensor] = None):
    """int32[T, K] timestamp bit patterns observed per op; with ``rts``,
    ``rd``, ``wr`` and ``extent``, TicToc's (commit_ts, ext_need) in one
    call (module docstring)."""
    ts_gather.calls += 1
    tictoc = rts is not None
    if {tictoc} != {rd is not None, wr is not None, extent is not None}:
        raise ValueError("ts_gather: rts, rd, wr and extent come together")
    if tictoc and keys.dim() != 2:
        raise ValueError("ts_gather: the TicToc form takes keys of shape "
                         "[T, K]")
    if keys.device.type == "cpu":
        if tictoc:
            return tictoc_observe_plain(table, rts, keys, groups, fine, rd,
                                        wr, extent)
        return ts_gather_plain(table, keys, groups, fine)
    dev = build.launch_device(keys)
    N, G = table.shape
    shape = tuple(keys.shape)
    build.check("table", table, torch.int32, (N, G), dev)
    build.check("keys", keys, torch.int32, shape, dev)
    build.check("groups", groups, torch.int32, shape, dev)
    lib = build.load("ts_gather", _SIG)
    if tictoc:
        build.check("rts", rts, torch.int32, (N, G), dev)
        build.check("rd", rd, torch.bool, shape, dev)
        build.check("wr", wr, torch.bool, shape, dev)
        build.check("extent", extent, torch.int32, shape, dev)
        commit_ts = torch.empty(shape[:1], dtype=torch.int64, device=dev)
        out = torch.empty(shape, dtype=torch.bool, device=dev)
        with torch.cuda.device(dev):
            rc = lib.repro_ts_gather_tictoc(
                build.ptr(table), build.ptr(rts), build.ptr(keys),
                build.ptr(groups), build.ptr(rd), build.ptr(wr),
                build.ptr(extent), build.ptr(commit_ts), build.ptr(out),
                shape[0], shape[1], N, G, int(bool(fine)), build.stream(dev))
    else:
        out = torch.empty(shape, dtype=torch.int32, device=dev)
        with torch.cuda.device(dev):
            rc = lib.repro_ts_gather(
                build.ptr(table), build.ptr(keys), build.ptr(groups),
                build.ptr(out), keys.numel(), N, G, int(fine),
                build.stream(dev))
    build.raise_on_error("ts_gather", rc)
    ts_gather.launches += 1
    return (commit_ts, out) if tictoc else out


ts_gather.launches = 0
ts_gather.calls = 0
