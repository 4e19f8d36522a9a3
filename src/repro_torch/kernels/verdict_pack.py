"""The sharded wave's verdict wire format: 2 bits per op, 16 ops a word.

Replaces the TPU kernels ``verdict_pack_pallas`` and
``verdict_unpack_pallas`` (src/repro/kernels/verdict_pack.py); the
semantics are the JAX oracles ``ref.verdict_pack`` / ``ref.verdict_unpack``:

- ``verdict_pack(v int8[D, M]) -> int32[D, ceil(M/16)]``: op j's low two
  bits land at bits ``2*(j % 16)`` and ``2*(j % 16) + 1`` of word
  ``j // 16``; the last word's unused fields are zero.
- ``verdict_unpack(words int32[D, W], n) -> int8[D, n]``: the inverse, the
  two bits of each op in the low bits of its byte (``W * 16 >= n``).

Each has a gather form, the one the sharded wave's sender calls once a
wave (core/distributed.py; the owner packs inside its claim launch and
unpacks inside its install launch):

- ``verdict_unpack(words, n, owner=, pos=, took=) -> int8[M]``: op i's
  field of row ``owner[i]`` at ``pos[i]``, 0 where ``took[i]`` is False or
  the coordinates lie outside ``[0, D) x [0, n)``: the full-row unpack,
  the gather at the routing coordinates and the mask, in one launch.
- ``verdict_pack(v, lane=) -> int32[D, ceil(M/16)]``: with ``v`` one byte
  a lane (bool or int8[T]) and ``lane`` int32[D, M] the lane each buffer
  cell carries (route_pack's lane channel; -1 or any id outside ``[0, T)``
  packs 0): ``verdict_pack(where(lane valid, v[lane], 0))`` in one launch.

Each form's plain version is the chain of plain ops it replaces.  Words
are uint32 bit patterns in int32 tensors (bit 31 set makes a word
negative); the plain versions widen to int64 before shifting.  CUDA
tensors launch ``csrc/verdict_pack.cu`` (one thread per output word or
byte); CPU tensors take the plain versions.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.core.claimword import to_i32, u32
from repro_torch.kernels import build

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIG = {"repro_verdict_pack": [_P] * 2 + [_I] * 3 + [_P],
        "repro_verdict_unpack": [_P] * 2 + [_I] * 3 + [_P],
        "repro_verdict_unpack_gather": [_P] * 5 + [_I] * 4 + [_P],
        "repro_verdict_pack_gather": [_P] * 3 + [_I] * 4 + [_P]}


def n_words(n_ops: int) -> int:
    """int32 words per row of ``n_ops`` verdicts."""
    return -(-n_ops // 16)


def check_words(name: str, words: Optional[torch.Tensor],
                keys: torch.Tensor) -> tuple:
    """(row, W) of another kernel's words form, (0, 0) without words;
    raises unless ``keys`` is [D, M] and ``words`` int32[D, ceil(M/16)]
    on its device."""
    if words is None:
        return 0, 0
    if keys.dim() != 2:
        raise ValueError(f"{name}: the words form takes keys [D, M], got "
                         f"{tuple(keys.shape)}")
    D, M = keys.shape
    build.check("words", words, torch.int32, (D, n_words(M)), keys.device)
    return M, n_words(M)


def verdict_pack_plain(v: torch.Tensor) -> torch.Tensor:
    D, M = v.shape
    W = n_words(M)
    vv = v.to(torch.int64) & 3
    vv = torch.nn.functional.pad(vv, (0, W * 16 - M)).view(D, W, 16)
    shifts = 2 * torch.arange(16, dtype=torch.int64, device=v.device)
    # Disjoint fields: the sum is the OR of the shifted ops.
    return to_i32((vv << shifts).sum(dim=-1))


def verdict_unpack_plain(words: torch.Tensor, n: int) -> torch.Tensor:
    j = torch.arange(n, dtype=torch.int64, device=words.device)
    w = u32(words)[:, j // 16]
    return ((w >> (2 * (j % 16))) & 3).to(torch.int8)


def verdict_unpack_gather_plain(words: torch.Tensor, n: int,
                                owner: torch.Tensor, pos: torch.Tensor,
                                took: torch.Tensor) -> torch.Tensor:
    """The full-row unpack, gathered at (owner, pos), 0 where not took."""
    D = words.shape[0]
    ok = took & (owner >= 0) & (owner < D) & (pos >= 0) & (pos < n)
    vv = verdict_unpack_plain(words, n)[
        torch.clamp(owner, 0, D - 1).to(torch.int64),
        torch.clamp(pos, 0, n - 1).to(torch.int64)]
    return torch.where(ok, vv, 0)


def verdict_pack_gather_plain(v: torch.Tensor, lane: torch.Tensor
                              ) -> torch.Tensor:
    """Each cell's lane byte (0 for an empty cell), then the pack."""
    T = v.shape[0]
    ok = (lane >= 0) & (lane < T)
    cells = v[torch.clamp(lane, 0, T - 1).to(torch.int64)].to(torch.int8)
    return verdict_pack_plain(torch.where(ok, cells, 0))


def verdict_pack(v: torch.Tensor, *,
                 lane: Optional[torch.Tensor] = None) -> torch.Tensor:
    """int8[D, M] verdict bytes -> int32[D, ceil(M/16)] wire words; with
    ``lane``, ``v`` holds one byte a lane and each cell packs its lane's."""
    verdict_pack.calls += 1
    if lane is not None:
        return _pack_gather(v, lane)
    if v.device.type == "cpu":
        return verdict_pack_plain(v)
    dev = build.launch_device(v)
    D, M = v.shape
    W = n_words(M)
    build.check("v", v, torch.int8, (D, M), dev)
    words = torch.empty((D, W), dtype=torch.int32, device=dev)
    lib = build.load("verdict_pack", _SIG)
    with torch.cuda.device(dev):
        rc = lib.repro_verdict_pack(build.ptr(v), build.ptr(words), D, M, W,
                                    build.stream(dev))
    build.raise_on_error("verdict_pack", rc)
    verdict_pack.launches += 1
    return words


def _pack_gather(v: torch.Tensor, lane: torch.Tensor) -> torch.Tensor:
    if v.dim() != 1 or lane.dim() != 2:
        raise ValueError(f"verdict_pack: the gather form takes v[T] and "
                         f"lane[D, M], got {tuple(v.shape)} and "
                         f"{tuple(lane.shape)}")
    if lane.device.type == "cpu":
        return verdict_pack_gather_plain(v, lane)
    dev = build.launch_device(lane)
    (T,), (D, M) = v.shape, lane.shape
    if v.dtype not in (torch.bool, torch.int8):
        raise TypeError(f"v has dtype {v.dtype}, expected bool or int8")
    build.check("v", v, v.dtype, (T,), dev)
    build.check("lane", lane, torch.int32, (D, M), dev)
    W = n_words(M)
    words = torch.empty((D, W), dtype=torch.int32, device=dev)
    lib = build.load("verdict_pack", _SIG)
    with torch.cuda.device(dev):
        rc = lib.repro_verdict_pack_gather(
            build.ptr(v), build.ptr(lane), build.ptr(words), T, D, M, W,
            build.stream(dev))
    build.raise_on_error("verdict_pack", rc)
    verdict_pack.launches += 1
    return words


def verdict_unpack(words: torch.Tensor, n: int, *,
                   owner: Optional[torch.Tensor] = None,
                   pos: Optional[torch.Tensor] = None,
                   took: Optional[torch.Tensor] = None) -> torch.Tensor:
    """int32[D, W] wire words -> int8[D, n] verdict bytes; with ``owner``,
    ``pos`` and ``took``, int8[M]: each op's byte at its coordinates."""
    verdict_unpack.calls += 1
    D, W = words.shape
    if W * 16 < n:
        raise ValueError(f"verdict_unpack: {W} words per row hold "
                         f"{W * 16} ops, fewer than n={n}")
    gather = (owner is not None, pos is not None, took is not None)
    if any(gather) and not all(gather):
        raise ValueError("verdict_unpack: owner, pos and took come "
                         "together")
    if all(gather):
        return _unpack_gather(words, n, owner, pos, took)
    if words.device.type == "cpu":
        return verdict_unpack_plain(words, n)
    dev = build.launch_device(words)
    build.check("words", words, torch.int32, (D, W), dev)
    out = torch.empty((D, n), dtype=torch.int8, device=dev)
    lib = build.load("verdict_pack", _SIG)
    with torch.cuda.device(dev):
        rc = lib.repro_verdict_unpack(build.ptr(words), build.ptr(out), D, W,
                                      n, build.stream(dev))
    build.raise_on_error("verdict_unpack", rc)
    verdict_unpack.launches += 1
    return out


def _unpack_gather(words, n, owner, pos, took) -> torch.Tensor:
    if owner.dim() != 1:
        raise ValueError(f"verdict_unpack: owner must be 1-D, got "
                         f"{tuple(owner.shape)}")
    if words.device.type == "cpu":
        return verdict_unpack_gather_plain(words, n, owner, pos, took)
    dev = build.launch_device(words)
    (D, W), (M,) = words.shape, owner.shape
    build.check("words", words, torch.int32, (D, W), dev)
    build.check("owner", owner, torch.int32, (M,), dev)
    build.check("pos", pos, torch.int32, (M,), dev)
    build.check("took", took, torch.bool, (M,), dev)
    out = torch.empty((M,), dtype=torch.int8, device=dev)
    lib = build.load("verdict_pack", _SIG)
    with torch.cuda.device(dev):
        rc = lib.repro_verdict_unpack_gather(
            build.ptr(words), build.ptr(owner), build.ptr(pos),
            build.ptr(took), build.ptr(out), M, D, W, n, build.stream(dev))
    build.raise_on_error("verdict_unpack", rc)
    verdict_unpack.launches += 1
    return out


verdict_pack.launches = 0
verdict_pack.calls = 0
verdict_unpack.launches = 0
verdict_unpack.calls = 0
