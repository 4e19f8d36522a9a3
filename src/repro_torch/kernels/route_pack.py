"""The sharded wave's routing pack: stable per-destination buffers.

Replaces the TPU kernel ``route_pack_pallas``
(src/repro/kernels/route_pack.py); the semantics are the JAX oracle
``ref.route_pack``.  ``owner`` int32[M] gives each op's destination shard
and ``vals`` int32[W, M] its W payload channels.  Op i bound for ``d`` in
``[0, n_dest)`` has rank ``pos[i]`` = the number of earlier ops bound for
``d`` (the placement a stable argsort by owner gives, without the sort);
it lands at ``buf[:, d, pos[i]]`` when ``pos[i] < cap`` and is dropped
otherwise.  Returns ``(buf int32[W, n_dest, cap], pos int32[M], took
bool[M])``: ``took`` is False for dropped and masked ops (owner outside
``[0, n_dest)``), ``pos`` keeps the rank of a dropped op and is 0 for a
masked one, and cells no op fills hold ``fills[w]``.

CUDA tensors launch ``csrc/route_pack.cu``, one cooperative launch: a
grid of 256-op tiles (at most as many blocks as the card keeps resident)
counts its ops per destination, sums the counts after one grid barrier,
ranks its tiles with warp match masks and writes a share of the fill
cells.  The kernel takes at most ``MAX_CHANNELS`` channels and
``MAX_DESTINATIONS`` destinations.  CPU tensors take
``route_pack_plain``.
"""
from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from repro_torch.kernels import build

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIG = {"repro_route_pack": [_P] * 6 + [_I] * 4
        + [ctypes.POINTER(ctypes.c_int), _I, _P],
        "repro_route_pack_blocks": [_I, _I, ctypes.POINTER(ctypes.c_int)]}
#: Payload channels the kernel takes.
MAX_CHANNELS = 8
#: Destinations the kernel takes: its shared memory holds ten words each.
MAX_DESTINATIONS = 1024


def route_pack_plain(owner: torch.Tensor, vals: torch.Tensor, n_dest: int,
                     cap: int, fills: Sequence[int]):
    W, M = vals.shape
    d = torch.arange(n_dest, dtype=owner.dtype, device=owner.device)
    match = owner[None, :] == d[:, None]                  # [n_dest, M]
    m = match.to(torch.int64)
    prefix = torch.cumsum(m, dim=1) - m                   # rank within dest
    pos = torch.where(match, prefix, 0).sum(dim=0)
    took = (match & (prefix < cap)).any(dim=0)
    # Every taken op owns one cell; the rest land in a trimmed overflow
    # cell.
    slot = torch.where(took, owner.to(torch.int64) * cap + pos, n_dest * cap)
    buf = torch.tensor(list(fills), dtype=torch.int32, device=owner.device)
    buf = buf[:, None].repeat(1, n_dest * cap + 1)
    buf[:, slot[took]] = vals[:, took]
    return (buf[:, :-1].reshape(W, n_dest, cap).contiguous(),
            pos.to(torch.int32), took)


def route_pack(owner: torch.Tensor, vals: torch.Tensor, n_dest: int,
               cap: int, fills: Sequence[int]):
    """(buf int32[W, n_dest, cap], pos int32[M], took bool[M])."""
    route_pack.calls += 1
    W, M = vals.shape
    if len(fills) != W:
        raise ValueError(f"route_pack: {len(fills)} fills for {W} channels")
    if n_dest < 1 or cap < 0:
        raise ValueError(f"route_pack: n_dest={n_dest} must be >= 1 and "
                         f"cap={cap} >= 0")
    if owner.device.type == "cpu":
        return route_pack_plain(owner, vals, n_dest, cap, fills)
    dev = build.launch_device(owner)
    if W > MAX_CHANNELS:
        raise ValueError(f"route_pack: the kernel takes at most "
                         f"{MAX_CHANNELS} channels, got {W}")
    if n_dest > MAX_DESTINATIONS:
        raise ValueError(f"route_pack: the kernel takes at most "
                         f"MAX_DESTINATIONS={MAX_DESTINATIONS} "
                         f"destinations, got {n_dest}")
    build.check("owner", owner, torch.int32, (M,), dev)
    build.check("vals", vals, torch.int32, (W, M), dev)
    buf = torch.empty((W, n_dest, cap), dtype=torch.int32, device=dev)
    pos = torch.empty((M,), dtype=torch.int32, device=dev)
    took = torch.empty((M,), dtype=torch.bool, device=dev)
    c_fills = (ctypes.c_int * MAX_CHANNELS)(*[int(f) for f in fills])
    lib = build.load("route_pack", _SIG)
    blocks = ctypes.c_int(0)
    with torch.cuda.device(dev):
        build.raise_on_error("route_pack", lib.repro_route_pack_blocks(
            M, n_dest, ctypes.byref(blocks)))
        counts = torch.empty((blocks.value, n_dest), dtype=torch.int32,
                             device=dev)
        rc = lib.repro_route_pack(
            build.ptr(owner), build.ptr(vals), build.ptr(buf), build.ptr(pos),
            build.ptr(took), build.ptr(counts), M, W, n_dest, cap, c_fills,
            blocks.value, build.stream(dev))
    build.raise_on_error("route_pack", rc)
    route_pack.launches += 1
    return buf, pos, took


route_pack.launches = 0
route_pack.calls = 0
