"""Serial replay of a wave's committed writes into the record values.

No TPU kernel: the JAX package computes ``engine.apply_values``
(src/repro/core/engine.py:95) with a ``lax.scan`` over the lanes, not in
Pallas.  The port runs it on the card as a kernel of its own, because
the result has to be the serial one bit for bit: on CUDA ``index_put_``
with duplicate indices leaves an unspecified winner and ``index_add_``
adds in no fixed order, and a loop of one small op per write is
thousands of launches a wave.

Semantics (the JAX function's): the lanes in ascending ``prio`` (ties in
lane order), a lane's ops in slot order; an op of a committed lane whose
kind is WRITE sets its cell to ``op_val``, an ADD adds ``op_val`` to it
(one float32 add).  Reads, NOPs, uncommitted lanes and ops whose key lies
outside ``[0, N)`` (or whose column lies outside ``[0, C)``) change
nothing.  The cell of an op is ``values[key, col]``, or with ``slot_of``
(int32[N], the multi-version ring's new heads) ``values[key,
slot_of[key], col]`` of a ring f32[N, D, C] (a slot outside ``[0, D)``
drops the op).  ``values`` is updated in place and returned.

CUDA tensors launch ``csrc/apply_values.cu``: one thread an op computes
its sort key ``cell * T * K + rank(prio) * K + slot`` (a sentinel for an
op that changes nothing), ``torch.sort`` orders the keys (sorting the
inputs is not the function), and one thread an op walks the ops of its
cell in that order where it is the cell's first, from the stored value,
and stores once.  The kernel route reads no device value on the host.
CPU tensors take ``apply_values_plain``.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.core import types as t
from repro_torch.core.claimword import U32_MASK
from repro_torch.kernels import build

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIG = {"repro_apply_values_keys": [_P] * 7 + [_I] * 5 + [_P],
        "repro_apply_values_walk": [_P] * 5 + [_I] + [_P]}

#: The largest sort key the kernel route forms: cell * T * K must fit in
#: an int64 below the sentinel.
_KEY_LIMIT = (1 << 63) - 1


def _geometry(values: torch.Tensor, slot_of: Optional[torch.Tensor]):
    """(N, D, C) of the flat (D = 1) or the ring form."""
    if slot_of is None:
        N, C = values.shape
        return N, 1, C
    return tuple(values.shape)


def _serial_ops(values, batch, commit, prio, slot_of):
    """The ops in serial order (lanes by ascending prio, stable; slots in
    order), flattened: (cell int64, active bool, is_write bool, val f32)."""
    N, D, C = _geometry(values, slot_of)
    kind = batch.op_kind
    key = batch.op_key.to(torch.int64)
    col = batch.op_col.to(torch.int64)
    act = (commit[:, None] & ((kind == t.WRITE) | (kind == t.ADD))
           & (key >= 0) & (key < N) & (col >= 0) & (col < C))
    k = torch.where(act, key, 0)
    slot = torch.zeros_like(k)
    if slot_of is not None:
        slot = slot_of.to(torch.int64).index_select(0, k.reshape(-1)) \
            .view(k.shape)
        act = act & (slot >= 0) & (slot < D)
        slot = torch.where(act, slot, 0)
    cell = (k * D + slot) * C + torch.where(act, col, 0)
    order = torch.argsort(prio.to(torch.int64) & U32_MASK, stable=True)
    return tuple(x.index_select(0, order).reshape(-1)
                 for x in (cell, act, kind == t.WRITE, batch.op_val))


def apply_values_plain(values: torch.Tensor, batch: t.TxnBatch,
                       commit: torch.Tensor, prio: torch.Tensor,
                       slot_of: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """The serial replay itself: the committed writes in serial order, one
    single-cell set or float32 add at a time."""
    flat = values.view(-1)
    if flat.numel() == 0:
        return values
    cell, act, is_w, val = _serial_ops(values, batch, commit, prio, slot_of)
    idx = torch.nonzero(act).view(-1)
    for j, c, w in zip(idx.tolist(), cell[idx].tolist(), is_w[idx].tolist()):
        if w:
            flat[c:c + 1].copy_(val[j:j + 1])
        else:
            flat[c:c + 1].add_(val[j:j + 1])
    return values


def apply_values(values: torch.Tensor, batch: t.TxnBatch,
                 commit: torch.Tensor, prio: torch.Tensor,
                 slot_of: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Replay the committed writes of ``batch`` into ``values`` (f32[N, C],
    or the ring f32[N, D, C] with ``slot_of`` int32[N]) in place, in the
    wave's serial order; returns ``values``.  ``commit`` is bool[T] and
    ``prio`` the lane priority int32[T]."""
    apply_values.calls += 1
    if batch.op_key.device.type == "cpu":
        return apply_values_plain(values, batch, commit, prio, slot_of)
    dev = build.launch_device(batch.op_key)
    N, D, C = _geometry(values, slot_of)
    T, K = batch.op_key.shape
    build.check("values", values, torch.float32,
                (N, C) if slot_of is None else (N, D, C), dev)
    for name in ("op_key", "op_col", "op_kind"):
        build.check(name, getattr(batch, name), torch.int32, (T, K), dev)
    build.check("op_val", batch.op_val, torch.float32, (T, K), dev)
    build.check("commit", commit, torch.bool, (T,), dev)
    build.check("prio", prio, torch.int32, (T,), dev)
    if slot_of is not None:
        build.check("slot_of", slot_of, torch.int32, (N,), dev)
    n = T * K
    if N * D * C * n >= _KEY_LIMIT:
        raise ValueError(f"apply_values: {N * D * C} cells x {n} ops do "
                         "not fit the kernel's int64 sort key")
    lib = build.load("apply_values", _SIG)
    keys = torch.empty((n,), dtype=torch.int64, device=dev)
    with torch.cuda.device(dev):
        rc = lib.repro_apply_values_keys(
            build.ptr(batch.op_key), build.ptr(batch.op_col),
            build.ptr(batch.op_kind), build.ptr(commit), build.ptr(prio),
            build.ptr(slot_of), build.ptr(keys), T, K, N, D, C,
            build.stream(dev))
        build.raise_on_error("apply_values", rc)
        ordered, perm = torch.sort(keys)
        rc = lib.repro_apply_values_walk(
            build.ptr(ordered), build.ptr(perm), build.ptr(batch.op_kind),
            build.ptr(batch.op_val), build.ptr(values), n,
            build.stream(dev))
    build.raise_on_error("apply_values", rc)
    apply_values.launches += 1
    return values


apply_values.launches = 0
apply_values.calls = 0
