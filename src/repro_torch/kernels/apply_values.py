"""Serial replay of a wave's committed writes into the record values, and
the version ring's copy-forward before it.

No TPU kernel: the JAX package computes ``engine.apply_values``
(src/repro/core/engine.py:95) with a ``lax.scan`` over the lanes, not in
Pallas, and the ring's copy-forward in ``mvstore.install_values``
(src/repro/core/mvstore.py:118) with two index ops.  The port runs both
on the card as a kernel of its own, because the result has to be the
serial one bit for bit: on CUDA ``index_put_`` with duplicate indices
leaves an unspecified winner and ``index_add_`` adds in no fixed order,
and a loop of one small op per write is thousands of launches a wave.

Semantics (the JAX functions'): the lanes in ascending signed ``prio``
(int32; ties in lane order), a lane's ops in slot order; an op of a
committed lane whose kind is WRITE sets its cell to ``op_val``, an ADD
adds ``op_val`` to it (one float32 add).  Reads, NOPs, uncommitted lanes
and ops whose key lies outside ``[0, N)`` or whose column lies outside
``[-C, C)`` change nothing; a column in ``[-C, 0)`` counts from the end
(``col + C``), as the reference's indexing does.  The cell of an op is
``values[key, col]``, or with ``slot_of`` (int32[N], the multi-version
ring's new heads) ``values[key, slot_of[key], col]`` of a ring f32[N, D,
C]; a slot outside ``[-D, D)`` drops the op, one in ``[-D, 0)`` is
``slot + D``.  With ``head_old`` (int32[N], the ring's heads before the
wave's install) every committed WRITE or ADD whose key lies in ``[0, N)``
first copies its record's row, all columns, from slot ``head_old[key]``
to slot ``slot_of[key]`` (both wrapped as above; zeros from a source
slot outside ``[-D, D)``, nothing to a target slot outside it), then the
replay runs.  ``values`` is updated in place and returned.

CUDA tensors launch ``csrc/apply_values.cu``: one launch of 32 blocks,
each owning the records whose hash falls in its 32nd, which ranks the
lanes in shared memory, copies its records' rows forward, packs its ops
into a list in serial order, groups the list by cell in shared memory
keeping serial order within a cell, and walks each cell's ops from there
with one thread, one load and one store a cell.  That form takes up to
``BLOCK_MAX_OPS`` ops and ``BLOCK_MAX_LANES`` lanes, every wave the
engines track; a larger wave takes the grid form (``route``): a rank
launch, then the same replay over the serial order in chunks of 8,192.
No route sorts or reads a device value on the host.  CPU tensors take
``apply_values_plain``.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.core import types as t
from repro_torch.kernels import build

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIG = {"repro_apply_values": [_P] * 9 + [_I] * 5 + [_P],
        "repro_apply_values_grid": [_P] * 10 + [_I] * 5 + [_P]}

#: The one-launch form's limits: ops a wave (T * K) and lanes (T).
BLOCK_MAX_OPS = 8192
BLOCK_MAX_LANES = 1024
#: Cells (N * D * C) must stay below this: a cell is an int32 in the
#: kernel, its bit 31 the WRITE flag.
CELL_LIMIT = 1 << 31


def route(T: int, K: int) -> str:
    """The kernel form a wave of T lanes x K ops takes on the card:
    "block" (one launch) or "grid" (a rank launch, then the replay)."""
    return ("block" if T * K <= BLOCK_MAX_OPS and T <= BLOCK_MAX_LANES
            else "grid")


def _geometry(values: torch.Tensor, slot_of: Optional[torch.Tensor]):
    """(N, D, C) of the flat (D = 1) or the ring form."""
    if slot_of is None:
        N, C = values.shape
        return N, 1, C
    return tuple(values.shape)


def _wrap(i: torch.Tensor, n: int):
    """(index, valid): ``i`` in ``[-n, n)`` counted from the end once when
    negative, as the reference's indexing does; valid False outside."""
    return torch.where(i < 0, i + n, i), (i >= -n) & (i < n)


def _serial_ops(values, batch, commit, prio, slot_of):
    """The ops in serial order (lanes by ascending signed prio, stable;
    slots in order), flattened: (cell int64, active bool, is_write bool,
    val f32)."""
    N, D, C = _geometry(values, slot_of)
    kind = batch.op_kind
    key = batch.op_key.to(torch.int64)
    col, col_ok = _wrap(batch.op_col.to(torch.int64), C)
    act = (commit[:, None] & ((kind == t.WRITE) | (kind == t.ADD))
           & (key >= 0) & (key < N) & col_ok)
    k = torch.where(act, key, 0)
    slot = torch.zeros_like(k)
    if slot_of is not None:
        slot, slot_ok = _wrap(slot_of.to(torch.int64).index_select(
            0, k.reshape(-1)).view(k.shape), D)
        act = act & slot_ok
    cell = (k * D + torch.where(act, slot, 0)) * C + torch.where(act, col, 0)
    order = torch.argsort(prio.to(torch.int64), stable=True)
    return tuple(x.index_select(0, order).reshape(-1)
                 for x in (cell, act, kind == t.WRITE, batch.op_val))


def _copy_forward(vals, batch, commit, slot_of, head_old):
    """The ring's copy-forward of ``mvstore.install_values``: each
    committed write's record row from slot ``head_old`` to slot
    ``slot_of`` (zeros from a source slot outside the ring, nothing to a
    target slot outside it).  Writers of one row write the same bytes."""
    N, D, C = vals.shape
    key = batch.op_key.reshape(-1).to(torch.int64)
    do = ((commit[:, None] & batch.is_write()).reshape(-1)
          & (key >= 0) & (key < N))
    k = torch.where(do, key, 0)
    ho, ho_ok = _wrap(head_old.to(torch.int64).index_select(0, k), D)
    hn, hn_ok = _wrap(slot_of.to(torch.int64).index_select(0, k), D)
    idx = torch.nonzero(do & hn_ok).view(-1)
    rows = vals.view(N * D, C)
    src = (k * D + torch.where(ho_ok, ho, 0)).index_select(0, idx)
    old = torch.where(ho_ok.index_select(0, idx)[:, None],
                      rows.index_select(0, src), 0.0)
    rows.index_copy_(0, (k * D + hn).index_select(0, idx), old)


def apply_values_plain(values: torch.Tensor, batch: t.TxnBatch,
                       commit: torch.Tensor, prio: torch.Tensor,
                       slot_of: Optional[torch.Tensor] = None,
                       head_old: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """The serial replay itself (after the ring's copy-forward when
    ``head_old`` is given): the committed writes in serial order, one
    single-cell set or float32 add at a time."""
    if head_old is not None and slot_of is None:
        raise ValueError("apply_values: head_old needs slot_of (the ring)")
    flat = values.view(-1)
    if flat.numel() == 0:
        return values
    if head_old is not None:
        _copy_forward(values, batch, commit, slot_of, head_old)
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
                 slot_of: Optional[torch.Tensor] = None,
                 head_old: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Replay the committed writes of ``batch`` into ``values`` (f32[N, C],
    or the ring f32[N, D, C] with ``slot_of`` int32[N], after the ring's
    copy-forward from ``head_old`` int32[N] when given) in place, in the
    wave's serial order; returns ``values``.  ``commit`` is bool[T] and
    ``prio`` the lane priority int32[T]."""
    apply_values.calls += 1
    if batch.op_key.device.type == "cpu":
        return apply_values_plain(values, batch, commit, prio, slot_of,
                                  head_old)
    if head_old is not None and slot_of is None:
        raise ValueError("apply_values: head_old needs slot_of (the ring)")
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
    for name, h in (("slot_of", slot_of), ("head_old", head_old)):
        if h is not None:
            build.check(name, h, torch.int32, (N,), dev)
    if N * D * C >= CELL_LIMIT or T * K >= CELL_LIMIT:
        raise ValueError(f"apply_values: {N * D * C} cells and {T * K} ops "
                         "must each stay below 2^31, the kernel's int32 "
                         "index")
    lib = build.load("apply_values", _SIG)
    args = [build.ptr(x) for x in (batch.op_key, batch.op_col,
                                   batch.op_kind, batch.op_val, commit,
                                   prio, slot_of, head_old, values)]
    with torch.cuda.device(dev):
        if route(T, K) == "block":
            rc = lib.repro_apply_values(*args, T, K, N, D, C,
                                        build.stream(dev))
        else:
            lanes = torch.empty((T,), dtype=torch.int32, device=dev)
            rc = lib.repro_apply_values_grid(*args, build.ptr(lanes), T, K,
                                             N, D, C, build.stream(dev))
    build.raise_on_error("apply_values", rc)
    apply_values.launches += 1
    return values


apply_values.launches = 0
apply_values.calls = 0
