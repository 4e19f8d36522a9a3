"""Fixed-capacity admission queue for the open-loop traffic front-end (port
of ``repro/core/admission.py``).

Closed-loop benchmarks (the paper's) pin one transaction per lane and
retry it in place; open-loop traffic arrives on a Poisson schedule
(workloads/arrivals.py), queues for admission into the next wave, and an
abort re-enqueues the SAME transaction — same read/write set, incremented
**incarnation** counter — until it commits or exceeds ``max_incarnations``
(then it is dropped, and counted).  This module is the queue: a
fixed-capacity ring of transaction entries whose every operation is a
fixed-shape gather or select on the device, so a wave never waits for the
host.

Ring discipline
---------------
``head``/``size`` scalars index a capacity-``C`` ring.  Within one wave:

  1. ``enqueue`` the wave's arrivals (admit_wave = now, incarnation 0).
     Arrivals beyond the free space overflow — dropped and counted.
  2. ``dequeue`` up to T entries into the lane grid (FIFO from ``head``).
  3. run the wave; committed lanes leave the system, recording
     ``time-to-commit = commit_wave - admit_wave + 1`` waves.
  4. ``enqueue`` the aborted lanes back (same ops, incarnation + 1) unless
     the new incarnation would exceed the cap.

Because arrivals enqueue BEFORE the dequeue and re-enqueues come after,
step 4 can never overflow: dequeuing d entries frees d slots and at most
d lanes abort.  So every admitted transaction is committed exactly once,
still queued, or dropped at the incarnation cap.

Counters, ``head`` and ``size`` are int64 scalar tensors and the
histogram int64, as the port's other counters; the entries keep the JAX
package's int32 and float32 columns.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import types as t
from repro_torch.core.types import TxnBatch

#: The ring's entry columns: TxnBatch's fields, then the open-loop
#: metadata.
_BATCH_COLS = ("op_key", "op_group", "op_col", "op_kind", "op_val",
               "txn_type", "n_ops", "op_extent")
_META_COLS = ("admit_wave", "incarnation", "txn_id")


@dataclasses.dataclass
class QueueState:
    """A capacity-C ring of queued transactions (C entries x K op slots).

    Entry fields mirror TxnBatch row for row — a re-enqueued transaction's
    ops are stored bit-identically to its first incarnation — plus
    ``admit_wave`` (the wave the transaction FIRST entered the queue;
    retries keep it), ``incarnation`` (0 on arrival, +1 per re-enqueue)
    and ``txn_id`` (unique admission serial).
    """
    op_key: torch.Tensor       # int32[C, K]
    op_group: torch.Tensor     # int32[C, K]
    op_col: torch.Tensor       # int32[C, K]
    op_kind: torch.Tensor      # int32[C, K]
    op_val: torch.Tensor       # f32[C, K]
    txn_type: torch.Tensor     # int32[C]
    n_ops: torch.Tensor        # int32[C]
    op_extent: torch.Tensor    # int32[C, K]
    admit_wave: torch.Tensor   # int32[C]
    incarnation: torch.Tensor  # int32[C]
    txn_id: torch.Tensor       # int32[C]
    head: torch.Tensor         # int64 scalar: ring read cursor
    size: torch.Tensor         # int64 scalar: live entries (never > cap)

    @property
    def cap(self) -> int:
        return self.op_key.shape[0]

    @property
    def slots(self) -> int:
        return self.op_key.shape[1]


def queue_init(cap: int, slots: int, device) -> QueueState:
    def i32(*shape, fill=0):
        return torch.full(shape, fill, dtype=torch.int32, device=device)
    zero = torch.zeros((), dtype=torch.int64, device=device)
    return QueueState(
        op_key=i32(cap, slots, fill=-1), op_group=i32(cap, slots),
        op_col=i32(cap, slots), op_kind=i32(cap, slots),
        op_val=torch.zeros((cap, slots), dtype=torch.float32, device=device),
        txn_type=i32(cap), n_ops=i32(cap), op_extent=i32(cap, slots, fill=1),
        admit_wave=i32(cap), incarnation=i32(cap), txn_id=i32(cap),
        head=zero, size=zero.clone())


def ring_enqueue(cap: int, head: torch.Tensor, size: torch.Tensor,
                 mask: torch.Tensor, tables: tuple, cols: tuple) -> tuple:
    """The one ring-append primitive: write masked lanes of each column in
    ``cols`` into the matching capacity-``cap`` ring table, packed by
    cumsum rank in ascending lane order; lanes past the free space are
    rejected.  Accepted lanes land in distinct slots, so each slot's
    writer is found with one max-scatter of lane indices and every table
    is rebuilt with a select (no out-of-range index, no host wait).
    Returns ``(tables', size', n_accepted, n_overflow)``."""
    m = mask.to(torch.int64)
    rank = torch.cumsum(m, 0) - m                # rank among masked lanes
    accept = mask & (rank < cap - size)
    slot = (head + size + rank) % cap
    lane = torch.arange(mask.shape[0], device=mask.device)
    writer = torch.full((cap,), -1, dtype=torch.int64, device=mask.device)
    writer = writer.scatter_reduce(0, torch.where(accept, slot, 0),
                                   torch.where(accept, lane, -1), "amax")
    hit = writer >= 0
    src = writer.clamp(min=0)
    tabs = tuple(
        torch.where(hit.view((cap,) + (1,) * (tab.dim() - 1)),
                    col.to(tab.dtype).index_select(0, src), tab)
        for tab, col in zip(tables, cols))
    n_acc = accept.sum()
    return tabs, size + n_acc, n_acc, m.sum() - n_acc


def enqueue(q: QueueState, batch: TxnBatch, admit_wave: torch.Tensor,
            incarnation: torch.Tensor, txn_id: torch.Tensor,
            mask: torch.Tensor) -> tuple:
    """Append ``batch`` lanes where ``mask`` into the ring, FIFO order.

    admit_wave/incarnation/txn_id: integer[T] per-lane metadata stored
    with the entry.  Lanes are packed in ascending lane order; once the
    ring is full the remaining masked lanes overflow (dropped, counted).
    Returns ``(q', n_accepted, n_overflow)``."""
    names = _BATCH_COLS + _META_COLS
    cols = tuple(getattr(batch, n) for n in _BATCH_COLS) + (
        admit_wave, incarnation, txn_id)
    tabs, size, n_acc, n_ovf = ring_enqueue(
        q.cap, q.head, q.size, mask, tuple(getattr(q, n) for n in names),
        cols)
    q = dataclasses.replace(q, size=size, **dict(zip(names, tabs)))
    return q, n_acc, n_ovf


def dequeue(q: QueueState, lanes: int, n_active=None) -> tuple:
    """Pop up to ``min(size, n_active)`` entries into a ``lanes``-wide
    TxnBatch (FIFO).  ``n_active`` (default ``lanes``) is the sweep
    runner's live-lane count: padded grid points fill only their real
    lane prefix.  Unfilled lanes carry the empty transaction (no ops, no
    claims).  Returns ``(q', batch, admit_wave, incarnation, txn_id,
    got)`` with ``got`` bool[lanes] marking filled lanes."""
    if n_active is None:
        n_active = lanes
    take = q.size.clamp(max=n_active)
    i = torch.arange(lanes, device=q.op_key.device)
    got = i < take
    pos = (q.head + i) % q.cap

    def pick(tab, fill):
        g = got.view((lanes,) + (1,) * (tab.dim() - 1))
        return torch.where(g, tab.index_select(0, pos), fill)

    fills = {"op_key": -1, "op_kind": t.NOP, "op_extent": 1}
    batch = TxnBatch(**{n: pick(getattr(q, n), fills.get(n, 0))
                        for n in _BATCH_COLS})
    admit_wave = pick(q.admit_wave, 0)
    incarnation = pick(q.incarnation, 0)
    txn_id = pick(q.txn_id, -1)
    q = dataclasses.replace(q, head=(q.head + take) % q.cap,
                            size=q.size - take)
    return q, batch, admit_wave, incarnation, txn_id, got


@dataclasses.dataclass
class OpenLoopState:
    """Open-loop front-end state carried from wave to wave (EngineState.ol):
    the admission queue plus the goodput-conservation counters and the
    per-class time-to-commit histogram."""
    queue: QueueState
    next_id: torch.Tensor        # int64: next admission serial number
    offered: torch.Tensor        # int64: Poisson arrivals offered (capped)
    admitted: torch.Tensor       # int64: arrivals accepted into the queue
    arrival_drops: torch.Tensor  # int64: arrivals lost to a full queue
    inc_drops: torch.Tensor      # int64: txns dropped past max_incarnations
    reenq_drops: torch.Tensor    # int64: re-enqueue overflow, structurally 0
    lat_hist: torch.Tensor       # int64[n_txn_types, lat_bins] time-to-
                                 #   commit histogram, bin = min(ttc, bins-1)

    @property
    def lat_bins(self) -> int:
        return self.lat_hist.shape[1]


def open_loop_init(cap: int, slots: int, n_txn_types: int, lat_bins: int,
                   device) -> OpenLoopState:
    def zero():
        return torch.zeros((), dtype=torch.int64, device=device)
    return OpenLoopState(
        queue=queue_init(cap, slots, device),
        next_id=zero(), offered=zero(), admitted=zero(),
        arrival_drops=zero(), inc_drops=zero(), reenq_drops=zero(),
        lat_hist=torch.zeros((n_txn_types, lat_bins), dtype=torch.int64,
                             device=device))


def record_commits(ol: OpenLoopState, txn_type: torch.Tensor,
                   ttc: torch.Tensor, commit: torch.Tensor) -> OpenLoopState:
    """Accumulate committed lanes' time-to-commit (waves, >= 1) into the
    per-class histogram; the last bin absorbs overflow."""
    bins = ol.lat_bins
    b = ttc.to(torch.int64).clamp(0, bins - 1)
    flat = txn_type.to(torch.int64) * bins + b
    hist = ol.lat_hist.reshape(-1).index_add(0, flat, commit.to(torch.int64))
    return dataclasses.replace(ol, lat_hist=hist.view_as(ol.lat_hist))


def record_ttc(lat_hist: torch.Tensor, ttc: torch.Tensor,
               commit: torch.Tensor) -> torch.Tensor:
    """Classless 1-D time-to-commit histogram: committed lanes land in
    ``min(ttc, bins - 1)`` (last bin = overflow); ``record_commits`` is
    the per-txn-class variant."""
    b = ttc.to(torch.int64).clamp(0, lat_hist.shape[0] - 1)
    return lat_hist.index_add(0, b, commit.to(lat_hist.dtype))


def ttc_percentiles(lat_hist, qs=(0.5, 0.99)) -> list:
    """Host-side percentile read-out of a time-to-commit histogram.

    lat_hist: int[n_classes, bins] with bin index == time-to-commit in
    waves (last bin = overflow).  Returns, per quantile in ``qs``, a list
    of per-class values in waves; a class with no commits reports 0.0.
    """
    h = (lat_hist.cpu().numpy() if isinstance(lat_hist, torch.Tensor)
         else np.asarray(lat_hist))
    out = []
    for q in qs:
        row = []
        for c in range(h.shape[0]):
            cum = np.cumsum(h[c])
            total = int(cum[-1]) if cum.size else 0
            if total == 0:
                row.append(0.0)
                continue
            row.append(float(int(np.searchsorted(cum,
                                                 np.ceil(q * total)))))
        out.append(row)
    return out
