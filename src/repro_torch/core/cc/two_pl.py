"""2PL — reader-writer lock two-phase locking with non-waiting deadlock
prevention (port of ``repro/core/cc/two_pl.py``).

Reads and writes acquire locks during execution, so conflicts surface at
the op that fails to acquire and an aborted lane wastes only the work up
to that op (``eager=True`` in the cost model).  R/R is compatible; R/W,
W/R and W/W conflict, and the weaker lane of a conflicting pair aborts.
Both lock tables are acquired and probed by ``claim_probe_commit``: writer
locks through ``check_w``, reader locks through the dual ``check_r``
channel.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import claims
from repro_torch.core import types as t
from repro_torch.core.cc import base
from repro_torch.core.types import EngineConfig, StoreState, TxnBatch


def wave_validate(store: StoreState, batch: TxnBatch, prio,
                  wave: torch.Tensor, cfg: EngineConfig):
    fine = base.is_fine(cfg)
    live = batch.live()
    rd = batch.is_read() & live
    wr = batch.is_write() & live

    # Phase-overlap thinning: two conflicting lock holds overlap only part
    # of the time in real time.
    T, K = batch.op_key.shape
    u = claims.hash01(wave, claims.lane_op_ids(T, K, batch.op_key.device))
    lock_ok = u < cfg.cost.phase_overlap
    # read or write vs writer lock (check_w), write vs reader lock
    # (check_r).
    store, conflict = base.claim_probe_commit(
        store, batch, prio, wave, cfg, fine,
        check_w=(rd | wr) & lock_ok, check_r=wr & lock_ok, dual=True)
    # Every conflict is a failed eager lock acquisition: the weaker lane is
    # wounded.  Scan ops take no locks, so only lock losses cut work.
    res = base.result_from_conflicts(batch, conflict, eager=True,
                                     cause_op=t.CAUSE_LOCK_WOUND)
    first_lock = claims.first_true_index(conflict & ~batch.is_scan(), K)
    return store, dataclasses.replace(res, first_conflict=first_lock)
