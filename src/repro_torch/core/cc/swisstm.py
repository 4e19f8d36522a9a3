"""SwissTM-style CC: eager write locking, invisible reads with commit-time
validation, and a timestamp-based contention manager (port of
``repro/core/cc/swisstm.py``).

The contention manager favours the transaction that has retried longer:
the engine puts transaction age in the priority's high bits
(``claims.prio16(use_age=True)``), so the younger lane of a conflict
aborts.  Write-write conflicts are found eagerly, at the op taking the
write lock; read-write conflicts at commit-time validation, as in OCC.
Both share the writer-table compare of one ``claim_probe_commit``.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import claims
from repro_torch.core import types as t
from repro_torch.core.cc import base
from repro_torch.core.claimword import U32_MASK
from repro_torch.core.types import EngineConfig, StoreState, TxnBatch


def wave_validate(store: StoreState, batch: TxnBatch, prio,
                  wave: torch.Tensor, cfg: EngineConfig):
    fine = base.is_fine(cfg)
    live = batch.live()
    rd = batch.is_read() & live
    wr = batch.is_write() & live

    # Eager write-lock losses (phase-overlap thinned) and commit-time read
    # invalidations (window thinned, on a hash of its own) share check_w.
    T, K = batch.op_key.shape
    ids = claims.lane_op_ids(T, K, batch.op_key.device)
    uo = claims.hash01((wave + 77) & U32_MASK, ids)
    u = claims.hash01(wave, ids)
    check_w = ((wr & (u < cfg.cost.phase_overlap))
               | (rd & (uo < cfg.cost.opt_overlap)))
    store, conflict = base.claim_probe_commit(store, batch, prio, wave, cfg,
                                              fine, check_w=check_w)
    # rd and wr are disjoint, so a write op's conflict is an eager lock
    # loss (a lock wound); a read op's is a read-validation failure.
    ww = conflict & wr
    cause = torch.where(ww, t.CAUSE_LOCK_WOUND, t.CAUSE_READ_VAL)
    res = base.result_from_conflicts(batch, conflict, eager=True,
                                     cause_op=cause)
    # Only write conflicts cut work early.
    return store, dataclasses.replace(
        res, first_conflict=claims.first_true_index(ww, K))
