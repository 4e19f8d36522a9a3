"""MV-OCC: serializable multi-version OCC, snapshot reads plus commit-time
read-set validation (port of ``repro/core/cc/mvocc.py``).

MVCC's snapshot isolation admits write skew; MV-OCC closes it: an UPDATE
transaction re-validates its point reads at commit (a read conflicts when
a strictly stronger lane wrote its cell this wave, the single-version OCC
probe) and its scans through the unthinned interval pass.  A READ-ONLY
transaction needs no validation: its snapshot is a consistent cut and it
serializes at its snapshot timestamp, so it never aborts on a writer.
Write-write conflicts, the ring install and reclamation aborts are
MVCC's (``cc/mvcc.py``).
"""
from __future__ import annotations

import torch

from repro_torch.core import claims
from repro_torch.core import types as t
from repro_torch.core.cc import base, mvcc
from repro_torch.core.types import EngineConfig, StoreState, TxnBatch


def wave_validate(store: StoreState, batch: TxnBatch, prio,
                  wave: torch.Tensor, cfg: EngineConfig):
    fine = base.is_fine(cfg)
    live = batch.live()
    rd = batch.is_read() & live
    T, K = batch.op_key.shape

    # Commit-time read validation, update transactions only: the point
    # reads ride the write-write check's validate call on the writer
    # channel.
    has_write = (batch.is_write() & live).any(dim=1)
    store, conflict, ok = mvcc.fcw_conflicts(
        store, batch, prio, wave, cfg,
        read_check=rd & ~batch.is_scan() & has_write[:, None])
    u = claims.hash01(wave, claims.lane_op_ids(T, K, batch.op_key.device))
    conflict = conflict & (u < cfg.cost.opt_overlap)   # window thinning
    # Scans of update transactions re-validate unthinned; read-only lanes
    # keep the snapshot exemption.
    conflict = conflict | base.phantom_validate(store, batch, prio, wave,
                                                cfg, fine,
                                                mask=has_write[:, None])
    # Snapshot visibility (the validate call's ring read).
    conflict = conflict | (rd & ~ok)

    # Disjoint channels: reclaimed snapshots (read, ~ok), first-committer-
    # wins losses (write), update-transaction read validation (read, ok).
    cause = torch.where(
        rd & ~ok, t.CAUSE_STALE_SNAPSHOT,
        torch.where(batch.is_write(), t.CAUSE_WW, t.CAUSE_READ_VAL))
    res = base.result_from_conflicts(batch, conflict, eager=False,
                                     cause_op=cause)
    store = mvcc.mv_commit(store, batch, res.commit, prio, wave, cfg)
    return store, res
