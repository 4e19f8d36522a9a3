"""MVCC: multi-version snapshot isolation with first-committer-wins
(Hekaton-style; port of ``repro/core/cc/mvcc.py``).

Reads never block and never abort on a writer: every read takes the newest
version of its (record, group) visible at the transaction's snapshot from
the version ring of ``core/mvstore.py`` (``mv_gather``'s select, which the
wave runs inside its ``validate`` call). The only in-wave conflicts are
write-write: of the concurrent writers of a cell the strongest lane commits,
the rest abort, judged on the wave-scoped claim tables. Blind ADDs commute:
an ADD probes a second channel, the reader-claim table, into which only
plain WRITEs install (the MV mechanisms take no read locks).
Granularity is the usual switch, one level down: fine makes both the
write-write rule and version visibility per column group.

A read aborts only when its snapshot predates every retained slot
(``snapshot_age`` beyond the ring's depth): the select's ok flag.
Scans read a consistent cut of the snapshot and are never re-validated
(snapshot isolation admits phantoms, as it admits write skew).  Committed
writes claim one ring slot per record per wave (``mv_install``); with
tracked values the new slots get their values too
(``mvstore.install_values``).
"""
from __future__ import annotations

import torch

from repro_torch.core import backend as kb
from repro_torch.core import claims, mvstore
from repro_torch.core import types as t
from repro_torch.core.cc import base
from repro_torch.core.ranges import named_range
from repro_torch.core.types import EngineConfig, StoreState, TxnBatch


def fcw_conflicts(store: StoreState, batch: TxnBatch, prio,
                  wave: torch.Tensor, cfg: EngineConfig, read_check=None):
    """(store, conflict bool[T, K], ok bool[T, K]): first-committer-wins
    write-write verdicts, shared by MVCC and MV-OCC, and the snapshot
    read's visibility.  Installs both claim channels (every write into
    the writer table, plain WRITEs into the reader table), then a plain
    WRITE conflicts with any stronger writer of its cell, an ADD only with
    a stronger plain WRITE.  ``read_check`` (MV-OCC's update-transaction
    point reads) adds ops checked against the writer channel as plain
    WRITEs are; the masks are disjoint by op kind.  ``ok`` is False where
    no ring slot is visible at the wave's snapshot (the version was
    reclaimed).  The installs, the checks and the ring read are one
    ``validate`` call, which takes the lane priority itself; the tables
    are updated in place, the ring only read."""
    live = batch.live()
    pw = batch.is_plain_write() & live
    check_w = pw if read_check is None else pw | read_check
    conflict, ok = kb.BACKEND.validate(
        store.claim_w, batch.op_key, batch.op_group, prio, check_w, wave,
        base.is_fine(cfg), claim_r=store.claim_r,
        check_r=batch.is_add() & live, install_w=batch.is_write() & live,
        install_r=pw, begin=store.mv_begin,
        snap_ts=mvstore.snapshot_ts(wave, cfg.snapshot_age))
    return store, conflict, ok


def mv_commit(store: StoreState, batch: TxnBatch, commit: torch.Tensor,
              prio, wave: torch.Tensor, cfg: EngineConfig) -> StoreState:
    """Install the wave's committed writes into the version ring: one slot
    per written record (``mv_install``), in place, plus the slots' values
    when values are tracked.  ``mv_install`` moves the heads in place, so
    a tracked wave copies them first: ``install_values`` reads both."""
    do = batch.is_write() & batch.live() & commit[:, None]
    head_old = store.mv_head.clone() if cfg.track_values else None
    with named_range("mv_install"):
        kb.BACKEND.mv_install(store.mv_begin, store.mv_head, batch.op_key,
                              batch.op_group, do, mvstore.install_ts(wave))
    if cfg.track_values:
        mvstore.install_values(store.mv_vals, head_old, store.mv_head,
                               batch, commit, prio)
    return store


def wave_validate(store: StoreState, batch: TxnBatch, prio,
                  wave: torch.Tensor, cfg: EngineConfig):
    rd = batch.is_read() & batch.live()
    T, K = batch.op_key.shape

    store, conflict, ok = fcw_conflicts(store, batch, prio, wave, cfg)
    u = claims.hash01(wave, claims.lane_op_ids(T, K, batch.op_key.device))
    conflict = conflict & (u < cfg.cost.opt_overlap)   # window thinning

    # Snapshot visibility; a reclaimed snapshot aborts, unthinned (it is
    # store state, not a racing window).
    conflict = conflict | (rd & ~ok)

    # Write ops lose first-committer-wins; the only read-side abort is
    # ring reclamation.
    cause = torch.where(rd & ~ok, t.CAUSE_STALE_SNAPSHOT, t.CAUSE_WW)
    res = base.result_from_conflicts(batch, conflict, eager=False,
                                     cause_op=cause)
    store = mv_commit(store, batch, res.commit, prio, wave, cfg)
    return store, res
