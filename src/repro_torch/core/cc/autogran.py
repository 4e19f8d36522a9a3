"""Auto-granularity OCC, the scheme the paper's section 5 asks for (port of
``repro/core/cc/autogran.py``).

Every record starts with a coarse (whole-row) timestamp.  A read that
aborts under the coarse rule but would not under the fine rule (the writer
hit another column group) is a false conflict: it heats the record, and
past ``autogran_up`` the record is promoted to fine timestamps for good.
The version table is always fine-width; promotion only changes the probe
width of the record (the ``fine_mode`` bit).

The write claims install and both probe widths come from one
``validate_dual`` call (its install form, the lane priority int32[T]).
With scans the version bumps ride the phantom pass's ``iterate_validate``
call (its bump form); on the point mix they go through
``commit_install``.
"""
from __future__ import annotations

import torch

from repro_torch.core import backend as kb
from repro_torch.core import claims
from repro_torch.core import types as t
from repro_torch.core.cc import base
from repro_torch.core.types import EngineConfig, StoreState, TxnBatch


def wave_validate(store: StoreState, batch: TxnBatch, prio,
                  wave: torch.Tensor, cfg: EngineConfig):
    keys = batch.op_key
    live = batch.live()
    # The write claims, then two probe widths from one row read per op on
    # the installed table: the record's fine_mode bit picks the verdict
    # that applies.
    check = batch.is_read() & live & ~batch.is_scan()
    do_w = batch.is_write() & live
    conflict_fine, conflict_coarse = kb.BACKEND.validate_dual(
        store.claim_w, keys, batch.op_group, prio, check, wave,
        install=do_w)

    k, valid = claims.record_index(keys, store.n_records)
    is_fine_rec = valid & store.fine_mode[k]
    conflict = torch.where(is_fine_rec, conflict_fine, conflict_coarse)
    T, K = keys.shape
    u = claims.hash01(wave, claims.lane_op_ids(T, K, keys.device))
    conflict = conflict & (u < cfg.cost.opt_overlap)   # window thinning
    scans = cfg.max_extent > 1
    if scans:
        # The phantom pass and the version bumps in one call: no code
        # below reads or writes wts.
        conflict = base.phantom_validate(store, batch, prio, wave, cfg,
                                         fine=False, point=conflict, do=do_w)
    res = base.result_from_conflicts(batch, conflict, eager=False,
                                     cause_op=t.CAUSE_READ_VAL)

    # False-conflict evidence: aborted under coarse, clean under fine.
    false_ev = conflict_coarse & ~conflict_fine & ~is_fine_rec
    claims.touch_heat(store.false_heat, store.heat_wave, keys,
                      torch.ones_like(batch.op_val), wave,
                      cfg.autogran_decay, false_ev)
    cur = claims.lazy_decayed(store.false_heat, store.heat_wave, keys, wave,
                              cfg.autogran_decay)
    promote = false_ev & (cur > cfg.autogran_up)
    claims.sink_scatter(store.fine_mode, keys, promote, promote)

    if not scans:
        store = base.bump_versions(store, batch, res.commit, cfg)
    return store, res
