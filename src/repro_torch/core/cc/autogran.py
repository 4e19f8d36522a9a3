"""Auto-granularity OCC, the scheme the paper's section 5 asks for (port of
``repro/core/cc/autogran.py``).

Every record starts with a coarse (whole-row) timestamp.  A read that
aborts under the coarse rule but would not under the fine rule (the writer
hit another column group) is a false conflict: it heats the record, and
past ``autogran_up`` the record is promoted to fine timestamps for good.
The version table is always fine-width; promotion only changes the probe
width of the record (the ``fine_mode`` bit).

Claims install with ``claim_scatter``; both probe widths come from one
``validate_dual`` call; the bumps go through ``commit_install``.
"""
from __future__ import annotations

import torch

from repro_torch.core import backend as kb
from repro_torch.core import claims
from repro_torch.core import types as t
from repro_torch.core.cc import base
from repro_torch.core.types import EngineConfig, StoreState, TxnBatch


def wave_validate(store: StoreState, batch: TxnBatch, prio, wave: int,
                  cfg: EngineConfig):
    keys = batch.op_key
    store = base.write_claims(store, batch, prio, wave, cfg)
    # Two probe widths, one claim table, one row read per op: the record's
    # fine_mode bit picks the verdict that applies.
    myp = base.my_prio_per_op(batch, prio)
    check = batch.is_read() & batch.live() & ~batch.is_scan()
    conflict_fine, conflict_coarse = kb.BACKEND.validate_dual(
        store.claim_w, keys, batch.op_group, myp, check, wave)

    k, valid = claims.record_index(keys, store.fine_mode.shape[0])
    is_fine_rec = valid & store.fine_mode[k]
    conflict = torch.where(is_fine_rec, conflict_fine, conflict_coarse)
    T, K = keys.shape
    u = claims.hash01(wave, claims.lane_op_ids(T, K, keys.device))
    conflict = conflict & (u < cfg.cost.opt_overlap)   # window thinning
    conflict = conflict | base.phantom_validate(store, batch, prio, wave,
                                                cfg, fine=False)
    res = base.result_from_conflicts(batch, conflict, eager=False,
                                     cause_op=t.CAUSE_READ_VAL)

    # False-conflict evidence: aborted under coarse, clean under fine.
    false_ev = conflict_coarse & ~conflict_fine & ~is_fine_rec
    claims.touch_heat(store.false_heat, store.heat_wave, keys,
                      torch.ones_like(batch.op_val), wave,
                      cfg.autogran_decay, false_ev)
    cur = claims.lazy_decayed(store.false_heat, store.heat_wave, keys, wave,
                              cfg.autogran_decay)
    promote = false_ev & (cur > cfg.autogran_up) & valid
    store.fine_mode[k[promote]] = True

    store = base.bump_versions(store, batch, res.commit, cfg)
    return store, res
