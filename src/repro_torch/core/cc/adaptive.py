"""Adaptive reader-writer locking, the paper's mixed CC (port of
``repro/core/cc/adaptive.py``).

Each record is in an optimistic mode (reads validate at commit, the OCC
rule) or a pessimistic mode (strict reader-writer locks, the 2PL rule).
``pess_mode`` turns on when the record's abort heat exceeds ``adapt_up``
and off when it decays below ``adapt_down``; the heat decays lazily
(``claims.lazy_decayed``), so the state machine touches only the records
of the wave.

Both claim tables are acquired and probed by one ``claim_probe_commit``;
the reader table's install mask is narrowed to pessimistic records
(visible reads).  Optimistic reads carry the OCC window thinning,
pessimistic ops the 2PL phase-overlap thinning.
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
    keys = batch.op_key
    live = batch.live()
    rd = batch.is_read() & live
    wr = batch.is_write() & live

    k, valid = claims.record_index(keys, store.n_records)
    pess = valid & store.pess_mode[k]

    T, K = keys.shape
    ids = claims.lane_op_ids(T, K, keys.device)
    lock_ok = claims.hash01(wave, ids) < cfg.cost.phase_overlap
    uo = claims.hash01((wave + 77) & U32_MASK, ids)
    # Writer table: optimistic reads (OCC rule) and pessimistic r-lock and
    # w-lock vs w-lock; reader table: pessimistic w-lock vs r-lock.
    check_w = ((rd & ~pess & (uo < cfg.cost.opt_overlap))
               | ((rd | wr) & pess & lock_ok))
    store, conflict = base.claim_probe_commit(
        store, batch, prio, wave, cfg, fine, check_w=check_w,
        check_r=wr & pess & lock_ok, dual=True, do_r_mask=pess)
    # Pessimistic conflicts are failed eager lock acquisitions; optimistic
    # ones are commit-time read-validation failures.
    cause = torch.where(pess, t.CAUSE_LOCK_WOUND, t.CAUSE_READ_VAL)
    res = base.result_from_conflicts(batch, conflict, eager=True,
                                     cause_op=cause)
    # Only pessimistic ops cut work early; scans take no locks.
    first_pess = claims.first_true_index(conflict & pess & ~batch.is_scan(),
                                         K)
    pess_frac = ((pess & live).sum(dim=1).to(torch.float32)
                 / torch.clamp(batch.n_ops, min=1).to(torch.float32))
    res = dataclasses.replace(res, first_conflict=first_pess,
                              pess_frac=pess_frac)

    # Contention state machine, touched records only: conflicting ops heat
    # their records; every accessed record re-evaluates its mode.
    claims.touch_heat(store.abort_heat, store.heat_wave, keys,
                      torch.ones_like(batch.op_val), wave, cfg.adapt_decay,
                      conflict)
    cur = claims.lazy_decayed(store.abort_heat, store.heat_wave, keys, wave,
                              cfg.adapt_decay)
    new_mode = torch.where(cur > cfg.adapt_up, True,
                           torch.where(cur < cfg.adapt_down, False, pess))
    # Duplicate keys carry the same mode (it depends on the key only).
    claims.sink_scatter(store.pess_mode, keys, new_mode, live)
    return store, res
