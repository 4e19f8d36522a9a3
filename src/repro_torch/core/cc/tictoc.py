"""TicToc — time-traveling OCC (Yu et al., SIGMOD'16), wave-vectorized
(port of ``repro/core/cc/tictoc.py``).

Each (record, group) carries ``wts`` and ``rts``.  A transaction computes

    commit_ts = max( max_{reads} wts,  max_{writes} rts + 1 )

and a read aborts only when a stronger lane writes its cell this wave and
commit_ts exceeds the cell's rts, or when its rts-extension CAS meets
another writer's lock.  Extensions and installs are charged by same-cell
chain length (``segment_count``); timestamps move by monotone scatter-max
(``ts_install_max``, the wave's three installs in one call); the
observation is ``ts_gather`` (coarse = row max), whose TicToc form reads
both tables and returns ``commit_ts`` and the reads that need an
extension in one call; the claim/verdict pass is the fused
``wave_commit`` without bumps.

Timestamps are uint32 words; the arithmetic runs in int64 on their
unsigned values and is masked back to 32 bits.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import backend as kb
from repro_torch.core import claims
from repro_torch.core import types as t
from repro_torch.core.cc import base
from repro_torch.core.claimword import U32_MASK
from repro_torch.core.types import EngineConfig, StoreState, TxnBatch


def wave_validate(store: StoreState, batch: TxnBatch, prio,
                  wave: torch.Tensor, cfg: EngineConfig):
    be = kb.BACKEND
    fine = base.is_fine(cfg)
    keys, groups = batch.op_key, batch.op_group
    T, K = keys.shape
    live = batch.live()
    rd = batch.is_read() & live
    wr = batch.is_write() & live

    # (wts, rts) observation of the pre-wave tables (coarse = row max),
    # commit_ts over live ops (0 when no ops) and the point reads that need
    # room to time-travel (commit_ts > their rts), in one call.
    commit_ts, ext_need = be.ts_gather(store.wts, keys, groups, fine,
                                       rts=store.rts, rd=rd, wr=wr,
                                       extent=batch.op_extent)

    # Window-thinned checks of the stronger-writer channel and of the
    # failed-extension channel (any other writer holding the cell's lock).
    ids = claims.lane_op_ids(T, K, keys.device)
    u = claims.hash01(wave, ids)
    check_w = ext_need & (u < cfg.cost.opt_overlap)
    u2 = claims.hash01((wave + 131) & U32_MASK, ids)
    check_w2 = ext_need & (u2 < cfg.cost.phase_overlap)

    store, conflict = base.claim_probe_commit(store, batch, prio, wave, cfg,
                                              fine, check_w=check_w,
                                              check_w2=check_w2, bump=False)
    res = base.result_from_conflicts(batch, conflict, eager=False,
                                     cause_op=t.CAUSE_READ_VAL)
    commit = res.commit

    # rts extension: committed reads whose commit_ts > rts CAS rts upward.
    ext = ext_need & commit[:, None]
    ext_count = ext.sum()

    # Same-cell extenders serialize on the line: each waits on average
    # for half the contenders ahead of it.
    G = store.wts.shape[1]
    n_ext = be.segment_count(keys, groups, G, ext)
    per_op = torch.where(
        n_ext > 0,
        cfg.cost.c_ext
        + 0.5 * cfg.cost.lam_ext * torch.clamp(n_ext - 1.0, min=0.0),
        0.0)
    ext_penalty = per_op.sum(dim=1)

    # Timestamp installs, one call: committed writes raise wts and rts, and
    # the extensions rts (the whole row's read horizon when coarse).  n
    # same-cell committed writers chain their installs, so the surviving
    # wts/rts advance by ~n per wave (the stamps of ``chain_stamps``).
    wmask = wr & commit[:, None]
    n_wcell = be.segment_count(keys, groups, G, wmask)
    be.ts_install_max(store.wts, keys, groups, None, wmask, rts=store.rts,
                      ext=ext, ext_whole_row=not fine, commit_ts=commit_ts,
                      n_chain=n_wcell)

    res = dataclasses.replace(res, ext_penalty=ext_penalty,
                              ext_count=ext_count, ext_mask=ext)
    return store, res
