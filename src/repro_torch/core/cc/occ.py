"""OCC — Silo/STO-style optimistic concurrency control (port of
``repro/core/cc/occ.py``).

Every lane's write set claims its (record, group) cells with the lane's
priority; every read probes the writer-claim table and conflicts iff a
strictly stronger lane wrote the cell this wave (thinned by the
vulnerability-window overlap).  Timestamp granularity is the probe width:
coarse probes the whole row, fine only the op's group.  The whole wave is
one ``wave_commit`` backend op with version bumps.
"""
from __future__ import annotations

import torch

from repro_torch.core import claims
from repro_torch.core import types as t
from repro_torch.core.cc import base
from repro_torch.core.types import EngineConfig, StoreState, TxnBatch


def wave_validate(store: StoreState, batch: TxnBatch, prio,
                  wave: torch.Tensor, cfg: EngineConfig):
    T, K = batch.op_key.shape
    u = claims.hash01(wave, claims.lane_op_ids(T, K, batch.op_key.device))
    check = batch.is_read() & batch.live() & (u < cfg.cost.opt_overlap)
    store, conflict = base.claim_probe_commit(store, batch, prio, wave, cfg,
                                              check_w=check)
    # Every OCC abort is a commit-time read-validation failure.
    res = base.result_from_conflicts(batch, conflict, eager=False,
                                     cause_op=t.CAUSE_READ_VAL)
    return store, res
