"""Shared pieces of the CC mechanisms (port of ``repro/core/cc/base.py``).

The probe family runs its whole claim -> verdict -> install chain through
ONE backend op, ``wave_commit`` (``claim_probe_commit`` below).  The port
runs the fused route only; ``EngineConfig`` refuses ``fuse_wave=False``
and scans, whose routes wait for later slices.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Union

import torch

from repro_torch.core import backend as kb
from repro_torch.core import claims
from repro_torch.core import types as t
from repro_torch.core.types import EngineConfig, StoreState, TxnBatch


@dataclasses.dataclass
class ValidationResult:
    commit: torch.Tensor          # bool[T]
    conflict_op: torch.Tensor     # bool[T, K] per-op conflict flags
    first_conflict: torch.Tensor  # int32[T] first conflicting op (K if none)
    ext_penalty: torch.Tensor     # f32[T] extra simulated time (TicToc)
    ext_count: torch.Tensor       # int64 scalar: rts extensions this wave
    pess_frac: torch.Tensor       # f32[T] share of ops on pessimistic rows
    ext_mask: torch.Tensor        # bool[T, K] rts-extension CASes
    cause_op: torch.Tensor        # int32[T, K] cause code per conflicting op
    eager: bool                   # aborts cut work at first_conflict

    def lane_cause(self) -> torch.Tensor:
        """Per-lane abort cause: min cause code over the lane's ops
        (CAUSE_NONE for committing lanes)."""
        return self.cause_op.min(dim=1).values


def result_from_conflicts(batch: TxnBatch, conflict_op: torch.Tensor,
                          eager: bool,
                          cause_op: Union[torch.Tensor, int] = t.CAUSE_READ_VAL
                          ) -> ValidationResult:
    """Build a ValidationResult from per-op conflict flags; ``cause_op`` is
    one cause code for every conflicting op or an int32[T, K] of codes,
    forced to CAUSE_NONE off the conflict mask (scan ops, were there any,
    to CAUSE_PHANTOM)."""
    T, K = batch.op_key.shape
    dev = conflict_op.device
    commit = ~conflict_op.any(dim=1)
    if isinstance(cause_op, int):
        cause_op = torch.full((T, K), cause_op, dtype=torch.int32, device=dev)
    cause_op = torch.where(batch.is_scan(), t.CAUSE_PHANTOM,
                           cause_op.to(torch.int32))
    cause_op = torch.where(conflict_op, cause_op, t.CAUSE_NONE)
    return ValidationResult(
        commit=commit,
        conflict_op=conflict_op,
        first_conflict=claims.first_true_index(conflict_op, K),
        ext_penalty=torch.zeros((T,), dtype=torch.float32, device=dev),
        ext_count=torch.zeros((), dtype=torch.int64, device=dev),
        pess_frac=torch.zeros((T,), dtype=torch.float32, device=dev),
        ext_mask=torch.zeros((T, K), dtype=torch.bool, device=dev),
        cause_op=cause_op,
        eager=eager,
    )


def my_prio_per_op(batch: TxnBatch, prio: torch.Tensor) -> torch.Tensor:
    """The lane priority broadcast to every op slot (int32[T, K])."""
    return prio[:, None].expand(batch.op_key.shape).contiguous()


def claim_probe_commit(store: StoreState, batch: TxnBatch,
                       prio: torch.Tensor, wave: int, cfg: EngineConfig,
                       fine: Optional[bool] = None, *,
                       check_w: torch.Tensor,
                       check_w2: Optional[torch.Tensor] = None,
                       bump: bool = True
                       ) -> tuple[StoreState, torch.Tensor]:
    """The probe family's whole wave in one backend call: claim install +
    probe + per-op conflicts (+ version bumps for committed writes).

      conflict = check_w  & (wprio < myprio)
               | check_w2 & (wprio != NO_PRIO != myprio)

    OCC and TicToc need only the writer-claim channels; the kernel's
    reader-claim (``dual``) and ``extra`` channels wait for the 2PL /
    Adaptive slice.  The claim table (and ``wts`` when ``bump``) is updated
    in place.  Returns ``(store, conflict bool[T, K])``."""
    if fine is None:
        fine = is_fine(cfg)
    do_w = batch.is_write() & batch.live()
    conflict, _ = kb.BACKEND.wave_commit(
        store.claim_w, None, store.wts if bump else None, batch.op_key,
        batch.op_group, my_prio_per_op(batch, prio), do_w, None, check_w,
        check_w2, None, None, wave, fine, False, bump)
    return store, conflict


def is_fine(cfg: EngineConfig) -> bool:
    return cfg.n_groups > 1 and cfg.granularity == 1
