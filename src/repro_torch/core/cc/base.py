"""Shared pieces of the CC mechanisms (port of ``repro/core/cc/base.py``).

The probe family (OCC, TicToc, 2PL, SwissTM, Adaptive) runs its whole
claim -> verdict -> install chain through ``claim_probe_commit`` below.
``EngineConfig.fuse_wave`` picks the route: ONE backend op,
``wave_commit`` (the default), or the unfused chain of ``claim_probe`` on
the claim tables (both in one call on a dual wave), the verdict compare in
tensor ops and ``commit_install`` for the bumps.  Both routes evaluate the
same mask algebra over the same primitives, so they are bit-identical.
AutoGran installs its write claims inside its one ``validate_dual`` call
(``cc/autogran.py``); the multi-version pair installs both claim channels
inside its one ``validate`` call (``cc/mvcc.py``).

Scans (ops with ``op_extent > 1``, admitted by ``cfg.max_extent > 1``)
ride no point channel: they validate only through ``phantom_validate``
(the ``iterate_validate`` op) against the post-install writer-claim table,
and the version bumps move after it, so a lane that loses a phantom never
advances a version.  On the fused route and in AutoGran the bumps ride
that call (its bump form, ``point=``); the unfused route and AutoGran's
point waves bump with ``bump_versions`` (``commit_install``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Union

import torch

from repro_torch.core import backend as kb
from repro_torch.core import claims
from repro_torch.core import types as t
from repro_torch.core.claimword import NO_PRIO
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
        return self.cause_op.amin(dim=1)


def result_from_conflicts(batch: TxnBatch, conflict_op: torch.Tensor,
                          eager: bool,
                          cause_op: Union[torch.Tensor, int] = t.CAUSE_READ_VAL
                          ) -> ValidationResult:
    """Build a ValidationResult from per-op conflict flags; ``cause_op`` is
    one cause code for every conflicting op or an int32[T, K] of codes,
    forced to CAUSE_NONE off the conflict mask.  Scan ops validate only
    through the interval pass, so a conflicting scan op carries
    CAUSE_PHANTOM whatever the mechanism says."""
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


def bump_versions(store: StoreState, batch: TxnBatch, commit: torch.Tensor,
                  cfg: EngineConfig) -> StoreState:
    """+1 on ``wts`` per committed write op (backend ``commit_install``),
    in place."""
    w = batch.is_write() & batch.live() & commit[:, None]
    kb.BACKEND.commit_install(store.wts, batch.op_key, batch.op_group, w)
    return store


def phantom_validate(store: StoreState, batch: TxnBatch, prio: torch.Tensor,
                     wave: torch.Tensor, cfg: EngineConfig,
                     fine: Optional[bool] = None, *,
                     mask: Optional[torch.Tensor] = None,
                     point: Optional[torch.Tensor] = None,
                     do: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Interval (scan) validation, the phantom check: a live scan READ
    conflicts when a record of its interval (exact at its group when fine,
    bucket-expanded over the whole row when coarse) carries a live claim
    of this wave stronger than the lane in the post-install writer-claim
    table.  Unthinned: an iterator's window spans the whole wave.
    ``mask`` narrows the checked ops (MV-OCC: update lanes only).  Returns
    conflict bool[T, K]; all-False without calling the backend when the
    config admits no scans.

    With ``point`` (the wave's point conflicts; the config must admit
    scans) and ``do`` (the live writes) it returns ``point | phantom`` and
    bumps ``wts`` (in place) by 1 per ``do`` op of a committing lane, in
    the same backend call."""
    if point is not None and cfg.max_extent <= 1:
        raise ValueError("phantom_validate: the bump form needs scans "
                         "(cfg.max_extent > 1)")
    if cfg.max_extent <= 1:
        return torch.zeros(batch.op_key.shape, dtype=torch.bool,
                           device=batch.op_key.device)
    if fine is None:
        fine = is_fine(cfg)
    check = batch.is_scan() & batch.is_read() & batch.live()
    if mask is not None:
        check = check & mask
    bump = {} if point is None else dict(point=point, wts=store.wts, do=do)
    return kb.BACKEND.iterate_validate(
        store.claim_w, batch.op_key, batch.op_extent, batch.op_group,
        my_prio_per_op(batch, prio), check, wave, fine, cfg.bucket_size,
        cfg.max_extent, **bump)


def claim_probe_commit(store: StoreState, batch: TxnBatch,
                       prio: torch.Tensor, wave: torch.Tensor,
                       cfg: EngineConfig,
                       fine: Optional[bool] = None, *,
                       check_w: torch.Tensor,
                       check_w2: Optional[torch.Tensor] = None,
                       check_r: Optional[torch.Tensor] = None,
                       extra: Optional[torch.Tensor] = None,
                       dual: bool = False,
                       do_r_mask: Optional[torch.Tensor] = None,
                       bump: bool = True
                       ) -> tuple[StoreState, torch.Tensor]:
    """The probe family's wave: claim install + probe + per-op conflicts
    (+ version bumps for committed writes).

      conflict = check_w  & (wprio < myprio)
               | check_w2 & (wprio != NO_PRIO != myprio)
               | check_r  & (rprio < myprio)
               | extra

    ``wprio``/``rprio`` are the post-install strongest-claimant probes of
    the writer / reader claim tables; the reader channel rides only when
    ``dual``, with live reads narrowed by ``do_r_mask`` as its install
    mask.  ``bump`` adds 1 to ``wts`` per committed write op.  The tables
    are updated in place.  ``cfg.fuse_wave`` picks the route (module
    docstring).

    With scans (``cfg.max_extent > 1``) the scan ops are carved out of
    every point channel and of the reader-claim installs, the phantom pass
    runs on the post-install writer-claim table, and the bumps follow it:
    the fused route runs ``wave_commit`` without its bump and bumps in the
    phantom pass's ``iterate_validate`` call (its bump form).  Returns
    ``(store, conflict bool[T, K])``.
    """
    if fine is None:
        fine = is_fine(cfg)
    be = kb.BACKEND
    keys, groups = batch.op_key, batch.op_group
    live = batch.live()
    do_w = batch.is_write() & live
    scan = batch.is_scan() if cfg.max_extent > 1 else None
    if scan is not None:
        check_w = check_w & ~scan
        if check_w2 is not None:
            check_w2 = check_w2 & ~scan
        if check_r is not None:
            check_r = check_r & ~scan
    do_r = None
    if dual:
        do_r = batch.is_read() & live
        if do_r_mask is not None:
            do_r = do_r & do_r_mask
        if scan is not None:
            do_r = do_r & ~scan
    myp = my_prio_per_op(batch, prio)

    if cfg.fuse_wave:
        fuse_bump = bump and scan is None
        conflict, _ = be.wave_commit(
            store.claim_w, store.claim_r if dual else None,
            store.wts if fuse_bump else None, keys, groups, myp, do_w, do_r,
            check_w, check_w2, check_r, extra, wave, fine, dual, fuse_bump)
        if scan is not None:
            if bump:
                conflict = phantom_validate(store, batch, prio, wave, cfg,
                                            fine, point=conflict, do=do_w)
            else:
                conflict = conflict | phantom_validate(store, batch, prio,
                                                       wave, cfg, fine)
        return store, conflict

    # Unfused: the chain of the megakernel, term by term; a dual wave
    # installs and probes both claim tables in one claim_probe call.
    if dual:
        wprio, rprio = be.claim_probe(store.claim_w, keys, groups, myp, wave,
                                      do_w, fine, claim_r=store.claim_r,
                                      mask_r=do_r)
    else:
        wprio = be.claim_probe(store.claim_w, keys, groups, myp, wave, do_w,
                               fine)
    conflict = check_w & (wprio < myp)
    if check_w2 is not None:
        conflict = conflict | (check_w2 & (wprio != NO_PRIO) & (wprio != myp))
    if dual:
        conflict = conflict | (check_r & (rprio < myp))
    if extra is not None:
        conflict = conflict | extra
    if scan is not None:
        conflict = conflict | phantom_validate(store, batch, prio, wave, cfg,
                                               fine)
    if bump:
        bump_versions(store, batch, ~conflict.any(dim=1), cfg)
    return store, conflict


def is_fine(cfg: EngineConfig) -> bool:
    return cfg.n_groups > 1 and cfg.granularity == 1
