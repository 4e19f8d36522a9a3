"""The wave executor: generation -> validation -> commit -> retry (port of
``repro/core/engine.py``).

One *wave* simulates all T lanes each running one transaction.  The JAX
package runs the waves as one jitted ``lax.scan``; here ``run`` is a
Python loop over ``make_wave_step``'s step, which takes the wave's random
draws as arguments:

    state = step(state, fresh_batch, ring_tails, perm)

so the draws can come from the port's own generators (``run``) or be fed
in from elsewhere (the parity tests replay the JAX engine's draws; the
chip smoke test feeds one draw to the CPU and the card).  The open loop's
step (``make_open_wave_step``) also takes the wave's Poisson arrival
count.  Each step returns the new state and the wave's row (``WaveRow``,
the JAX scan's ``ys``: commits, aborts, cause counts and lane times, on
the device; the open step's also carries the wave's lane forensics):

    state, row = step(state, fresh_batch, ring_tails, perm[, offered])

The wave index ``state.wave`` is a 0-d int64 tensor on the run's device,
which both steps advance there; no wave reads a device value on the host
(``draw_wave`` is one wave of ``run_waves``, draws included), which is
what capturing a wave into a CUDA graph needs.  The per-wave timeline
(``Timeline``) keeps the rows on the device, written at the wave's index
read there, and is read once after the loop; ``run`` always keeps it,
``sweep`` with ``per_wave=True``.  ``cfg.track_conflicts`` adds the
conflict histogram to both steps (``_conflict_histogram``), read by
``hot_records``.  The phases run inside ``torch.profiler`` ranges of the
JAX package's names while a profiler runs (``core/ranges.py``).

``sweep`` runs a benchmark grid point by point; each point runs at its
lane bucket's widest lane count with the padding lanes masked, as the
JAX sweep does (there is no one-program grid to share here, so the
padding only keeps points below their bucket maximum the same
experiment as the JAX package's).

Throughput model: each lane accrues simulated microseconds from the
CostModel; reported throughput = commits / (sum(lane_time) / T), committed
transactions per simulated microsecond with T threads (DESIGN.md
section 4 of the JAX package).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, NamedTuple, Optional, Protocol, Sequence

import numpy as np
import torch

from repro_torch import kernels
from repro_torch.core import admission
from repro_torch.core import backend as kb
from repro_torch.core import claims
from repro_torch.core import types as t
from repro_torch.core.cc import VALIDATORS, ValidationResult
from repro_torch.core.ranges import named_range
from repro_torch.core.types import (EngineConfig, EngineState, StoreState,
                                    TxnBatch, engine_state_init,
                                    resolve_device)
from repro_torch.workloads.arrivals import poisson_offered


class Workload(Protocol):
    """What the engine needs from a workload (YCSB, TPC-C, ...)."""
    n_records: int
    n_groups: int
    n_cols: int
    n_rings: int
    n_txn_types: int
    slots: int

    def init_store(self, device, mv_depth: int = 0) -> StoreState: ...

    def gen(self, generator: torch.Generator, wave: torch.Tensor,
            lanes: int,
            ring_tails: torch.Tensor) -> tuple[TxnBatch, torch.Tensor]: ...


def _kappa(cfg: EngineConfig, res: ValidationResult):
    c = cfg.cost
    if cfg.cc == t.CC_OCC or cfg.cc == t.CC_AUTOGRAN:
        return c.kappa_occ
    if cfg.cc == t.CC_TICTOC:
        return c.kappa_tictoc
    if cfg.cc == t.CC_2PL:
        return c.kappa_2pl
    if cfg.cc == t.CC_SWISS:
        return c.kappa_swiss
    if cfg.cc == t.CC_ADAPTIVE:
        return (c.kappa_adaptive_opt
                + res.pess_frac * (c.kappa_adaptive_pess
                                   - c.kappa_adaptive_opt))
    if cfg.cc == t.CC_MVCC:
        return c.kappa_mvcc
    if cfg.cc == t.CC_MVOCC:
        return c.kappa_mvocc
    raise ValueError(f"unknown cc {cfg.cc}")


def _optimistic(cfg: EngineConfig) -> bool:
    """Mechanisms paying commit-time read validation (c_validate/read)."""
    return cfg.cc in (t.CC_OCC, t.CC_TICTOC, t.CC_SWISS, t.CC_AUTOGRAN,
                      t.CC_ADAPTIVE, t.CC_MVOCC)


def _lane_cost(cfg: EngineConfig, batch: TxnBatch, commit: torch.Tensor,
               res: ValidationResult):
    """Per-lane simulated microseconds for one wave -> (lane_dt f32[T],
    has_write bool[T]): committed lanes pay execution + install
    contention, aborted optimistic lanes waste their full execution, eager
    mechanisms cut losses at the first conflict.  A scan op counts as
    ``extent`` reads: it executes and validates every row of its
    interval (only where the config admits scans, so point configs keep
    the JAX package's float order exactly)."""
    c = cfg.cost
    kappa = _kappa(cfg, res)
    live = batch.live()
    n_ops = batch.n_ops.to(torch.float32)
    n_reads = (batch.is_read() & live).sum(dim=1).to(torch.float32)
    has_write = (batch.is_write() & live).any(dim=1)
    t_exec = c.c_txn + n_ops * c.c_op * kappa
    if cfg.max_extent > 1:
        rd = batch.is_read() & live
        ext = batch.extent().to(torch.float32)
        n_reads = torch.where(rd, ext, 0.0).sum(dim=1)
        t_exec = (t_exec + torch.where(rd, ext - 1.0, 0.0).sum(dim=1)
                  * c.c_op * kappa)
    if _optimistic(cfg):
        val_reads = n_reads
        if cfg.cc == t.CC_MVOCC:
            val_reads = torch.where(has_write, n_reads, 0.0)
        t_exec = t_exec + val_reads * c.c_validate
    # Install contention: committed writers of the same row serialize on
    # its cacheline; concurrent readers of the line stretch each hold.
    be = kb.BACKEND
    zeros = torch.zeros_like(batch.op_group)
    wmask = batch.is_write() & live & commit[:, None]
    n_w = be.segment_count(batch.op_key, zeros, 1, wmask)
    rmask = batch.is_read() & live
    n_r = be.segment_count(batch.op_key, zeros, 1, rmask)
    install_pen = (0.5 * c.lam_w * torch.clamp(n_w - 1.0, min=0.0)
                   * (1.0 + 0.15 * n_r)).sum(dim=1)
    t_commit = t_exec + res.ext_penalty + install_pen
    if res.eager:
        done = torch.minimum(res.first_conflict.to(torch.float32), n_ops)
        t_abort = c.c_txn + done * c.c_op * kappa + c.c_abort + c.backoff
    else:
        t_abort = t_exec + c.c_abort + c.backoff
    return torch.where(commit, t_commit, t_abort), has_write


def _conflict_histogram(cfg: EngineConfig, hits: torch.Tensor,
                        peak: torch.Tensor, batch: TxnBatch,
                        res: ValidationResult) -> None:
    """Hot-record accounting (``cfg.track_conflicts``), in place: the
    per-cell conflicting-op totals through ``commit_install``'s +1
    scatter, and the per-wave same-cell conflict peak through
    ``segment_count`` maxed into the table by ``ts_install_max``.  Cells
    are fine resolution whatever the granularity."""
    be = kb.BACKEND
    conf = res.conflict_op & batch.live()
    be.commit_install(hits, batch.op_key, batch.op_group, conf)
    n_conf = be.segment_count(batch.op_key, batch.op_group, cfg.n_groups,
                              conf)
    be.ts_install_max(peak, batch.op_key, batch.op_group,
                      n_conf.to(torch.int32), conf)


class WaveRow(NamedTuple):
    """One wave's row of the timeline, on the device: the JAX scan's
    ``ys`` (closed step: ``ys``; open step: ``ys[0]``, ``ys[1]``,
    ``ys[6]``, ``ys[7]``), with the lane times unsummed."""
    commits: torch.Tensor   # int64 scalar: committed live lanes
    aborts: torch.Tensor    # int64 scalar: aborted live lanes
    causes: torch.Tensor    # int64[N_ABORT_CAUSES]: the aborts by cause
    lane_dt: torch.Tensor   # f32[T]: simulated us per lane, 0 where idle
    lanes: Optional[tuple] = None  # the open step's lane forensics


class Timeline:
    """The per-wave timeline of a run of ``n_waves`` waves from the state
    whose wave index is ``wave0``.  ``record`` writes a wave's row at that
    wave's index (``wave - wave0``, read on the device: the write is
    five device operations and no host copy, and a captured replay could
    make it); ``arrays`` reads every row once, after the loop."""

    def __init__(self, n_waves: int, wave0: torch.Tensor):
        dev = wave0.device
        self.wave0 = wave0.clone()
        self.counts = torch.zeros((n_waves, 2 + t.N_ABORT_CAUSES),
                                  dtype=torch.int64, device=dev)
        self.us = torch.zeros((n_waves,), dtype=torch.float32, device=dev)

    def record(self, wave: torch.Tensor, row: WaveRow) -> None:
        """Write the row of the wave whose index was ``wave``."""
        at = (wave - self.wave0).view(1)
        self.counts.index_copy_(0, at, torch.cat(
            (row.commits.view(1), row.aborts.view(1), row.causes))[None])
        self.us.index_copy_(0, at, row.lane_dt.sum().view(1))

    def arrays(self) -> dict:
        """{per_wave_commits, per_wave_aborts int64[waves],
        per_wave_causes int64[waves, N_ABORT_CAUSES], per_wave_us
        f32[waves]} as numpy."""
        c = self.counts.cpu().numpy()
        return dict(per_wave_commits=c[:, 0], per_wave_aborts=c[:, 1],
                    per_wave_causes=c[:, 2:],
                    per_wave_us=self.us.cpu().numpy())


def select_batch(sel: torch.Tensor, pending: TxnBatch,
                 fresh: TxnBatch) -> TxnBatch:
    """Lanes with ``sel`` keep their pending (aborted) transaction; the
    rest take the fresh one."""
    out = {}
    for f in dataclasses.fields(TxnBatch):
        p, q = getattr(pending, f.name), getattr(fresh, f.name)
        out[f.name] = torch.where(sel.view((-1,) + (1,) * (p.dim() - 1)),
                                  p, q)
    return TxnBatch(**out)


def _pad(batch: TxnBatch, active: Optional[torch.Tensor]) -> TxnBatch:
    """Padding lanes (``~active``) run empty transactions: no ops, so no
    claims and no conflicts."""
    if active is None:
        return batch
    return dataclasses.replace(
        batch,
        op_key=torch.where(active[:, None], batch.op_key, -1),
        op_kind=torch.where(active[:, None], batch.op_kind, t.NOP),
        n_ops=torch.where(active, batch.n_ops, 0))


def make_wave_step(cfg: EngineConfig,
                   active: Optional[torch.Tensor] = None) -> Callable:
    """Build the wave step ``step(state, fresh, tails, perm) -> (state,
    row)``.

    ``fresh`` is the workload's batch for this wave, ``tails`` its
    advanced ring cursors and ``perm`` a permutation of the T lanes (the
    in-wave serialization order).  The store is updated in place.
    ``active`` (bool[T] or None) marks live lanes: ``sweep`` pads a point
    to its bucket's lane count and masks the padding here.  Inactive lanes
    carry empty transactions and are excluded from every metric; None
    means every lane is live.  ``row`` is the wave's ``WaveRow``."""
    validator = VALIDATORS[cfg.cc]

    def step(state: EngineState, fresh: TxnBatch, tails: torch.Tensor,
             perm: torch.Tensor) -> tuple:
        wave = state.wave
        sel = state.pending_live
        batch = _pad(select_batch(sel, state.pending, fresh), active)
        age = torch.where(sel, state.age, 0)
        store = dataclasses.replace(state.store, ring_tails=tails)
        prio = claims.prio16(age, perm, use_age=(cfg.cc == t.CC_SWISS))

        with named_range("validate"):
            store, res = validator(store, batch, prio, wave, cfg)
        commit = res.commit
        with named_range("cost"):
            lane_dt, has_write = _lane_cost(cfg, batch, commit, res)

        if active is None:
            committed, aborted = commit, ~commit
        else:
            committed, aborted = commit & active, ~commit & active
            lane_dt = torch.where(active, lane_dt, 0.0)
        causes_wave = t.cause_counts(res.lane_cause(), aborted)
        if cfg.track_conflicts:
            _conflict_histogram(cfg, state.conflict_hits,
                                state.conflict_peak, batch, res)
        commits_by_type = state.commits_by_type.index_add(
            0, batch.txn_type.to(torch.int64), committed.to(torch.int64))
        # Padding lanes are empty and so read-only, but committed/aborted
        # already mask them out.
        ro = ~has_write
        n_commit, n_abort = committed.sum(), aborted.sum()
        new_state = EngineState(
            wave=wave + 1,
            store=store,
            pending=batch,
            pending_live=aborted,
            age=torch.where(commit, 0, age + 1),
            lane_time=state.lane_time + lane_dt,
            commits=state.commits + n_commit,
            aborts=state.aborts + n_abort,
            commits_by_type=commits_by_type,
            wasted_time=(state.wasted_time
                         + torch.where(committed, 0.0, lane_dt).sum()),
            ext_events=state.ext_events + res.ext_count,
            ro_commits=state.ro_commits + (committed & ro).sum(),
            ro_aborts=state.ro_aborts + (aborted & ro).sum(),
            abort_causes=state.abort_causes + causes_wave,
            conflict_hits=state.conflict_hits,
            conflict_peak=state.conflict_peak,
            ol=state.ol,
        )
        return new_state, WaveRow(n_commit, n_abort, causes_wave, lane_dt)

    return step


def make_open_wave_step(cfg: EngineConfig,
                        active: Optional[torch.Tensor] = None) -> Callable:
    """Build the OPEN-LOOP wave step ``step(state, fresh, tails, perm,
    offered) -> (state, row)``.

    Instead of the closed loop's one-transaction-per-lane retry buffer,
    lanes are filled each wave from the admission queue
    (core/admission.py): the wave's first ``offered`` fresh transactions
    (its Poisson arrival count, capped at the live lanes) enqueue first,
    with overflow drops counted; the queue then fills up to T lanes FIFO,
    the wave runs, and aborted lanes re-enqueue the SAME transaction with
    incarnation + 1, or drop (counted, cause ``inc_cap``) past
    ``cfg.max_incarnations``.  Committed lanes record time-to-commit =
    commit_wave - admit_wave + 1 waves into the per-class histogram.
    ``active`` is ``sweep``'s live-lane prefix mask, as in
    make_wave_step.  ``row`` is the wave's ``WaveRow``, whose ``lanes``
    are the wave's lane forensics: (txn_id, incarnation, got, admit_wave,
    op_key, op_kind, commit)."""
    validator = VALIDATORS[cfg.cc]
    T = cfg.lanes
    n_active = T if active is None else int(active.sum())

    def step(state: EngineState, fresh: TxnBatch, tails: torch.Tensor,
             perm: torch.Tensor, offered) -> tuple:
        wave = state.wave
        ol = state.ol
        dev = state.lane_time.device
        lane = torch.arange(T, device=dev)

        # ---- arrivals: the wave's fresh transactions, Poisson-thinned ---
        fresh = _pad(fresh, active)
        offered = torch.as_tensor(offered, device=dev).to(
            torch.int64).clamp(max=n_active)
        queue, n_adm, n_ovf = admission.enqueue(
            ol.queue, fresh, wave.expand(T),
            torch.zeros((T,), dtype=torch.int64, device=dev),
            ol.next_id + lane, lane < offered)

        # ---- admit: fill the lane grid FIFO from the queue -------------
        queue, batch, admit_w, incarn, txn_id, got = admission.dequeue(
            queue, T, n_active)
        store = dataclasses.replace(state.store, ring_tails=tails)
        prio = claims.prio16(incarn, perm, use_age=(cfg.cc == t.CC_SWISS))

        with named_range("validate"):
            store, res = validator(store, batch, prio, wave, cfg)
        commit = res.commit & got
        with named_range("cost"):
            lane_dt, has_write = _lane_cost(cfg, batch, commit, res)
        lane_dt = torch.where(got, lane_dt, 0.0)

        # ---- retry incarnations / latency accounting -------------------
        aborted = got & ~commit
        retry = aborted & (incarn < cfg.max_incarnations)
        inc_drop = aborted & ~retry
        # The terminal abort of a transaction at its incarnation cap is
        # reclassified CAUSE_INC_CAP, so cause[inc_cap] == inc_drops
        # exactly and the causes still sum to aborts.
        lane_cause = torch.where(inc_drop, t.CAUSE_INC_CAP,
                                 res.lane_cause())
        causes_wave = t.cause_counts(lane_cause, aborted)
        if cfg.track_conflicts:
            _conflict_histogram(cfg, state.conflict_hits,
                                state.conflict_peak, batch, res)
        # Arrivals enqueued before the dequeue freed these lanes, so the
        # re-enqueue never overflows: reenq_drops stays 0.
        queue, _, n_re_ovf = admission.enqueue(
            queue, batch, admit_w, incarn + 1, txn_id, retry)
        new_ol = admission.record_commits(
            dataclasses.replace(
                ol, queue=queue,
                next_id=ol.next_id + offered,
                offered=ol.offered + offered,
                admitted=ol.admitted + n_adm,
                arrival_drops=ol.arrival_drops + n_ovf,
                inc_drops=ol.inc_drops + inc_drop.sum(),
                reenq_drops=ol.reenq_drops + n_re_ovf),
            batch.txn_type, wave - admit_w + 1, commit)

        commits_by_type = state.commits_by_type.index_add(
            0, batch.txn_type.to(torch.int64), commit.to(torch.int64))
        ro = ~has_write
        n_commit, n_abort = commit.sum(), aborted.sum()
        new_state = EngineState(
            wave=wave + 1,
            store=store,
            pending=state.pending,            # unused in the open loop:
            pending_live=state.pending_live,  # the queue owns every retry
            age=state.age,
            lane_time=state.lane_time + lane_dt,
            commits=state.commits + n_commit,
            aborts=state.aborts + n_abort,
            commits_by_type=commits_by_type,
            wasted_time=(state.wasted_time
                         + torch.where(commit, 0.0, lane_dt).sum()),
            ext_events=state.ext_events + res.ext_count,
            ro_commits=state.ro_commits + (commit & ro).sum(),
            ro_aborts=state.ro_aborts + (aborted & ro).sum(),
            abort_causes=state.abort_causes + causes_wave,
            conflict_hits=state.conflict_hits,
            conflict_peak=state.conflict_peak,
            ol=new_ol,
        )
        return new_state, WaveRow(
            n_commit, n_abort, causes_wave, lane_dt,
            (txn_id, incarn, got, admit_w, batch.op_key, batch.op_kind,
             commit))

    return step


@dataclasses.dataclass
class SimResult:
    commits: int
    aborts: int
    abort_rate: float
    throughput: float          # committed txns per simulated microsecond
    sim_time_us: float
    commits_by_type: list
    ext_events: int
    lanes: int
    waves: int
    ro_commits: int = 0
    ro_aborts: int = 0
    ro_abort_rate: float = 0.0
    abort_causes: Optional[list] = None  # int[N_ABORT_CAUSES]; sums to aborts
    # The per-wave timeline (``Timeline.arrays``), numpy:
    per_wave_commits: Optional[np.ndarray] = None  # int64[waves]
    per_wave_aborts: Optional[np.ndarray] = None   # int64[waves]
    per_wave_causes: Optional[np.ndarray] = None   # int64[waves, causes]
    per_wave_us: Optional[np.ndarray] = None       # f32[waves] simulated us
    hot_records: Optional[list] = None  # track_conflicts top-k:
                               #   (record, group, total_hits, peak_per_wave)
    wall_s: float = 0.0        # host seconds of the wave loop, synchronized
    device: str = "cpu"
    final_state: Optional[EngineState] = None
    # ---- open-loop front-end (cfg.open_loop) ----
    open_loop: bool = False
    goodput: float = 0.0       # unique committed txns per simulated us
    offered: int = 0           # Poisson arrivals offered (post lane cap)
    admitted: int = 0          # arrivals accepted into the admission queue
    arrival_drops: int = 0     # arrivals lost to a full queue
    inc_drops: int = 0         # txns dropped past max_incarnations
    reenq_drops: int = 0       # re-enqueue overflow (structurally 0)
    queued_final: int = 0      # entries still queued at the end of the run
    p50_ttc: Optional[list] = None  # per-txn-class time-to-commit (waves)
    p99_ttc: Optional[list] = None
    lat_hist: Optional[np.ndarray] = None  # int64[n_txn_types, lat_bins]
    trace: Optional[tuple] = None  # per-wave lane forensics (run(trace=True))


def summarize(cfg: EngineConfig, state: EngineState, n_waves: int,
              wall_s: float = 0.0, keep_state: bool = False,
              trace: Optional[list] = None,
              timeline: Optional[Timeline] = None) -> SimResult:
    """The run's SimResult: ``trace`` (the open step's lane forensics of
    each wave) and ``timeline`` fill their fields where given, and a
    ``track_conflicts`` run gets its ``hot_records``."""
    commits, aborts = int(state.commits), int(state.aborts)
    ro_c, ro_a = int(state.ro_commits), int(state.ro_aborts)
    wall = float(state.lane_time.sum()) / cfg.lanes if cfg.lanes else 0.0
    extra = {} if timeline is None else timeline.arrays()
    if cfg.track_conflicts:
        extra["hot_records"] = hot_records(state, k=16)
    if cfg.open_loop:
        ol = state.ol
        p50, p99 = admission.ttc_percentiles(ol.lat_hist)
        extra.update(
            open_loop=True, goodput=commits / max(wall, 1e-9),
            offered=int(ol.offered), admitted=int(ol.admitted),
            arrival_drops=int(ol.arrival_drops),
            inc_drops=int(ol.inc_drops), reenq_drops=int(ol.reenq_drops),
            queued_final=int(ol.queue.size), p50_ttc=p50, p99_ttc=p99,
            lat_hist=ol.lat_hist.cpu().numpy())
        if trace:
            extra["trace"] = tuple(
                np.stack([w[i].cpu().numpy() for w in trace])
                for i in range(len(trace[0])))
    return SimResult(
        commits=commits,
        aborts=aborts,
        abort_rate=aborts / max(commits + aborts, 1),
        throughput=commits / max(wall, 1e-9),
        sim_time_us=wall,
        commits_by_type=[int(x) for x in state.commits_by_type],
        ext_events=int(state.ext_events),
        lanes=cfg.lanes,
        waves=n_waves,
        ro_commits=ro_c,
        ro_aborts=ro_a,
        ro_abort_rate=ro_a / max(ro_c + ro_a, 1),
        abort_causes=[int(x) for x in state.abort_causes],
        wall_s=wall_s,
        device=str(state.lane_time.device),
        final_state=state if keep_state else None,
        **extra,
    )


def arrival_rate(cfg: EngineConfig, device) -> Optional[torch.Tensor]:
    """The open loop's arrival rate as the float32 scalar tensor on
    ``device`` that ``draw_wave`` draws from (made once a run, so a wave
    copies nothing from the host); None in a closed loop."""
    if not cfg.open_loop:
        return None
    return torch.full((), cfg.arrival_rate, dtype=torch.float32,
                      device=device)


def draw_wave(cfg: EngineConfig, workload: Workload, state: EngineState,
              step: Callable, gen: torch.Generator,
              rate: Optional[torch.Tensor] = None) -> tuple:
    """One wave of ``run_waves``: the workload's batch and ring tails, the
    lane permutation and, in the open loop, the arrival count (from
    ``rate``, ``arrival_rate``'s tensor), drawn from ``gen`` in that
    order, then ``step``.  Returns ``(state, row)``, ``row`` the wave's
    ``WaveRow``.  Nothing in it reads a device value on the host: the
    wave index stays on the device."""
    dev = state.lane_time.device
    fresh, tails = workload.gen(gen, state.wave, cfg.lanes,
                                state.store.ring_tails)
    perm = torch.randperm(cfg.lanes, generator=gen, device=dev)
    if cfg.open_loop:
        offered = poisson_offered(gen, rate, cfg.lanes)
        return step(state, fresh, tails, perm, offered)
    return step(state, fresh, tails, perm)


def run_waves(cfg: EngineConfig, workload: Workload, state: EngineState,
              step: Callable, gen: torch.Generator, n_waves: int,
              trace: Optional[list] = None,
              timeline: Optional[Timeline] = None
              ) -> tuple[EngineState, float]:
    """Continue ``state`` for ``n_waves`` waves of ``draw_wave``.
    ``trace`` (a list) collects the open step's per-wave lane forensics;
    ``timeline`` (made from this ``state``'s wave) records every wave's
    row.  Returns the new state and the loop's host seconds, synchronized
    with the device (the only host waits of the loop)."""
    dev = state.lane_time.device
    rate = arrival_rate(cfg, dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    for _ in range(n_waves):
        wave = state.wave
        state, row = draw_wave(cfg, workload, state, step, gen, rate)
        if trace is not None and row.lanes is not None:
            trace.append(row.lanes)
        if timeline is not None:
            timeline.record(wave, row)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return state, time.perf_counter() - t0


def _drive(cfg: EngineConfig, workload: Workload, n_waves: int, seed: int,
           dev: torch.device, active: Optional[torch.Tensor] = None,
           trace: Optional[list] = None, per_wave: bool = False) -> tuple:
    """One run of ``n_waves`` waves from a fresh store, on ``dev``:
    ``(state, wall_s, timeline)``, the timeline None unless
    ``per_wave``."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    state = engine_state_init(cfg, workload.init_store(dev, cfg.mv_depth))
    timeline = Timeline(n_waves, state.wave) if per_wave else None
    mk = make_open_wave_step if cfg.open_loop else make_wave_step
    state, wall_s = run_waves(cfg, workload, state, mk(cfg, active), gen,
                              n_waves, trace, timeline)
    return state, wall_s, timeline


def run(cfg: EngineConfig, workload: Workload, n_waves: int, seed: int = 0,
        device=None, keep_state: bool = False,
        trace: bool = False) -> SimResult:
    """Run ``n_waves`` waves and summarize.

    Draws come from the workload's generator and a ``torch.Generator`` on
    the run's device, seeded with ``seed`` (a stream of its own: it does
    not reproduce the JAX package's draws).  ``cfg.open_loop`` selects the
    open-loop step; ``trace=True`` (open loop only) returns per-wave lane
    forensics, each int[waves, T], in ``SimResult.trace``.  The per-wave
    timeline fills ``per_wave_*`` and, with ``cfg.track_conflicts``, the
    conflict histogram ``hot_records``, as JAX ``run`` does.  ``device``
    defaults to CUDA and raises without it; ``wall_s`` covers the wave
    loop up to a device synchronize."""
    dev = resolve_device(device)
    lanes = [] if trace else None
    state, wall_s, timeline = _drive(cfg, workload, n_waves, seed, dev,
                                     trace=lanes, per_wave=True)
    return summarize(cfg, state, n_waves, wall_s, keep_state, lanes,
                     timeline)


def hot_records(state: EngineState, k: int = 16) -> list:
    """Top-k hot cells of the conflict histogram (track_conflicts runs):
    ``(record, group, total_conflict_hits, peak_same_wave_conflicts)``
    sorted by total hits (ties in the JAX package's order: a stable sort,
    reversed), zero-hit cells omitted."""
    hits = state.conflict_hits.cpu().numpy().view(np.uint32)
    peak = state.conflict_peak.cpu().numpy().view(np.uint32)
    G = hits.shape[1]
    flat = hits.ravel()
    order = np.argsort(flat, kind="stable")[::-1][:k]
    return [(int(i // G), int(i % G), int(flat[i]), int(peak.ravel()[i]))
            for i in order if flat[i] > 0]


@dataclasses.dataclass
class SweepPoint:
    """One datapoint of a sweep grid: the JAX package's SweepPoint plus
    where and how fast the point ran."""
    cc: int
    granularity: int
    lanes: int
    seed: int
    commits: int
    aborts: int
    abort_rate: float
    throughput: float          # committed txns per simulated microsecond
    sim_time_us: float
    ext_events: int
    waves: int
    ro_commits: int = 0
    ro_aborts: int = 0
    ro_abort_rate: float = 0.0
    # ---- open-loop front-end (cfg.open_loop) ----
    open_loop: bool = False
    goodput: float = 0.0
    offered: int = 0
    admitted: int = 0
    arrival_drops: int = 0
    inc_drops: int = 0
    queued_final: int = 0
    p50_ttc: Optional[list] = None  # per-txn-class time-to-commit (waves)
    p99_ttc: Optional[list] = None
    abort_causes: Optional[list] = None  # int[N_ABORT_CAUSES] (types.CAUSE_*)
    # Per-wave timeline (sweep(..., per_wave=True); analysis/trace.py):
    per_wave_commits: Optional[np.ndarray] = None
    per_wave_aborts: Optional[np.ndarray] = None
    per_wave_causes: Optional[np.ndarray] = None
    per_wave_us: Optional[np.ndarray] = None
    # ---- the port's additions ----
    reenq_drops: int = 0       # open loop: re-enqueue overflow (always 0)
    lanes_run: int = 0         # the bucket's lane count the point ran at
    wall_s: float = 0.0        # host seconds of its wave loop, synchronized
    device: str = "cpu"
    kernel_launches: Optional[dict] = None  # {op: launches} over the point
    kernel_calls: Optional[dict] = None     # {op: wrapper calls}


def lane_buckets(lane_counts: Sequence[int],
                 ratio: Optional[float] = 2.0) -> list[list[int]]:
    """Group lane counts so padding waste stays bounded.

    Every count in a bucket is padded to the bucket's max, so the
    masked-work waste for a count T is bucket_max / T.  Greedy ascending
    grouping keeps that factor <= ``ratio``.  ``ratio=None`` puts every
    count in one bucket padded to the global max."""
    uniq = sorted(set(lane_counts))
    if ratio is None:
        return [uniq]
    buckets: list[list[int]] = []
    for T in uniq:
        if buckets and T <= ratio * buckets[-1][0]:
            buckets[-1].append(T)
        else:
            buckets.append([T])
    return buckets


def sweep(cfg: EngineConfig, workload: Workload, n_waves: int, *,
          ccs: Sequence[int], grans: Sequence[int] = (0, 1),
          lane_counts: Sequence[int] = (16, 64, 128),
          seeds: Sequence[int] = (0,),
          lane_bucket_ratio: Optional[float] = 2.0,
          per_wave: bool = False, device=None) -> list[SweepPoint]:
    """Run a benchmark grid, ccs x grans x lane_counts x seeds, point by
    point; returns the points in the JAX sweep's grid order (granularity,
    then mechanism, then lane count, then seed).

    Lane counts are grouped by ``lane_buckets``; each point runs at its
    bucket's widest lane count ``T_pad``, on draws of ``T_pad`` lanes from
    the port's generator seeded with ``seed``, with the lanes past its own
    count masked (``make_wave_step``'s ``active``).  A point at its
    bucket's maximum is ``run(replace(cfg, cc=cc, granularity=g,
    lanes=T), workload, n_waves, seed)`` exactly.  ``sim_time_us`` divides
    the lanes' time by the point's own lane count; ``wall_s`` is the
    point's wave loop, at ``T_pad`` lanes.  Only the multi-version
    mechanisms get ``cfg.mv_depth``'s ring.  ``cfg.open_loop`` runs every
    point open-loop.  ``per_wave`` keeps each point's per-wave timeline
    (its own lanes: the padding is masked out of every row)."""
    dev = resolve_device(device)
    pad = {T: max(b) for b in lane_buckets(lane_counts, lane_bucket_ratio)
           for T in b}
    points = []
    for g in grans:
        for cc in ccs:
            for T in lane_counts:
                T_pad = pad[T]
                ccfg = dataclasses.replace(
                    cfg, cc=cc, granularity=g, lanes=T_pad,
                    mv_depth=cfg.mv_depth if cc in t.MV_CCS else 0)
                active = (None if T == T_pad else
                          torch.arange(T_pad, device=dev) < T)
                for sd in seeds:
                    before = (kernels.launch_counts(), kernels.call_counts())
                    state, wall_s, timeline = _drive(
                        ccfg, workload, n_waves, sd, dev, active,
                        per_wave=per_wave)
                    points.append(_point(ccfg, state, T, sd, n_waves, wall_s,
                                         before, timeline))
    return points


#: The SweepPoint fields a point's SimResult carries as they are.
_POINT_FIELDS = ("commits", "aborts", "abort_rate", "throughput",
                 "sim_time_us", "ext_events", "waves", "ro_commits",
                 "ro_aborts", "ro_abort_rate", "open_loop", "goodput",
                 "offered", "admitted", "arrival_drops", "inc_drops",
                 "queued_final", "p50_ttc", "p99_ttc", "abort_causes",
                 "reenq_drops", "wall_s", "device", "per_wave_commits",
                 "per_wave_aborts", "per_wave_causes", "per_wave_us")


def _point(cfg: EngineConfig, state: EngineState, lanes: int, seed: int,
           n_waves: int, wall_s: float, before: tuple,
           timeline: Optional[Timeline] = None) -> SweepPoint:
    """A finished point, summarized over its own ``lanes`` (the lanes past
    them were padding) with the kernel counters' deltas since ``before``
    and, where given, its timeline."""
    res = summarize(dataclasses.replace(cfg, lanes=lanes), state, n_waves,
                    wall_s, timeline=timeline)
    launches, calls = ({op: n - b[op] for op, n in now.items()}
                       for now, b in zip((kernels.launch_counts(),
                                          kernels.call_counts()), before))
    return SweepPoint(
        cc=cfg.cc, granularity=cfg.granularity, lanes=lanes, seed=seed,
        lanes_run=cfg.lanes, kernel_launches=launches, kernel_calls=calls,
        **{f: getattr(res, f) for f in _POINT_FIELDS})
