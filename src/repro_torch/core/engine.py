"""The wave executor: generation -> validation -> commit -> retry (port of
``repro/core/engine.py``).

One *wave* simulates all T lanes each running one transaction.  The JAX
package runs the waves as one jitted ``lax.scan``; here ``run`` is a
Python loop over ``make_wave_step``'s step, which takes the wave's random
draws as arguments:

    state = step(state, fresh_batch, ring_tails, perm)

so the draws can come from the port's own generators (``run``) or be fed
in from elsewhere (the parity tests replay the JAX engine's draws; the
chip smoke test feeds one draw to the CPU and the card).

Throughput model: each lane accrues simulated microseconds from the
CostModel; reported throughput = commits / (sum(lane_time) / T), committed
transactions per simulated microsecond with T threads (DESIGN.md
section 4 of the JAX package).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional, Protocol

import torch

from repro_torch.core import backend as kb
from repro_torch.core import claims
from repro_torch.core import types as t
from repro_torch.core.cc import VALIDATORS, ValidationResult
from repro_torch.core.types import (EngineConfig, EngineState, StoreState,
                                    TxnBatch, engine_state_init,
                                    resolve_device)


class Workload(Protocol):
    """What the engine needs from a workload (YCSB, TPC-C, ...)."""
    n_records: int
    n_groups: int
    n_cols: int
    n_rings: int
    n_txn_types: int
    slots: int

    def init_store(self, device, mv_depth: int = 0) -> StoreState: ...

    def gen(self, generator: torch.Generator, wave: int, lanes: int,
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


def make_wave_step(cfg: EngineConfig) -> Callable:
    """Build the wave step ``step(state, fresh, tails, perm) -> state``.

    ``fresh`` is the workload's batch for this wave, ``tails`` its
    advanced ring cursors and ``perm`` a permutation of the T lanes (the
    in-wave serialization order).  The store is updated in place."""
    validator = VALIDATORS[cfg.cc]

    def step(state: EngineState, fresh: TxnBatch, tails: torch.Tensor,
             perm: torch.Tensor) -> EngineState:
        wave = state.wave
        sel = state.pending_live
        batch = select_batch(sel, state.pending, fresh)
        age = torch.where(sel, state.age, 0)
        store = dataclasses.replace(state.store, ring_tails=tails)
        prio = claims.prio16(age, perm, use_age=(cfg.cc == t.CC_SWISS))

        store, res = validator(store, batch, prio, wave, cfg)
        commit = res.commit
        lane_dt, has_write = _lane_cost(cfg, batch, commit, res)

        committed, aborted = commit, ~commit
        causes_wave = t.cause_counts(res.lane_cause(), aborted)
        commits_by_type = state.commits_by_type.index_add(
            0, batch.txn_type.to(torch.int64), committed.to(torch.int64))
        ro = ~has_write
        return EngineState(
            wave=wave + 1,
            store=store,
            pending=batch,
            pending_live=aborted,
            age=torch.where(commit, 0, age + 1),
            lane_time=state.lane_time + lane_dt,
            commits=state.commits + committed.sum(),
            aborts=state.aborts + aborted.sum(),
            commits_by_type=commits_by_type,
            wasted_time=(state.wasted_time
                         + torch.where(committed, 0.0, lane_dt).sum()),
            ext_events=state.ext_events + res.ext_count,
            ro_commits=state.ro_commits + (committed & ro).sum(),
            ro_aborts=state.ro_aborts + (aborted & ro).sum(),
            abort_causes=state.abort_causes + causes_wave,
        )

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
    wall_s: float = 0.0        # host seconds of the wave loop, synchronized
    device: str = "cpu"
    final_state: Optional[EngineState] = None


def summarize(cfg: EngineConfig, state: EngineState, n_waves: int,
              wall_s: float = 0.0, keep_state: bool = False) -> SimResult:
    commits, aborts = int(state.commits), int(state.aborts)
    ro_c, ro_a = int(state.ro_commits), int(state.ro_aborts)
    wall = float(state.lane_time.sum()) / cfg.lanes if cfg.lanes else 0.0
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
    )


def run_waves(cfg: EngineConfig, workload: Workload, state: EngineState,
              step: Callable, gen: torch.Generator,
              n_waves: int) -> tuple[EngineState, float]:
    """Continue ``state`` for ``n_waves`` waves, drawing each wave's batch,
    ring tails and lane permutation from ``gen``.  Returns the new state and
    the loop's host seconds, synchronized with the device."""
    dev = state.lane_time.device
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    for _ in range(n_waves):
        fresh, tails = workload.gen(gen, state.wave, cfg.lanes,
                                    state.store.ring_tails)
        perm = torch.randperm(cfg.lanes, generator=gen, device=dev)
        state = step(state, fresh, tails, perm)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return state, time.perf_counter() - t0


def run(cfg: EngineConfig, workload: Workload, n_waves: int, seed: int = 0,
        device=None, keep_state: bool = False) -> SimResult:
    """Run ``n_waves`` closed-loop waves and summarize.

    Draws come from the workload's generator and a ``torch.Generator`` on
    the run's device, seeded with ``seed`` (a stream of its own: it does
    not reproduce the JAX package's draws).  ``device`` defaults to CUDA
    and raises without it; ``wall_s`` covers the wave loop up to a device
    synchronize."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    state = engine_state_init(cfg, workload.init_store(dev, cfg.mv_depth))
    state, wall_s = run_waves(cfg, workload, state, make_wave_step(cfg), gen,
                              n_waves)
    return summarize(cfg, state, n_waves, wall_s, keep_state)
