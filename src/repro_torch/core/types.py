"""Core types of the wave engine (the port of ``repro/core/types.py``).

The engine executes transactions in *waves*: a wave is a batch of T lanes,
each lane running one transaction in lockstep.  Everything is a
fixed-shape tensor; the JAX pytrees become dataclasses of tensors that live
on one explicit device.

Operation encoding (T lanes x K op slots):

  op_key    int32[T, K]  flat record id, -1 = unused slot
  op_group  int32[T, K]  timestamp group within the record: coarse
                         granularity probes the whole row, fine only the
                         op's group (the paper's mechanism)
  op_col    int32[T, K]  column index
  op_kind   int32[T, K]  NOP / READ / WRITE / ADD
  op_val    f32[T, K]    value or delta for WRITE/ADD
  op_extent int32[T, K]  interval width: 1 = point op, > 1 = a scan of
                         [key, key + extent)

Word-valued tables (wts, rts, claim_w, claim_r, mv_begin) hold uint32
bit patterns in int32 tensors, 4 bytes per cell as in the JAX package
(see ``core/claimword.py``).  The wave counter is a 0-d int64 tensor on
the run's device, which the step advances there and the kernels read from
device memory, so no wave waits on the host for it.
"""
from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Optional

import torch

from repro_torch.core import mvstore

if TYPE_CHECKING:
    from repro_torch.core.admission import OpenLoopState

# Operation kinds.
NOP: int = 0
READ: int = 1
WRITE: int = 2
ADD: int = 3  # blind commutative increment

# Concurrency-control mechanism ids.
CC_OCC: int = 0
CC_TICTOC: int = 1
CC_2PL: int = 2
CC_SWISS: int = 3
CC_ADAPTIVE: int = 4
CC_AUTOGRAN: int = 5
CC_MVCC: int = 6
CC_MVOCC: int = 7

#: Mechanisms that need the multi-version ring (EngineConfig.mv_depth >= 1).
MV_CCS = (CC_MVCC, CC_MVOCC)

CC_NAMES = {
    CC_OCC: "occ",
    CC_TICTOC: "tictoc",
    CC_2PL: "2pl",
    CC_SWISS: "swisstm",
    CC_ADAPTIVE: "adaptive",
    CC_AUTOGRAN: "autogran",
    CC_MVCC: "mvcc",
    CC_MVOCC: "mvocc",
}
CC_IDS = {v: k for k, v in CC_NAMES.items()}

# Abort-cause taxonomy, ordered by precedence: a lane's cause is the
# minimum over its ops' cause codes.  CAUSE_NONE marks clean ops and sits
# one past the histogram.
CAUSE_INC_CAP: int = 0
CAUSE_CAPACITY: int = 1
CAUSE_STALE_SNAPSHOT: int = 2
CAUSE_LOCK_WOUND: int = 3
CAUSE_WW: int = 4
CAUSE_READ_VAL: int = 5
CAUSE_PHANTOM: int = 6
N_ABORT_CAUSES: int = 7
CAUSE_NONE: int = N_ABORT_CAUSES

CAUSE_NAMES = {
    CAUSE_INC_CAP: "inc_cap",
    CAUSE_CAPACITY: "capacity",
    CAUSE_STALE_SNAPSHOT: "stale_snapshot",
    CAUSE_LOCK_WOUND: "lock_wound",
    CAUSE_WW: "ww",
    CAUSE_READ_VAL: "read_val",
    CAUSE_PHANTOM: "phantom",
}


def cause_counts(lane_cause: torch.Tensor,
                 aborted: torch.Tensor) -> torch.Tensor:
    """Histogram lane cause codes over aborted lanes -> int64[N_ABORT_CAUSES].

    Non-aborted lanes land in the CAUSE_NONE bin, which is cut off, so the
    counts sum to ``aborted.sum()`` exactly (every aborted lane carries a
    real cause by construction)."""
    idx = torch.where(aborted, lane_cause.to(torch.int64),
                      torch.full_like(lane_cause, N_ABORT_CAUSES,
                                      dtype=torch.int64))
    hist = torch.zeros(N_ABORT_CAUSES + 1, dtype=torch.int64,
                       device=lane_cause.device)
    hist.index_add_(0, idx, torch.ones_like(idx))
    return hist[:N_ABORT_CAUSES]


# Priority layout: (inverse-age << PRIO_LANE_BITS) | lane-permutation rank.
PRIO_LANE_BITS = 10  # up to 1024 lanes
PRIO_LANE_MASK = (1 << PRIO_LANE_BITS) - 1
NO_CLAIM = 0xFFFFFFFF

#: Slots past the last record of the per-record mode and heat tables: the
#: sink that the masked ops of a fixed-shape scatter write (the JAX
#: package's scatters drop them, ``mode="drop"``, which torch lacks).
SINK = 1
#: The StoreState tables that carry the sink slot.
SINK_TABLES = ("pess_mode", "abort_heat", "fine_mode", "false_heat",
               "heat_wave")

# Out-of-bounds key of the JAX package's drop/fill scatters.  The port masks
# keys outside [0, n_records) explicitly instead (torch raises on
# out-of-range indices and wraps negative ones); no port code uses it.
OOB_KEY: int = 0x7F000000


def resolve_device(device=None) -> torch.device:
    """The run's device: CUDA unless the caller asks for another.  Raises
    when CUDA is asked for (or defaulted to) and absent — a measurement
    path never falls back to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: pass device='cpu' to run the plain "
            "PyTorch versions of the kernels")
    return dev


@dataclasses.dataclass
class TxnBatch:
    """A wave's worth of transactions (T lanes x K op slots)."""
    op_key: torch.Tensor    # int32[T, K]
    op_group: torch.Tensor  # int32[T, K]
    op_col: torch.Tensor    # int32[T, K]
    op_kind: torch.Tensor   # int32[T, K]
    op_val: torch.Tensor    # f32[T, K]
    txn_type: torch.Tensor  # int32[T]
    n_ops: torch.Tensor     # int32[T]
    op_extent: Optional[torch.Tensor] = None  # int32[T, K]; all ones

    def __post_init__(self):
        if self.op_extent is None:
            self.op_extent = torch.ones_like(self.op_key)

    @property
    def lanes(self) -> int:
        return self.op_key.shape[0]

    @property
    def slots(self) -> int:
        return self.op_key.shape[1]

    def is_read(self) -> torch.Tensor:
        return self.op_kind == READ

    def is_write(self) -> torch.Tensor:
        """Version-bumping accesses (WRITE and ADD)."""
        return (self.op_kind == WRITE) | (self.op_kind == ADD)

    def is_plain_write(self) -> torch.Tensor:
        return self.op_kind == WRITE

    def is_add(self) -> torch.Tensor:
        return self.op_kind == ADD

    def live(self) -> torch.Tensor:
        return (self.op_kind != NOP) & (self.op_key >= 0)

    def is_scan(self) -> torch.Tensor:
        return self.op_extent > 1

    def extent(self) -> torch.Tensor:
        """Per-op interval width, clamped to >= 1."""
        return torch.clamp(self.op_extent, min=1)


@dataclasses.dataclass
class StoreState:
    """The database's version metadata, claim tables and per-record CC
    state.

    Every table is updated in place: the word tables and the version
    ring by the backend ops, the mode bits and heats by the mechanisms.
    Heats decay lazily: a record's heat is multiplied by
    decay ** (wave - heat_wave) when it is next read.  The mode bits, the
    heats and the heat waves carry one sink slot past the last record
    (index ``n_records``, ``SINK``): the masked ops of their fixed-shape
    scatters write 0 (False) there, and no reader reads it.  The JAX
    package's tracked values (``values``, ``mv_vals``) wait for ROADMAP
    A.4: ``mv_vals`` is a placeholder.
    """
    wts: torch.Tensor         # int32[n_records, G]  write timestamps
    rts: torch.Tensor         # int32[n_records, G]  read timestamps
    claim_w: torch.Tensor     # int32[n_records, G]  writer claim table
    claim_r: torch.Tensor     # int32[n_records, G]  reader claim table
    ring_tails: torch.Tensor  # int32[n_rings]       append-ring cursors
    pess_mode: torch.Tensor   # bool[n_records + 1]  Adaptive: pessimistic
    abort_heat: torch.Tensor  # f32[n_records + 1]   Adaptive: abort EWMA
    fine_mode: torch.Tensor   # bool[n_records + 1]  AutoGran: fine stamps
    false_heat: torch.Tensor  # f32[n_records + 1]   AutoGran: false-conflict
                              #   EWMA
    heat_wave: torch.Tensor   # int32[n_records + 1] wave a heat was last
                              #   touched (each with the sink slot)
    mv_begin: torch.Tensor    # int32[n_records, D, G] ring begin stamps
                              #   (core/mvstore.py; [1, 1, 1] when the run
                              #   has no ring, mv_depth=0)
    mv_head: torch.Tensor     # int32[n_records] newest ring slot per record
    mv_vals: torch.Tensor     # f32[1, 1, 1] placeholder (ROADMAP A.4)

    @property
    def n_records(self) -> int:
        return self.wts.shape[0]

    @property
    def n_groups(self) -> int:
        return self.wts.shape[1]

    @property
    def mv_depth(self) -> int:
        """Ring depth D (1 without a ring: the placeholder's slot)."""
        return self.mv_begin.shape[1]


@dataclasses.dataclass
class EngineState:
    """State carried from one wave to the next.  Counters stay on the
    device so a wave never waits for the host."""
    wave: torch.Tensor          # int64 scalar: current wave index
    store: StoreState
    pending: TxnBatch           # retry buffer: aborted txns re-run next wave
    pending_live: torch.Tensor  # bool[T]
    age: torch.Tensor           # int32[T] retry count of the lane's txn
    lane_time: torch.Tensor     # f32[T] simulated microseconds per lane
    commits: torch.Tensor       # int64 scalar
    aborts: torch.Tensor        # int64 scalar
    commits_by_type: torch.Tensor  # int64[n_txn_types]
    wasted_time: torch.Tensor   # f32 scalar
    ext_events: torch.Tensor    # int64 scalar, TicToc rts extensions
    ro_commits: torch.Tensor    # int64 scalar
    ro_aborts: torch.Tensor     # int64 scalar
    abort_causes: torch.Tensor  # int64[N_ABORT_CAUSES]; sums to aborts
    # The conflict histogram (cfg.track_conflicts), uint32 words in int32
    # as the word tables: [n_records, G] when tracking, else [1, 1].
    conflict_hits: torch.Tensor  # total conflicting ops per cell
    conflict_peak: torch.Tensor  # most conflicting ops of one cell in a
                                 #   wave
    # The open-loop front-end (core/admission.py); None in a closed loop.
    ol: Optional["OpenLoopState"] = None


@dataclasses.dataclass(frozen=True)
class CostModel:
    """Simulated-time constants (microseconds), as in the JAX package."""
    c_op: float = 0.12
    c_txn: float = 0.80
    c_validate: float = 0.03
    kappa_occ: float = 1.0
    kappa_tictoc: float = 1.12
    kappa_2pl: float = 1.38
    kappa_swiss: float = 1.18
    kappa_adaptive_opt: float = 1.12
    kappa_adaptive_pess: float = 1.42
    kappa_mvcc: float = 1.30
    kappa_mvocc: float = 1.24
    c_ext: float = 0.04
    lam_ext: float = 1.35
    lam_w: float = 0.55
    opt_overlap: float = 0.60
    phase_overlap: float = 0.55
    c_abort: float = 0.35
    backoff: float = 0.25


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Static configuration of a simulation run.

    The fields are the JAX package's, less its TPU-only ``backend`` and
    ``lane_block`` knobs (the port dispatches on the tensors' device).
    Settings outside this port's slice raise ``NotImplementedError`` and
    name the ROADMAP item they wait for."""
    cc: int
    lanes: int
    slots: int
    n_records: int
    n_groups: int
    n_cols: int
    n_txn_types: int
    granularity: int = 1        # 0 = coarse, 1 = fine
    n_rings: int = 1
    track_values: bool = False
    mv_depth: int = 0
    snapshot_age: int = 0
    arrival_rate: float = 0.0
    queue_cap: int = 0
    max_incarnations: int = 0
    lat_bins: int = 64
    track_conflicts: bool = False
    cost: CostModel = dataclasses.field(default_factory=CostModel)
    adapt_up: float = 0.20
    adapt_down: float = 0.02
    adapt_decay: float = 0.95
    autogran_up: float = 0.10
    autogran_decay: float = 0.97
    fuse_wave: bool = True
    max_extent: int = 1
    bucket_size: int = 8

    def __post_init__(self):
        if self.mv_depth < 0:
            raise ValueError(f"mv_depth must be >= 0, got {self.mv_depth}")
        if self.cc in MV_CCS and self.mv_depth < 1:
            raise ValueError(
                f"{CC_NAMES[self.cc]} needs the multi-version store: "
                "set EngineConfig.mv_depth >= 1 (benchmarks use 4)")
        if self.snapshot_age < 0:
            raise ValueError(
                f"snapshot_age must be >= 0, got {self.snapshot_age}")
        if self.snapshot_age > 0 and self.cc not in MV_CCS:
            raise ValueError(
                f"snapshot_age={self.snapshot_age} needs a multi-version "
                f"mechanism (mvcc/mvocc): {CC_NAMES[self.cc]} has no "
                "snapshots to age")
        if self.arrival_rate < 0:
            raise ValueError(
                f"arrival_rate must be >= 0, got {self.arrival_rate}")
        if self.open_loop:
            if self.queue_cap < 1:
                raise ValueError(
                    f"open-loop runs (arrival_rate={self.arrival_rate}) "
                    "need an admission queue: set queue_cap >= 1")
            if self.max_incarnations < 0:
                raise ValueError(f"max_incarnations must be >= 0, got "
                                 f"{self.max_incarnations}")
            if self.lat_bins < 2:
                raise ValueError(
                    f"lat_bins={self.lat_bins}: the time-to-commit "
                    "histogram needs >= 2 bins (last bin = overflow)")
        elif self.queue_cap or self.max_incarnations:
            raise ValueError(
                f"queue_cap={self.queue_cap} / max_incarnations="
                f"{self.max_incarnations} shape the open-loop admission "
                "queue only: set arrival_rate > 0 (closed-loop lanes "
                "retry in place and never queue)")
        if self.max_extent < 1:
            raise ValueError(
                f"max_extent must be >= 1 (1 = point ops), got "
                f"{self.max_extent}")
        if self.max_extent > self.n_records:
            raise ValueError(
                f"max_extent={self.max_extent} exceeds n_records="
                f"{self.n_records}: no interval can be wider than the "
                "record space")
        if self.bucket_size < 1:
            raise ValueError(
                f"bucket_size must be >= 1, got {self.bucket_size}")
        if self.max_extent > 1 and self.snapshot_age > 0:
            raise ValueError(
                f"max_extent={self.max_extent} with snapshot_age="
                f"{self.snapshot_age}: scans validate intervals against "
                "the CURRENT wave's claim tables, which aged snapshots "
                "have already drifted past")
        # Settings the port does not run yet.
        if self.track_values:
            raise NotImplementedError(
                "track_values=True is not ported to repro_torch yet: it "
                "waits for ROADMAP A.4 (apply_values)")

    @property
    def open_loop(self) -> bool:
        return self.arrival_rate > 0


def txn_batch_zeros(lanes: int, slots: int, device) -> TxnBatch:
    zi = torch.zeros((lanes, slots), dtype=torch.int32, device=device)
    return TxnBatch(
        op_key=torch.full((lanes, slots), -1, dtype=torch.int32,
                          device=device),
        op_group=zi, op_col=zi.clone(), op_kind=zi.clone(),
        op_val=torch.zeros((lanes, slots), dtype=torch.float32,
                           device=device),
        op_extent=torch.ones((lanes, slots), dtype=torch.int32,
                             device=device),
        txn_type=torch.zeros((lanes,), dtype=torch.int32, device=device),
        n_ops=torch.zeros((lanes,), dtype=torch.int32, device=device),
    )


def store_init(n_records: int, n_groups: int, n_rings: int = 1,
               need_rts: bool = True, device=None,
               mv_depth: int = 0) -> StoreState:
    """A fresh store on ``device``; ``mv_depth > 0`` allocates the
    version ring (core/mvstore.py), else its placeholders."""
    dev = resolve_device(device)
    G = n_groups

    def table(fill: int) -> torch.Tensor:
        # NO_CLAIM's bit pattern is -1 as int32.
        return torch.full((n_records, G), fill, dtype=torch.int32,
                          device=dev)

    def per_record(dtype) -> torch.Tensor:
        # The record's state and the masked scatters' sink slot.
        return torch.zeros((n_records + SINK,), dtype=dtype, device=dev)
    if mv_depth > 0:
        mv_begin, mv_head, mv_vals = mvstore.mv_init(n_records, mv_depth, G,
                                                     dev)
    else:
        mv_begin, mv_head, mv_vals = mvstore.mv_placeholder(dev)
    return StoreState(
        wts=table(0),
        rts=table(0) if need_rts else torch.zeros((1, 1), dtype=torch.int32,
                                                  device=dev),
        claim_w=table(-1),
        claim_r=table(-1),
        ring_tails=torch.zeros((n_rings,), dtype=torch.int32, device=dev),
        pess_mode=per_record(torch.bool),
        abort_heat=per_record(torch.float32),
        fine_mode=per_record(torch.bool),
        false_heat=per_record(torch.float32),
        heat_wave=per_record(torch.int32),
        mv_begin=mv_begin,
        mv_head=mv_head,
        mv_vals=mv_vals,
    )


def engine_state_init(cfg: EngineConfig, store: StoreState) -> EngineState:
    """A run's first state; open-loop configs get an empty admission
    queue of ``queue_cap`` entries."""
    from repro_torch.core.admission import open_loop_init
    T = cfg.lanes
    dev = store.wts.device

    def zero(*shape, dtype=torch.int64):
        return torch.zeros(shape, dtype=dtype, device=dev)
    cells = ((cfg.n_records, cfg.n_groups) if cfg.track_conflicts
             else (1, 1))
    return EngineState(
        wave=zero(),
        store=store,
        pending=txn_batch_zeros(T, cfg.slots, dev),
        pending_live=zero(T, dtype=torch.bool),
        age=zero(T, dtype=torch.int32),
        lane_time=zero(T, dtype=torch.float32),
        commits=zero(),
        aborts=zero(),
        commits_by_type=zero(cfg.n_txn_types),
        wasted_time=zero(dtype=torch.float32),
        ext_events=zero(),
        ro_commits=zero(),
        ro_aborts=zero(),
        abort_causes=zero(N_ABORT_CAUSES),
        conflict_hits=zero(*cells, dtype=torch.int32),
        conflict_peak=zero(*cells, dtype=torch.int32),
        ol=(open_loop_init(cfg.queue_cap, cfg.slots, cfg.n_txn_types,
                           cfg.lat_bins, dev) if cfg.open_loop else None),
    )
