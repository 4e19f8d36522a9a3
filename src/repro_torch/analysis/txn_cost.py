"""Per-op roofline cost model of the port's backend surface (the twin of
the JAX package's ``analysis/txn_cost.py``).

Every mechanism's wave is a fixed sequence of calls into the backend
surface (core/backend.py); each op's traffic is analytic in the wave
shape: T lanes x K op slots against uint32 claim/version tables of
``cells`` words per op probe (``n_groups`` at coarse granularity, 1 at
fine).  ``OpCost``, ``WaveShape``, ``op_costs``, ``probe_chain``,
``wave_cost`` and ``txn_cost`` keep the JAX package's formulas:

    intensity        = flops_per_wave / bytes_per_wave         [FLOP/B]
    frac_of_roofline = min(1, intensity / ridge(chip))
    bound            = memory below the ridge, compute above

The tables are the port's.  ``WAVE_OPS`` and ``SCAN_WAVE_OPS`` (point
waves, and waves whose config admits scans) and ``DIST_WAVE_OPS`` /
``DIST_SCAN_WAVE_OPS`` (the sharded wave, core/distributed.py) are the
wrappers' ``calls`` over one wave of each mechanism, one launch each on
the card, and give ``launches_per_wave``.  Where one of the port's calls
folds several of the JAX package's (TicToc's one ``ts_gather`` and one
``ts_install_max`` call, a dual ``wave_commit`` on both claim tables, the
bumps inside ``wave_commit`` or ``iterate_validate``, the multi-version
claim installs and ring read inside ``validate``, the sharded owner's
verdict pack and unpack inside its claim and install launches), the call
is charged the bytes and operations of the JAX ops it folds:
``WAVE_WORK`` / ``DIST_WAVE_WORK`` hold those JAX ops, so
``bytes_per_txn`` is the traffic of the same work on either package.
Unlike the JAX package's tables they also charge the cost model's two
``segment_count`` calls a wave (``engine._lane_cost``), and
``iterate_validate`` only where the wave admits scans (no wave of either
package runs it at ``max_extent`` 1).

The ridge is the chip's bf16 tensor-core peak over its HBM rate
(``analysis/peaks.py``, as in the JAX package), so ``roofline_frac`` is
not ``chip_smoke.py``'s ``bound_ms``, which bounds the integer compares
of the wave kernels with the card's 67 Tops/s.

Nothing here imports torch: the model is closed-form, cheap enough to run
in the bench row builder (launch/txn_bench.py) for every grid point.
"""
from __future__ import annotations

import dataclasses

from repro_torch.analysis import peaks

#: Claim / version tables are packed uint32 words (core/claimword.py).
WORD = 4


@dataclasses.dataclass(frozen=True)
class OpCost:
    """Analytic traffic of ONE backend-op call at a given wave shape."""
    bytes_per_call: float
    flops_per_call: float


@dataclasses.dataclass(frozen=True)
class WaveShape:
    """The shape terms the per-op descriptors depend on."""
    lanes: int                 # T
    slots: int                 # K ops per txn
    n_groups: int = 2          # G column groups per record
    granularity: int = 1       # 0 coarse / 1 fine: the paper's switch
    mv_depth: int = 0          # version-ring depth D (mv mechanisms)
    n_shards: int = 1          # distributed: mesh size
    route_cap: int = 0         # distributed: per-destination buffer cap
    max_extent: int = 1        # interval reads: static scan-length bound
    bucket_size: int = 8       # coarse bucket-claim width B (records)

    @property
    def ops(self) -> int:
        return self.lanes * self.slots

    @property
    def cells(self) -> int:
        """Claim words touched per op probe: the whole row at coarse
        granularity, one group word at fine."""
        fine = self.granularity == 1 and self.n_groups > 1
        return 1 if fine else self.n_groups

    @property
    def scan_span(self) -> int:
        """Rows an ``iterate_validate`` probe walks per scan op: the raw
        extent bound at fine granularity, the worst-case bucket expansion
        ``(1 + ceil((ext-1)/B)) * B`` at coarse."""
        if self.max_extent <= 1 or self.granularity == 1:
            return self.max_extent
        b = self.bucket_size
        return (1 + -(-(self.max_extent - 1) // b)) * b


def op_costs(s: WaveShape) -> dict:
    """OpCost per backend-surface op name at shape ``s``: table words
    read (RMW = read + write, WORD bytes each) and the compare/select
    work per cell, the all-pairs same-cell term of ``segment_count``,
    ``claim_probe`` and ``wave_commit`` included."""
    n, c, D = s.ops, s.cells, max(s.mv_depth, 1)
    ns, cap = s.n_shards, max(s.route_cap, 1)
    return {
        "validate": OpCost(WORD * n * c, 2.0 * n * c),
        "validate_dual": OpCost(WORD * n * (1 + s.n_groups),
                                2.0 * n * (1 + s.n_groups)),
        "probe": OpCost(WORD * n * c, 1.0 * n * c),
        "iterate_validate": OpCost(WORD * n * s.scan_span * c,
                                   2.0 * n * s.scan_span * c),
        "claim_probe": OpCost(2 * WORD * n * c, 3.0 * n * c + 2.0 * n * n),
        "claim_scatter": OpCost(2 * WORD * n * c, 1.0 * n * c),
        "ts_gather": OpCost(WORD * n * c, 1.0 * n),
        "commit_install": OpCost(2 * WORD * n * c, 1.0 * n * c),
        "ts_install_max": OpCost(2 * WORD * n * c, 1.0 * n * c),
        "segment_count": OpCost(2 * WORD * n, 2.0 * n + 2.0 * n * n),
        "wave_commit": OpCost(2 * WORD * n * c,
                              4.0 * n * c + 2.0 * n * n),
        "route_pack": OpCost(WORD * 3 * (n + ns * cap), 4.0 * n),
        "mv_gather": OpCost(WORD * n * (D * c + 1), 2.0 * n * D * c),
        "mv_install": OpCost(2 * WORD * n * (c + 1), 2.0 * n * c),
        "verdict_pack": OpCost(n + WORD * -(-n // 16), 1.0 * n),
        "verdict_unpack": OpCost(n + WORD * -(-n // 16), 1.0 * n),
    }


#: The port's backend calls in one local point wave, per mechanism (one
#: launch each on the card).  Every wave calls ``segment_count`` twice in
#: the cost model; TicToc twice more for its extension and install
#: chains, its two timestamp reads are one ``ts_gather`` call and its
#: three installs one ``ts_install_max`` call.  The probe family's one
#: ``wave_commit`` call installs and probes both claim tables on the dual
#: waves (2PL, Adaptive) and bumps the versions; AutoGran installs its
#: claims inside ``validate_dual`` and bumps with ``commit_install``;
#: MVCC and MV-OCC install both claim channels and read the ring inside
#: ``validate``.
WAVE_OPS = {
    "occ": {"wave_commit": 1, "segment_count": 2},
    "tictoc": {"wave_commit": 1, "ts_gather": 1, "ts_install_max": 1,
               "segment_count": 4},
    "2pl": {"wave_commit": 1, "segment_count": 2},
    "swisstm": {"wave_commit": 1, "segment_count": 2},
    "adaptive": {"wave_commit": 1, "segment_count": 2},
    "autogran": {"validate_dual": 1, "commit_install": 1,
                 "segment_count": 2},
    "mvcc": {"validate": 1, "mv_install": 1, "segment_count": 2},
    "mvocc": {"validate": 1, "mv_install": 1, "segment_count": 2},
}

#: The same for a wave whose config admits scans (``max_extent > 1``):
#: one phantom pass, ``iterate_validate``, except under MVCC, whose
#: snapshot scans never re-validate; it bumps the versions in its bump
#: form where the point wave's ``wave_commit`` or ``commit_install`` did
#: (OCC, 2PL, SwissTM, Adaptive, AutoGran).
SCAN_WAVE_OPS = {
    cc: ({k: v for k, v in ops.items() if k != "commit_install"}
         | ({} if cc == "mvcc" else {"iterate_validate": 1}))
    for cc, ops in WAVE_OPS.items()}

#: The JAX package's surface ops that one local wave's calls do, per
#: mechanism, in the JAX package's counting (a dual ``wave_commit`` is
#: two, the bumps ``commit_install``): the JAX ``WAVE_OPS`` table, plus
#: the cost model's two ``segment_count`` calls.  ``iterate_validate``
#: counts only where the wave admits scans.
WAVE_WORK = {
    "occ": {"wave_commit": 1, "commit_install": 1, "iterate_validate": 1,
            "segment_count": 2},
    "tictoc": {"wave_commit": 1, "ts_gather": 2, "segment_count": 4,
               "ts_install_max": 3, "iterate_validate": 1},
    "2pl": {"wave_commit": 2, "commit_install": 1, "iterate_validate": 1,
            "segment_count": 2},
    "swisstm": {"wave_commit": 1, "commit_install": 1,
                "iterate_validate": 1, "segment_count": 2},
    "adaptive": {"wave_commit": 2, "commit_install": 1,
                 "iterate_validate": 1, "segment_count": 2},
    "autogran": {"claim_scatter": 1, "validate_dual": 1,
                 "commit_install": 1, "iterate_validate": 1,
                 "segment_count": 2},
    "mvcc": {"claim_scatter": 2, "validate": 2, "mv_gather": 1,
             "mv_install": 1, "segment_count": 2},
    "mvocc": {"claim_scatter": 2, "validate": 3, "mv_gather": 1,
              "mv_install": 1, "iterate_validate": 1, "segment_count": 2},
}

#: The port's calls in one shard-local wave of the sharded engine
#: (core/distributed.py): the sender's ``route_pack``, ``verdict_unpack``
#: and ``verdict_pack`` (gather forms), the owner's claim call, which
#: packs its verdict words (``wave_commit``, or ``claim_probe`` on both
#: claim tables and the ring under MVCC/MV-OCC), and its install, which
#: reads the commit words.
DIST_WAVE_OPS = {
    "occ": {"route_pack": 1, "wave_commit": 1, "verdict_unpack": 1,
            "verdict_pack": 1, "commit_install": 1},
    "mvcc": {"route_pack": 1, "claim_probe": 1, "verdict_unpack": 1,
             "verdict_pack": 1, "mv_install": 1},
    "mvocc": {"route_pack": 1, "claim_probe": 1, "verdict_unpack": 1,
              "verdict_pack": 1, "mv_install": 1},
}

#: With scans the owner validates its fragments in one
#: ``iterate_validate`` call (words form), except under MVCC.
DIST_SCAN_WAVE_OPS = {
    cc: ops | ({} if cc == "mvcc" else {"iterate_validate": 1})
    for cc, ops in DIST_WAVE_OPS.items()}

#: The JAX package's ops of one shard-local wave (its ``DIST_WAVE_OPS``):
#: the verdict pack and unpack of both return trips, the two claim
#: channels and the ring read of the multi-version owner.
DIST_WAVE_WORK = {
    "occ": {"route_pack": 1, "wave_commit": 1, "verdict_pack": 2,
            "verdict_unpack": 2, "commit_install": 1,
            "iterate_validate": 1},
    "mvcc": {"route_pack": 1, "claim_probe": 2, "mv_gather": 1,
             "verdict_pack": 2, "verdict_unpack": 2, "mv_install": 1},
    "mvocc": {"route_pack": 1, "claim_probe": 2, "mv_gather": 1,
              "verdict_pack": 2, "verdict_unpack": 2, "mv_install": 1,
              "iterate_validate": 1},
}

#: Launches in the UNFUSED probe chain per wave, in the JAX package's
#: counting: the claim/probe RMW pass(es), the verdict reduction and the
#: version bump that ``wave_commit`` collapses into ONE launch.
PROBE_CHAIN_LAUNCHES = {
    "occ": 3,
    "tictoc": 2,
    "2pl": 4,
    "swisstm": 3,
    "adaptive": 4,
}


def probe_chain(cc: str, s: WaveShape, fused: bool = True) -> dict:
    """Launch/row-traffic accounting of mechanism ``cc``'s probe chain at
    shape ``s``: each launch of the unfused chain re-visits the wave's
    touched rows, ``dma_rows_per_wave`` = visits x (T*K); fused, the
    chain is one launch and one visit."""
    if cc not in PROBE_CHAIN_LAUNCHES:
        raise KeyError(f"{cc!r} is not a probe-family mechanism (expected "
                       f"one of {sorted(PROBE_CHAIN_LAUNCHES)})")
    visits = 1 if fused else PROBE_CHAIN_LAUNCHES[cc]
    return {
        "launches_per_wave": visits,
        "dma_rows_per_wave": visits * s.ops,
    }


def wave_calls(cc: str, s: WaveShape, distributed: bool = False) -> dict:
    """The port's backend calls in one wave of mechanism ``cc`` at shape
    ``s`` ({op: calls}; one launch each on the card)."""
    scans = s.max_extent > 1
    if distributed:
        table = DIST_SCAN_WAVE_OPS if scans else DIST_WAVE_OPS
    else:
        table = SCAN_WAVE_OPS if scans else WAVE_OPS
    if cc not in table:
        raise KeyError(f"unknown mechanism {cc!r} (expected one of "
                       f"{sorted(table)})")
    return dict(table[cc])


def wave_work(cc: str, s: WaveShape, distributed: bool = False) -> dict:
    """The JAX package's surface ops that those calls do ({op: count})."""
    table = DIST_WAVE_WORK if distributed else WAVE_WORK
    if cc not in table:
        raise KeyError(f"unknown mechanism {cc!r} (expected one of "
                       f"{sorted(table)})")
    return {op: k for op, k in table[cc].items()
            if op != "iterate_validate" or s.max_extent > 1}


def wave_cost(cc: str, s: WaveShape, distributed: bool = False) -> dict:
    """Roll up mechanism ``cc``'s per-wave traffic at shape ``s``:
    {bytes_per_wave, flops_per_wave, ops: {JAX op: count}, calls: {op:
    the port's calls}, launches_per_wave}."""
    calls = wave_calls(cc, s, distributed)
    counts = wave_work(cc, s, distributed)
    costs = op_costs(s)
    b = sum(costs[op].bytes_per_call * k for op, k in counts.items())
    f = sum(costs[op].flops_per_call * k for op, k in counts.items())
    return {"bytes_per_wave": b, "flops_per_wave": f, "ops": counts,
            "calls": calls, "launches_per_wave": sum(calls.values())}


def txn_cost(cc: str, s: WaveShape, distributed: bool = False,
             chip: str = peaks.DEFAULT_CHIP) -> dict:
    """The dashboard row fields: per-ATTEMPT per-transaction traffic and
    the mechanism's place on ``chip``'s roofline (an aborted incarnation
    pays the same traffic again)."""
    w = wave_cost(cc, s, distributed)
    lanes = max(s.lanes, 1)
    intensity = w["flops_per_wave"] / max(w["bytes_per_wave"], 1.0)
    r = peaks.ridge(chip)
    return {
        "bytes_per_txn": w["bytes_per_wave"] / lanes,
        "flops_per_txn": w["flops_per_wave"] / lanes,
        "intensity": intensity,
        "roofline_frac": min(1.0, intensity / r),
        "bound": "memory" if intensity < r else "compute",
        "chip": chip,
        "launches_per_wave": w["launches_per_wave"],
    }
