"""Smoke test of the PyTorch + CUDA port (src/repro_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's nineteen CUDA kernels (sixteen sources) from
src/repro_torch/csrc, then:

  1. kernels: each kernel against its plain PyTorch version on the card, at
     the main path's shapes (TPC-C: N = 2,450,808 records, T = 128 lanes,
     K = 64 slots; YCSB: N = 10M, K = 16; G = 2; version rings of D = 4),
     over every flag combination, with hot, duplicated, masked (key -1)
     and stale-tag inputs, masks with and without live ops, and a wave
     whose claim tag has its top bit clear; the scan kernel with point
     ops among intervals that cross the table's end, fine and coarse,
     buckets of 8 and 1; the ring kernels with empty slots, reclaimed
     snapshots, stamps on both sides of 2**31, rings that wrap and D = 1.
     Outputs and updated tables must be bit-identical.  Each is timed with
     CUDA events (warm-up, then the median of 30 calls queued behind a
     device sleep so that host overhead stays out of the device time)
     beside its plain version and, where one PyTorch call computes the
     same function, that call; the four scan and ring kernels on a wave
     drawn by the scan-configured workload generator.  The sharded
     engine's kernels at its own shapes (256 lanes of 16 slots, x 2 with
     scans, routed to 1 and 8 shards at DistConfig's capacity, a forced
     drop, a skewed wave, masked owners; verdict rows of ragged length
     and words with bit 31 set), and wave_commit on rows of up to 32,768
     ops; these timed at the one-card shapes.  The backend op probe at
     both shapes, fine and coarse, on keys that are masked, past the
     table's end or hot, over unclaimed, stale and live words, at both
     waves;
  2. the main path on TPC-C (full scale, T = 128, 200 waves) through the
     benchmark CLI's grid runner: OCC, TicToc, 2PL, SwissTM and Adaptive
     x coarse and fine, plus AutoGran coarse, with the launch counters set
     to 0 just before and read just after.  Every kernel of each
     mechanism must have launched, aborts must sum over causes, every
     lane-wave must commit or abort, and OCC-fine must beat OCC-coarse and
     TicToc-coarse (the paper's quickstart ordering), and AutoGran-coarse
     must beat OCC-coarse (the paper's section 5 proposal);
  3. the same main path on YCSB (10M keys, theta 0.9, 50% writes);
  4. the unfused route (claim_probe + commit_install) of the five
     probe-family mechanisms on TPC-C at full scale, counters reset just
     before: claim_probe must launch, commit_install too where the
     mechanism bumps, wave_commit never, and each run must end with the
     fused run's results;
  5. fused = unfused on the card: one set of CPU-made draws through both
     routes, integer and float state bit-identical;
  6. the scan path at full size: TPC-C with scan_len 200 (Stock-level
     examines ~200 items, TPC-C 2.8) and YCSB workload E (10M keys,
     theta 0.9, scanproportion 0.95, maxscanlength 100), T = 128, 200
     waves: the five probe-family mechanisms and MVCC/MV-OCC x coarse and
     fine, plus AutoGran.  MVCC must see no phantom, coarse must see at
     least fine's phantoms for OCC, TicToc and MV-OCC, and every
     mechanism's kernels (iterate_validate and commit_install included)
     must have launched;
  7. the multi-version path at full size: MVCC/MV-OCC x coarse and fine on
     TPC-C, and OCC/MVCC/MV-OCC on YCSB with 80% writes and 20% read-only
     transactions (benchmarks/abort_rates.py): read-only lanes never
     abort under MVCC/MV-OCC and do under coarse OCC; one MVCC run whose
     snapshots are 8 waves old (beyond the ring's 4) aborts as stale;
  8. fused = unfused again with scans on (the bumps move out of
     wave_commit);
  9. cross-device identity: one set of draws made on the CPU, run through
     the wave step on the card (kernels) and on the CPU (plain versions),
     for every mechanism on the point mix, one scan configuration per
     mechanism and the MV configurations; integer state (the version ring
     included) must be bit-identical, lane_time within rtol 1e-5 and the
     heats within rtol 1e-6;
 9b. the backend op probe on a table wave_commit has just installed into
     (TPC-C shape): one launch each, equal to the plain version, every
     installed claim seen;
 9c. examples/quickstart_torch.py's main as it ships (TPC-C 8 warehouses,
     scale 0.5, T = 96, 200 waves): OCC-fine beats OCC-coarse and
     TicToc-coarse;
 9d. fig3's grid through the grid runner (the port's sweep): TPC-C scale
     1.0, OCC, TicToc, 2PL and MV-OCC x coarse and fine x lanes 64, 96,
     128 (one bucket: 64 and 96 run padded to 128), 200 waves; every
     point's commits + aborts == T x waves, causes sum to aborts, every
     kernel launched; fig3's ratio lines printed beside the paper's, and
     OCC-fine@96 must beat TicToc-coarse@96;
 9e. cross-device identity of a padded point (T = 96 of 128) and of one
     open-loop configuration (queue, counters and histogram included);
 9f. the open loop: YCSB (10M keys, theta 0.9, 50% writes), OCC and MVCC x
     coarse and fine, T = 128, 200 waves, arrivals at 96 a wave into a
     queue of 512 with 8 incarnations: admitted == commits + queued +
     inc_drops, offered == admitted + arrival_drops, reenq_drops == 0 and
     inc_cap aborts == inc_drops, exactly; goodput and p50/p99
     time-to-commit printed;
 10. the sharded engine (core/distributed.py) on a one-rank NCCL group:
     YCSB and TPC-C at the main path's sizes and YCSB workload E, 256
     lanes, 200 waves, OCC/MVCC/MV-OCC x coarse and fine and OCC fine
     unfused (workload E: OCC and MV-OCC fine).  Every op of the
     mechanism launches its kernel, causes sum to aborts, MVCC sees no
     phantom, MVCC/MV-OCC abort no read-only lane, the collective carries
     the modelled wire bytes, each run commits exactly the lanes the local
     validator commits on the same draws and prio (tables too), and the
     fused and unfused OCC routes agree; waves/s, device operations per
     wave and collective bytes per wave are printed;
 11. the sharded engine on the card (NCCL) against the CPU (gloo) for 30
     waves at reduced sizes: commit masks, tables and stats bit-identical;
 12. the scaling rows of repro_torch.launch.txn_scaling (the local anchor
     and sharded OCC and MVCC on the JAX benchmark's draws);
 13. LM serving: flash_attention, rglru and rwkv6 against their plain
     versions at the full-width prefill shapes (recurrentgemma-9b: B 4,
     S 3,072, D 4,096; Hq 16 over Hkv 1, D 256, window 2,048; rwkv6-3b:
     B 4, H 48, S 3,072, Dk = Dv = 64), at S = 1 and at edge cases
     (ragged lengths, sk_valid < Sk, sq_valid < Sq, GQA ratios 1 to 16,
     every head width, float32 and bfloat16): float32 within rtol 1e-5 /
     atol 1e-5, bfloat16 within 2 ulps; each timed at the prefill shape
     beside its plain version, its bound and, for flash_attention,
     F.scaled_dot_product_attention with the same mask.  Then
     recurrentgemma-9b and rwkv6-3b at full width (random bf16 weights
     from a seed) through repro_torch.launch.serve.serve: 4 requests of
     3,072-token prompts, 32 tokens each, the launch counters set to 0
     just before and read just after: per prefill one flash_attention per
     attention layer (12) and one rglru (26) or rwkv6 (32) per recurrent
     layer, per decode step the recurrent ones only.  The same weights
     and prompt through the plain route, and both routes on the float32
     model of the same weights: the float32 routes' last-position logits
     of the prefill and of the first decode step within relative L2 1e-2;
     the bf16 routes' distance printed beside that bound (bf16 rounding
     of the residual stream puts two correct evaluations farther apart).

Prints the card's name and power limit, a ``{"kernels": [...]}`` JSON line
and, last, ``{"ok": true, "device": {...}}``.  Any failure raises and exits
non-zero; without CUDA, or without the repository beside it, it exits
non-zero before printing a result.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM published peaks (NVIDIA data sheet): HBM bandwidth and the
# non-tensor-core float32 rate, used as the rate of the integer compares.
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 67e12

TPCC_N, YCSB_N = 2_450_808, 10_000_000
SHAPES = {"tpcc": (TPCC_N, 2, 128, 64), "ycsb": (YCSB_N, 2, 128, 16)}
WAVES = 200
LANES = 128
#: Global lanes of the sharded engine's benchmark (benchmarks/txn_scaling.py)
#: and of the sharded phase.
DIST_LANES = 256
MV_DEPTH = 4
#: The scan path's workload settings: TPC-C's Stock-level window and YCSB
#: workload E (scanproportion 0.95, maxscanlength 100).
SCAN_KW = {"tpcc": dict(scale=1.0, scan_len=200),
           "ycsb": dict(n_keys=YCSB_N, theta=0.9, scan_frac=0.95,
                        scan_len=100)}

KERNEL_META = {
    "wave_commit": ("src/repro_torch/csrc/wave_commit.cu",
                    "src/repro/kernels/wave_commit.py:254"),
    "segment_count": ("src/repro_torch/csrc/segment_count.cu",
                      "src/repro/kernels/segment_count.py:39"),
    "ts_gather": ("src/repro_torch/csrc/ts_gather.cu",
                  "src/repro/kernels/ts_gather.py:42"),
    "ts_install_max": ("src/repro_torch/csrc/ts_install.cu",
                       "src/repro/kernels/ts_install.py:43"),
    "commit_install": ("src/repro_torch/csrc/occ_commit.cu",
                       "src/repro/kernels/occ_commit.py:37"),
    "claim_scatter": ("src/repro_torch/csrc/claim_scatter.cu",
                      "src/repro/kernels/claim_scatter.py:44"),
    "validate_dual": ("src/repro_torch/csrc/occ_validate.cu",
                      "src/repro/kernels/occ_validate.py:122"),
    "claim_probe": ("src/repro_torch/csrc/claim_probe.cu",
                    "src/repro/kernels/claim_probe.py:82"),
    "probe": ("src/repro_torch/csrc/claim_probe.cu",
              "src/repro/kernels/occ_validate.py:155"),
    "validate": ("src/repro_torch/csrc/occ_validate.cu",
                 "src/repro/kernels/occ_validate.py:86"),
    "iterate_validate": ("src/repro_torch/csrc/iterate_validate.cu",
                         "src/repro/kernels/iterate_validate.py:122"),
    "mv_gather": ("src/repro_torch/csrc/mv_gather.cu",
                  "src/repro/kernels/mv_gather.py:64"),
    "mv_install": ("src/repro_torch/csrc/mv_install.cu",
                   "src/repro/kernels/mv_install.py:60"),
    "route_pack": ("src/repro_torch/csrc/route_pack.cu",
                   "src/repro/kernels/route_pack.py:49"),
    "verdict_pack": ("src/repro_torch/csrc/verdict_pack.cu",
                     "src/repro/kernels/verdict_pack.py:50"),
    "verdict_unpack": ("src/repro_torch/csrc/verdict_pack.cu",
                       "src/repro/kernels/verdict_pack.py:65"),
}
#: The kernels that only the sharded engine launches; the kernel phase
#: times them at the sharded wave's shapes.
DIST_KERNELS = ("route_pack", "verdict_pack", "verdict_unpack")
#: The kernels each mechanism's (fused) wave launches on the point mix.
_PROBE_OPS = ("wave_commit", "segment_count")
_MV_OPS = ("validate", "claim_scatter", "mv_gather", "mv_install",
           "segment_count")
MECH_OPS = {"occ": _PROBE_OPS,
            "tictoc": _PROBE_OPS + ("ts_gather", "ts_install_max"),
            "2pl": _PROBE_OPS, "swisstm": _PROBE_OPS, "adaptive": _PROBE_OPS,
            "autogran": ("validate_dual", "claim_scatter", "commit_install",
                         "segment_count"),
            "mvcc": _MV_OPS, "mvocc": _MV_OPS}


def mech_ops(cc: str, scans: bool) -> tuple:
    """The kernels a mechanism's fused wave launches.  With scans every
    mechanism but MVCC adds iterate_validate, and the bumping probe-family
    mechanisms bump through commit_install after the phantom pass."""
    ops = MECH_OPS[cc]
    if scans and cc != "mvcc":
        ops = ops + ("iterate_validate",)
        if cc in ("occ", "2pl", "swisstm", "adaptive"):
            ops = ops + ("commit_install",)
    return ops

PROBE_FAMILY = ("occ", "tictoc", "2pl", "swisstm", "adaptive")
#: One granularity per probe-family mechanism for the unfused phases.
UNFUSED = (("occ", 1), ("tictoc", 0), ("2pl", 0), ("swisstm", 1),
           ("adaptive", 0))
#: A wave whose claim tag 0xFFFF - wave has its top bit clear.
HIGH_WAVE = 40_000
#: The abort-cause code of a lost interval validation (core/types.py).
CAUSE_PHANTOM = 6
#: Cross-device configurations (cc, granularity, fused): every mechanism
#: on the point mix, one scan configuration per mechanism.
POINT_CONFIGS = (("occ", 1, True), ("tictoc", 0, True), ("2pl", 0, True),
                 ("swisstm", 1, True), ("adaptive", 1, True),
                 ("autogran", 0, True), ("adaptive", 0, False),
                 ("mvcc", 1, True), ("mvocc", 0, True))
SCAN_CONFIGS = (("occ", 0, True), ("tictoc", 1, True), ("2pl", 0, True),
                ("swisstm", 1, True), ("adaptive", 0, True),
                ("autogran", 0, True), ("mvcc", 0, True), ("mvocc", 1, True),
                ("2pl", 1, False))


def log(*a):
    print(*a, flush=True)


# ------------------------------------------------------------------ timing
def time_ms(fn, dev, n=30, warmup=5) -> float:
    """Median milliseconds of one call of ``fn`` on ``dev``."""
    for _ in range(warmup):
        fn()
    if dev.type != "cuda":
        ts = []
        for _ in range(n):
            t0 = time.perf_counter()
            fn()
            ts.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(ts)
    torch.cuda.synchronize(dev)
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(n)]
    # Queue every call behind a device sleep, so calls that do not wait
    # for the host run back to back and the events measure device time.
    torch.cuda._sleep(50_000_000)
    for a, b in ev:
        a.record()
        fn()
        b.record()
    torch.cuda.synchronize(dev)
    return statistics.median(a.elapsed_time(b) for a, b in ev)


def bound_ms(n_bytes: float, n_ops: float) -> tuple[float, str]:
    tb, to = n_bytes / PEAK_BYTES_PER_S, n_ops / PEAK_OPS_PER_S
    return max(tb, to) * 1e3, ("bytes" if tb >= to else "operations")


# ------------------------------------------------------------------ inputs
def _words(x: torch.Tensor) -> torch.Tensor:
    from repro_torch.core.claimword import to_i32
    return to_i32(x.to(torch.int64))


def make_tables(N, G, wave, dev, seed):
    """claim_w, claim_r, wts, ts-table on ``dev``: claim words of stale
    waves, the empty word and a few live words of this wave; timestamps
    with some at the top of the uint32 range (the bump wraps)."""
    from repro_torch.core.claimword import inv_wave
    g = torch.Generator(device=dev)
    g.manual_seed(seed)

    def claims():
        old = wave - torch.randint(1, 4, (N, G), generator=g, device=dev)
        inv = 0xFFFF - (old.clamp(min=0) & 0xFFFF)
        words = (inv << 16) | torch.randint(0, 1 << 16, (N, G), generator=g,
                                            device=dev)
        pick = torch.rand((N, G), generator=g, device=dev)
        live = (inv_wave(wave) << 16) | torch.randint(
            0, 1 << 16, (N, G), generator=g, device=dev)
        words = torch.where(pick < 0.3, live, words)
        return torch.where(pick > 0.8, -1, _words(words)).to(torch.int32)
    wts = _words(torch.randint(0, 1 << 32, (N, G), generator=g, device=dev))
    ts = torch.randint(0, 1 << 20, (N, G), generator=g, device=dev,
                       dtype=torch.int32)
    return claims(), claims(), wts, ts


def make_ops(N, G, T, K, dev, seed):
    """keys/groups/prio/masks of one wave: hot keys (a few records many
    ops hit), duplicates and masked ops (key -1)."""
    rng = np.random.default_rng(seed)
    hot = rng.integers(0, N, 8)
    keys = rng.integers(0, N, (T, K))
    pick = rng.random((T, K))
    keys = np.where(pick < 0.3, hot[rng.integers(0, 8, (T, K))], keys)
    keys = np.where(pick > 0.9, -1, keys).astype(np.int32)
    groups = rng.integers(0, G, (T, K)).astype(np.int32)
    prio = np.broadcast_to(((63 << 10) | rng.permutation(T))[:, None],
                           (T, K)).astype(np.int32)
    masks = [rng.random((T, K)) < p for p in (0.5, 0.5, 0.6, 0.4, 0.5, 0.05)]
    vals = rng.integers(0, 1 << 32, (T, K), dtype=np.uint64).astype(
        np.uint32).view(np.int32)

    def d(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    return (d(keys), d(groups), d(prio), [d(m) for m in masks], d(vals))


# ------------------------------------------------------------ kernel phase
def _diff(a: torch.Tensor, b: torch.Tensor) -> float:
    """Largest absolute difference (uint32 words compared as unsigned)."""
    if a.dtype == torch.int32:
        from repro_torch.core.claimword import u32
        a, b = u32(a), u32(b)
    return float((a.double() - b.double()).abs().max()) if a.numel() else 0.0


class KernelCheck:
    def __init__(self, name):
        self.name, self.max_err, self.cases, self.equal = name, 0.0, 0, True

    def compare(self, got, want):
        for a, b in zip(got, want):
            if a is None:
                continue
            self.max_err = max(self.max_err, _diff(a, b))
            self.equal = self.equal and torch.equal(a, b)
        self.cases += 1


def _distinct(keys, groups, mask, G, N):
    """Distinct live (record, group) cells among the masked ops."""
    ok = mask & (keys >= 0) & (keys < N)
    return int(torch.unique(keys[ok].long() * G + groups[ok].long()).numel())


def _distinct_rows(keys, mask, N):
    """Distinct live records among the masked ops."""
    return int(torch.unique(keys[mask & (keys >= 0) & (keys < N)]).numel())


def kernel_phase(dev, shapes, wave=9, dist_lanes=DIST_LANES):
    """Compare every kernel with its plain version over every flag
    combination at ``shapes``, and the sharded wave's kernels at its
    shapes for ``dist_lanes`` lanes; time them.  Returns ({name:
    KernelCheck}, {label: {name: timing dict}}), the sharded wave's
    kernels under the label "dist"."""
    from repro_torch import kernels as K
    from repro_torch.core.claimword import claim_word
    from repro_torch.core.claimword import inv_wave
    from repro_torch.kernels.claim_probe import claim_probe_plain
    from repro_torch.kernels.claim_scatter import claim_scatter_plain
    from repro_torch.kernels.occ_commit import commit_install_plain
    from repro_torch.kernels.occ_validate import validate_dual_plain
    from repro_torch.kernels.segment_count import segment_count_plain
    from repro_torch.kernels.ts_gather import ts_gather_plain
    from repro_torch.kernels.ts_install import ts_install_max_plain
    from repro_torch.kernels.wave_commit import probe_plain, \
        wave_commit_plain
    checks = {n: KernelCheck(n) for n in KERNEL_META}
    timings = {}
    for si, (label, (N, G, T, Kk)) in enumerate(shapes.items()):
        cw0, cr0, wts0, ts0 = make_tables(N, G, wave, dev, seed=si)
        keys, groups, prio, masks, vals = make_ops(N, G, T, Kk, dev, si)
        do_w, do_r, check_w, check_w2, check_r, extra = masks
        for fine in (True, False):
            for dual in (False, True):
                for bump in (False, True):
                    for optional in (True, False):
                        opt = (check_w2, check_r, extra) if optional else \
                            (None, check_r if dual else None, None)
                        outs = []
                        for fn in (K.wave_commit, wave_commit_plain):
                            cw, cr, wt = cw0.clone(), cr0.clone(), \
                                wts0.clone()
                            conflict, commit = fn(
                                cw, cr, wt, keys, groups, prio, do_w, do_r,
                                check_w, opt[0], opt[1], opt[2], wave, fine,
                                dual, bump)
                            outs.append((conflict, commit, cw, cr, wt))
                        checks["wave_commit"].compare(*outs)
        for G_ in (1, 2):
            for mask in (do_w, check_r):
                gr = groups if G_ == 2 else torch.zeros_like(groups)
                checks["segment_count"].compare(
                    [K.segment_count(keys, gr, G_, mask)],
                    [segment_count_plain(keys, gr, G_, mask)])
        for fine in (True, False):
            checks["ts_gather"].compare(
                [K.ts_gather(ts0, keys, groups, fine),
                 K.ts_gather(wts0, keys, groups, fine)],
                [ts_gather_plain(ts0, keys, groups, fine),
                 ts_gather_plain(wts0, keys, groups, fine)])
        for whole_row in (False, True):
            for v in (vals, _words(prio.long() + 7)):
                a, b = ts0.clone(), ts0.clone()
                K.ts_install_max(a, keys, groups, v, do_w, whole_row)
                ts_install_max_plain(b, keys, groups, v, do_w, whole_row)
                checks["ts_install_max"].compare([a], [b])
        # The slice-2 kernels, at this wave and at one whose claim tag has
        # its top bit clear, with and without live ops in the mask.
        none = torch.zeros_like(do_w)
        tables = {wave: (cw0, wts0),
                  HIGH_WAVE: make_tables(N, G, HIGH_WAVE, dev, si + 7)[::2]}
        for wv, (cw_, wts_) in tables.items():
            for inst, chk in ((do_w, check_w), (none, none)):
                a, b = wts_.clone(), wts_.clone()
                K.commit_install(a, keys, groups, inst)
                commit_install_plain(b, keys, groups, inst)
                checks["commit_install"].compare([a], [b])
                a, b = cw_.clone(), cw_.clone()
                K.claim_scatter(a, keys, groups, prio, wv, inst)
                claim_scatter_plain(b, keys, groups, prio, wv, inst)
                checks["claim_scatter"].compare([a], [b])
                checks["validate_dual"].compare(
                    K.validate_dual(cw_, keys, groups, prio, chk, wv),
                    validate_dual_plain(cw_, keys, groups, prio, chk, wv))
                for fine in (True, False):
                    a, b = cw_.clone(), cw_.clone()
                    checks["claim_probe"].compare(
                        [K.claim_probe(a, keys, groups, prio, wv, inst,
                                       fine), a],
                        [claim_probe_plain(b, keys, groups, prio, wv, inst,
                                           fine), b])
            # The probe alone, on the unclaimed, stale and live words of
            # this wave's table and on keys past the table's end.
            past = torch.where(check_w2, N + 5, keys)
            for k in (keys, past):
                for fine in (True, False):
                    checks["probe"].compare(
                        [K.probe(cw_, k, groups, wv, fine)],
                        [probe_plain(cw_, k, groups, inv_wave(wv),
                                     fine).to(torch.int32)])
        del tables
        scan_mv_checks(checks, dev, N, G, keys, groups, prio, masks, wave,
                       seed=si, ext_cap=SCAN_KW.get(label, {}).get(
                           "scan_len", 9))
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

        # ---- timings at this shape (OCC-fine's wave_commit call) -------
        n = T * Kk
        cw, wt = cw0.clone(), wts0.clone()
        # Every timed call sees the same post-install table (min is
        # idempotent), so this call's verdicts are those of every call.
        _, commit = K.wave_commit(
            cw.clone(), None, wt.clone(), keys, groups, prio, do_w, None,
            check_w, None, None, None, wave, True, False, True)
        everyone = torch.ones_like(do_w)
        installs = _distinct(keys, groups, do_w, G, N)
        bumps = _distinct(keys, groups, do_w & commit[:, None], G, N)
        # Op vectors in (keys, groups, prio: 4 B; do_w, check_w: 1 B),
        # conflict bytes and lane verdicts out; each claim cell the fine
        # probe or the install touches read once, each installed cell
        # written once; wts read and written once per committed write.
        wave_bytes = (n * (4 + 4 + 4 + 1 + 1 + 1) + T
                      + _distinct(keys, groups, everyone, G, N) * 4
                      + installs * 4 + bumps * 8)
        seg_bytes = n * (4 + 4 + 1 + 4)
        gather_bytes = n * (4 + 4 + 4) + _distinct(
            keys, groups, everyone, G, N) * 4
        inst_bytes = n * (4 + 4 + 4 + 1) + 2 * 4 * installs
        ok = (keys >= 0) & (keys < N)
        cells = (keys.long() * G + groups.long())
        cells_live = cells[ok]
        seg_cells = torch.where(do_w, cells, -1).reshape(-1)
        ins_cells = cells[do_w & ok]
        # Timestamps below 2**31, where int32 amax is uint32 max.
        ts_vals = (prio + 7).contiguous()
        ins_vals = ts_vals[do_w & ok]
        ts_flat = ts0.clone().view(-1)
        wts_flat = wts0.clone().view(-1)
        cw_flat = cw0.clone().view(-1)
        ins_ones = torch.ones_like(ins_cells, dtype=torch.int32)
        ins_words = _words(claim_word(wave, prio))[do_w & ok]
        probed = _distinct(keys, groups, everyone, G, N)
        checked_rows = _distinct_rows(keys, check_w, N)
        t = {
            "wave_commit": dict(
                ms=time_ms(lambda: K.wave_commit(
                    cw, None, wt, keys, groups, prio, do_w, None, check_w,
                    None, None, None, wave, True, False, True), dev),
                plain_ms=time_ms(lambda: wave_commit_plain(
                    cw, None, wt, keys, groups, prio, do_w, None, check_w,
                    None, None, None, wave, True, False, True), dev),
                library_ms=None,
                bound=bound_ms(wave_bytes, 10 * n)),
            "segment_count": dict(
                ms=time_ms(lambda: K.segment_count(keys, groups, G, do_w),
                           dev),
                plain_ms=time_ms(lambda: segment_count_plain(
                    keys, groups, G, do_w), dev),
                library_ms=time_ms(lambda: torch.unique(
                    seg_cells, return_inverse=True, return_counts=True),
                    dev),
                # A sort-based count: n log2 n compares.
                bound=bound_ms(seg_bytes, n * math.log2(n))),
            "ts_gather": dict(
                ms=time_ms(lambda: K.ts_gather(ts0, keys, groups, True),
                           dev),
                plain_ms=time_ms(lambda: ts_gather_plain(
                    ts0, keys, groups, True), dev),
                library_ms=time_ms(lambda: torch.take(ts0, cells_live),
                                   dev),
                bound=bound_ms(gather_bytes, 0)),
            "ts_install_max": dict(
                ms=time_ms(lambda: K.ts_install_max(
                    ts0, keys, groups, ts_vals, do_w, False), dev),
                plain_ms=time_ms(lambda: ts_install_max_plain(
                    ts0, keys, groups, ts_vals, do_w, False), dev),
                library_ms=time_ms(lambda: ts_flat.scatter_reduce_(
                    0, ins_cells, ins_vals, "amax"), dev),
                bound=bound_ms(inst_bytes, 0)),
            # Op vectors in (keys, groups: 4 B; do: 1 B), one word read and
            # written per distinct bumped cell.
            "commit_install": dict(
                ms=time_ms(lambda: K.commit_install(wt, keys, groups, do_w),
                           dev),
                plain_ms=time_ms(lambda: commit_install_plain(
                    wt, keys, groups, do_w), dev),
                library_ms=time_ms(lambda: wts_flat.index_add_(
                    0, ins_cells, ins_ones), dev),
                bound=bound_ms(n * (4 + 4 + 1) + installs * 8, n)),
            # Keys, groups, prio in, mask byte; a word read and written per
            # distinct installed cell.  The library call's int32 amin is
            # not the unsigned order: it stands for the same work only.
            "claim_scatter": dict(
                ms=time_ms(lambda: K.claim_scatter(
                    cw, keys, groups, prio, wave, do_w), dev),
                plain_ms=time_ms(lambda: claim_scatter_plain(
                    cw, keys, groups, prio, wave, do_w), dev),
                library_ms=time_ms(lambda: cw_flat.scatter_reduce_(
                    0, ins_cells, ins_words, "amin"), dev),
                bound=bound_ms(n * (4 + 4 + 4 + 1) + installs * 8, n)),
            # Op vectors in, two verdict bytes out, one G-word row read per
            # distinct checked record.
            "validate_dual": dict(
                ms=time_ms(lambda: K.validate_dual(
                    cw, keys, groups, prio, check_w, wave), dev),
                plain_ms=time_ms(lambda: validate_dual_plain(
                    cw, keys, groups, prio, check_w, wave), dev),
                library_ms=None,
                bound=bound_ms(n * (4 + 4 + 4 + 1 + 2)
                               + checked_rows * G * 4, n * G)),
            # Keys and groups in, a 4-byte answer out, a word read per
            # distinct probed cell.
            "probe": dict(
                ms=time_ms(lambda: K.probe(cw, keys, groups, wave, True),
                           dev),
                plain_ms=time_ms(lambda: probe_plain(
                    cw, keys, groups, inv_wave(wave), True), dev),
                library_ms=None,
                bound=bound_ms(n * (4 + 4 + 4) + probed * 4, n)),
            # Fine probe: op vectors in, a 4-byte answer out, a word read
            # per distinct probed cell and written per installed cell.
            "claim_probe": dict(
                ms=time_ms(lambda: K.claim_probe(
                    cw, keys, groups, prio, wave, do_w, True), dev),
                plain_ms=time_ms(lambda: claim_probe_plain(
                    cw, keys, groups, prio, wave, do_w, True), dev),
                library_ms=None,
                bound=bound_ms(n * (4 + 4 + 4 + 1 + 4) + probed * 4
                               + installs * 4, 2 * n)),
        }
        t.update(scan_mv_timings(label, dev, N, G, T, Kk, keys, groups,
                                 prio, do_w, wave))
        timings[label] = t
    dist_kernel_checks(checks, dev, dist_lanes)
    timings["dist"] = dist_kernel_timings(dev, dist_lanes)
    for label, t in timings.items():
        for name, r in t.items():
            log(f"  {label:5s} {name:16s} kernel {r['ms']:.6f} ms  plain "
                f"{r['plain_ms']:.4f} ms  library "
                f"{'-' if r['library_ms'] is None else '%.4f' % r['library_ms']}"
                f" ms  bound {r['bound'][0]:.7f} ms ({r['bound'][1]})")
    for c in checks.values():
        log(f"  {c.name:15s} {c.cases} cases vs plain: equal={c.equal} "
            f"max_abs_err={c.max_err}")
        if not c.equal:
            raise AssertionError(f"{c.name} disagrees with its plain "
                                 f"version (max_abs_err {c.max_err})")
    return checks, timings


# ------------------------------------------- scan and ring kernel checks
#: Install timestamps of the rings' second variant: they cross 2**31.
HIGH_TS = 0x7FFFFFF8


def scan_extents(keys, N, ext_cap, seed):
    """Interval starts and extents for the ops of ``make_ops``: 40% point
    ops, the rest scans of 2..ext_cap whose start moves back by up to its
    extent (so hot records fall inside), plus intervals that cross the
    table's end and one whose key lies past it."""
    rng = np.random.default_rng(seed + 100)
    k = keys.cpu().numpy().astype(np.int64)
    ext = np.where(rng.random(k.shape) < 0.4, 1,
                   rng.integers(2, ext_cap + 1, k.shape))
    start = np.where((k >= 0) & (ext > 1),
                     np.maximum(k - rng.integers(0, ext), 0), k)
    start[0, :3] = [N - 3, N - 1, N + 1]
    ext[0, :3] = ext_cap
    dev = keys.device
    return (torch.from_numpy(start.astype(np.int32)).to(dev),
            torch.from_numpy(ext.astype(np.int32)).to(dev))


def post_install_claims(N, G, wave, keys, groups, prio, do_w, dev, seed):
    """A writer-claim table as the phantom pass sees it: words of earlier
    waves everywhere, plus this wave's installed write claims."""
    from repro_torch.kernels.claim_scatter import claim_scatter_plain
    table = make_tables(N, G, max(wave - 4, 0), dev, seed)[0]
    claim_scatter_plain(table, keys, groups, prio, wave, do_w)
    return table


def ring(N, D, G, keys, groups, do, dev, base=0, waves=12):
    """A version ring after ``waves`` waves of installs (stamps base + 1,
    base + 2, ...), each wave's ops rolled so that records differ: hot
    records wrap, most keep empty slots."""
    from repro_torch.core.mvstore import mv_init
    from repro_torch.kernels.mv_install import mv_install_plain
    begin, head, _ = mv_init(N, D, G, dev)
    for w in range(1, waves + 1):
        mv_install_plain(begin, head, torch.roll(keys, w), groups, do,
                         base + w)
    return begin, head


def scan_mv_checks(checks, dev, N, G, keys, groups, prio, masks, wave, seed,
                   ext_cap):
    """The slice-3 kernels against their plain versions, every case."""
    from repro_torch import kernels as K
    from repro_torch.kernels.iterate_validate import iterate_validate_plain
    from repro_torch.kernels.mv_gather import mv_gather_plain
    from repro_torch.kernels.mv_install import mv_install_plain
    from repro_torch.kernels.occ_validate import validate_plain
    do_w, do_r, check_w, check_w2, check_r, extra = masks
    none = torch.zeros_like(do_w)
    starts, ext = scan_extents(keys, N, ext_cap, seed)
    hits = []
    for wv in (wave, HIGH_WAVE):
        dense = make_tables(N, G, wv, dev, seed + 11)[0]
        for fine in (True, False):
            for chk in (check_w, none):
                checks["validate"].compare(
                    [K.validate(dense, keys, groups, prio, chk, wv, fine)],
                    [validate_plain(dense, keys, groups, prio, chk, wv,
                                    fine)])
        table = post_install_claims(N, G, wv, keys, groups, prio, do_w, dev,
                                    seed + 13)
        for fine in (True, False):
            for B in (8, 1):
                for chk in (check_r, none):
                    got = K.iterate_validate(table, starts, ext, groups,
                                             prio, chk, wv, fine, B, ext_cap)
                    checks["iterate_validate"].compare(
                        [got], [iterate_validate_plain(
                            table, starts, ext, groups, prio, chk, wv, fine,
                            B, ext_cap)])
                    hits.append(int(got.sum()))
        del dense, table
    log(f"  iterate_validate conflicts per case: {hits}")
    if not max(hits) > 0:
        raise AssertionError("iterate_validate: no case had a conflict")
    groups_x = groups.clone()
    groups_x[0, :4] = G             # out of range: reads begin 0 when fine
    for base in (0, HIGH_TS):
        begin, _ = ring(N, MV_DEPTH, G, keys, groups, do_w, dev, base)
        for ts in (base + 12, base + 6, base + 3, 0):
            for fine in (True, False):
                checks["mv_gather"].compare(
                    K.mv_gather(begin, keys, groups_x, ts, fine),
                    mv_gather_plain(begin, keys, groups_x, ts, fine))
        del begin
    for D in (MV_DEPTH, 1):
        begin, head = ring(N, D, G, keys, groups, do_w, dev)
        hot = keys[keys >= 0][:4].long()
        head[hot] = D - 1           # rings that wrap on this install
        for do in (do_w, do_r, none):
            a, b = (begin.clone(), head.clone()), (begin.clone(),
                                                   head.clone())
            K.mv_install(*a, keys, groups, do, 13)
            mv_install_plain(*b, keys, groups, do, 13)
            checks["mv_install"].compare(list(a), list(b))
        del begin, head


def _covered_rows(keys, ext, check, N, B, span):
    """Distinct table rows that the checked ops' bucket-expanded (coarse)
    intervals cover."""
    act = check & (keys >= 0)
    k = keys[act].long()
    e = torch.clamp(ext[act], min=1).long()
    start = (k // B) * B
    width = ((k + e + B - 1) // B) * B - start
    j = torch.arange(span, device=keys.device)
    row = start[:, None] + j[None, :]
    on = (j[None, :] < width[:, None]) & (row < N)
    return int(torch.unique(row[on]).numel())


def scan_mv_timings(label, dev, N, G, T, Kk, keys, groups, prio, do_w, wave):
    """Times of the slice-3 kernels on one wave of the scan path: the
    scan-configured workload's draw at the main shapes, else the synthetic
    ops.  Returns {name: timing dict}."""
    from repro_torch import kernels as K
    from repro_torch.kernels.iterate_validate import (iterate_validate_plain,
                                                      scan_span)
    from repro_torch.kernels.mv_gather import mv_gather_plain
    from repro_torch.kernels.mv_install import mv_install_plain
    from repro_torch.kernels.occ_validate import validate_plain
    from repro_torch.launch.txn_bench import make_workload
    ext_cap, ext = 9, None
    if label in SCAN_KW:
        wl = make_workload(label, **SCAN_KW[label])
        if (wl.n_records, wl.slots) != (N, Kk):
            raise ValueError(f"{label}: shape {(N, Kk)} is not the "
                             f"workload's {(wl.n_records, wl.slots)}")
        g = torch.Generator(device=dev)
        g.manual_seed(7)
        b, _ = wl.gen(g, wave, T, torch.zeros((wl.n_rings,),
                                              dtype=torch.int32, device=dev))
        keys, groups, ext = b.op_key, b.op_group, b.op_extent
        live = b.live()
        do_w = b.is_write() & live
        scan = b.is_scan() & b.is_read() & live
        reads = b.is_read() & live & ~b.is_scan()
        ext_cap = wl.max_extent
    else:
        _, ext = scan_extents(keys, N, ext_cap, 0)
        scan = (ext > 1) & (keys >= 0)
        reads = ~scan & (keys >= 0)
    n = T * Kk
    span = scan_span(ext_cap, False, 8)
    table = post_install_claims(N, G, wave, keys, groups, prio, do_w, dev, 5)
    begin, head = ring(N, MV_DEPTH, G, keys, groups, do_w, dev, waves=6)
    rows_read = _distinct_rows(keys, reads, N)
    rows_scanned = _covered_rows(keys, ext, scan, N, 8, span)
    rows_live = _distinct_rows(keys, torch.ones_like(do_w), N)
    rows_written = _distinct_rows(keys, do_w, N)
    ts = [100]

    def install(fn):
        # Each call stamps above the last, as successive waves do.
        ts[0] += 1
        fn(begin, head, keys, groups, do_w, ts[0])
    log(f"  {label:5s} scan wave: {int(scan.sum())} scans over "
        f"{rows_scanned} rows (coarse span {span}), {rows_written} written "
        f"records")
    return {
        # Op vectors in (keys, groups, prio: 4 B; check: 1 B), a verdict
        # byte out, one G-word row read per distinct checked record.
        "validate": dict(
            ms=time_ms(lambda: K.validate(table, keys, groups, prio, reads,
                                          wave, True), dev),
            plain_ms=time_ms(lambda: validate_plain(
                table, keys, groups, prio, reads, wave, True), dev),
            library_ms=None,
            bound=bound_ms(n * (4 + 4 + 4 + 1 + 1) + rows_read * G * 4,
                           n * G)),
        # Coarse (the widest walk): op vectors in (keys, extents, groups,
        # prio: 4 B; check: 1 B), a verdict byte out, each distinct row of
        # the checked bucket-expanded intervals read once.
        "iterate_validate": dict(
            ms=time_ms(lambda: K.iterate_validate(
                table, keys, ext, groups, prio, scan, wave, False, 8,
                ext_cap), dev),
            plain_ms=time_ms(lambda: iterate_validate_plain(
                table, keys, ext, groups, prio, scan, wave, False, 8,
                ext_cap), dev),
            library_ms=None,
            bound=bound_ms(n * (4 * 4 + 1 + 1) + rows_scanned * G * 4,
                           rows_scanned * G)),
        # Keys and groups in, a slot and a flag out, the D x G begin words
        # of each distinct live record read once.
        "mv_gather": dict(
            ms=time_ms(lambda: K.mv_gather(begin, keys, groups, 7, True),
                       dev),
            plain_ms=time_ms(lambda: mv_gather_plain(
                begin, keys, groups, 7, True), dev),
            library_ms=None,
            bound=bound_ms(n * (4 + 4 + 4 + 1)
                           + rows_live * MV_DEPTH * G * 4,
                           n * MV_DEPTH * G)),
        # Keys, groups, mask in; per distinct written record the head read
        # and written and one G-word slot read and one written.
        "mv_install": dict(
            ms=time_ms(lambda: install(K.mv_install), dev),
            plain_ms=time_ms(lambda: install(mv_install_plain), dev),
            library_ms=None,
            bound=bound_ms(n * (4 + 4 + 1) + rows_written * (8 + 2 * G * 4),
                           n)),
    }


# ------------------------------------------- sharded-wave kernel checks
def _dist_cap(lanes, slots, n_dest, scans):
    """DistConfig's automatic capacity for one rank routing ``lanes``
    lanes to ``n_dest`` shards."""
    from repro_torch.core.distributed import DistConfig
    return DistConfig(n_records=1 << 20, lanes_per_shard=lanes, slots=slots,
                      max_extent=2 if scans else 1).cap(n_dest)


def _route_inputs(M, n_dest, dev, seed, skew=False):
    """Owners (a tenth masked: n_dest, -1 or past n_dest; ``skew`` sends
    every live op to destination 0) and three int32 channels."""
    rng = np.random.default_rng(seed)
    owner = rng.integers(0, n_dest, M)
    if skew:
        owner[:] = 0
    pick = rng.random(M)
    owner = np.where(pick < 0.1, rng.choice([n_dest, -1, n_dest + 5], M),
                     owner)
    vals = rng.integers(-2 ** 31, 2 ** 31, (3, M), dtype=np.int64)
    return (torch.from_numpy(owner.astype(np.int32)).to(dev),
            torch.from_numpy(vals.astype(np.int32)).to(dev))


def _verdict_bytes(D, M, dev, seed):
    """int8 verdict rows with every 2-bit pattern, and negative bytes."""
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(-128, 128, (D, M)).astype(
        np.int8)).to(dev)


def _wide_ops(N, G, T, K, dev, seed):
    """make_ops' wave reshaped to [T, K] rows of many lanes each, with a
    prio per op, as the sharded owner's rows of one source shard."""
    keys, groups, _, masks, _ = make_ops(N, G, T, K, dev, seed)
    rng = np.random.default_rng(seed + 1)
    prio = torch.from_numpy(rng.integers(0, 1 << 16, (T, K)).astype(
        np.int32)).to(dev)
    return keys, groups, prio, masks


def dist_kernel_checks(checks, dev, lanes=DIST_LANES, slots=16):
    """route_pack, verdict_pack, verdict_unpack and wide-row wave_commit
    against their plain versions at the sharded wave's shapes: M = lanes
    x slots ops (x 2 with scans) routed to 1 and 8 shards at DistConfig's
    capacity, a forced drop (cap 16) and a skewed wave that overflows its
    destination, masked owners; verdict rows whose length is not a
    multiple of 16 and words with bit 31 set; wave_commit on one row of
    the one-card capacity (16,384 ops; 32,768 with scans) and on 8 rows."""
    from repro_torch import kernels as K
    from repro_torch.core.distributed import LANE_FILL, META_FILL, NO_OP
    from repro_torch.kernels.route_pack import route_pack_plain
    from repro_torch.kernels.verdict_pack import (verdict_pack_plain,
                                                  verdict_unpack_plain)
    from repro_torch.kernels.wave_commit import wave_commit_plain
    fills = (NO_OP, META_FILL, LANE_FILL)
    dropped, negative = [], 0
    for scans in (False, True):
        M = lanes * slots * (2 if scans else 1)
        for n_dest in (1, 8):
            cap = _dist_cap(lanes, slots, n_dest, scans)
            for case, (c, skew) in enumerate(((cap, False), (16, False),
                                              (cap, True))):
                owner, vals = _route_inputs(M, n_dest, dev, 31 * case + M,
                                            skew)
                got = K.route_pack(owner, vals, n_dest, c, fills)
                checks["route_pack"].compare(
                    got, route_pack_plain(owner, vals, n_dest, c, fills))
                dropped.append(int((~got[2] & (owner >= 0)
                                    & (owner < n_dest)).sum()))
            for D in {1, n_dest}:
                for m in (cap, cap - 5, 37):
                    v = _verdict_bytes(D, m, dev, m + D)
                    words = K.verdict_pack(v)
                    negative += int((words < 0).sum())
                    checks["verdict_pack"].compare(
                        [words], [verdict_pack_plain(v)])
                    checks["verdict_unpack"].compare(
                        [K.verdict_unpack(words, m)],
                        [verdict_unpack_plain(words, m)])
                rng = np.random.default_rng(cap + D)
                words = torch.from_numpy(rng.integers(
                    -2 ** 31, 2 ** 31, (D, cap // 16)).astype(np.int32)).to(
                        dev)
                for n in (cap, cap - 3):
                    checks["verdict_unpack"].compare(
                        [K.verdict_unpack(words, n)],
                        [verdict_unpack_plain(words, n)])
    log(f"  route_pack dropped ops per case: {dropped}; verdict words with "
        f"bit 31 set: {negative}")
    if not (min(dropped) == 0 and max(dropped) > 0 and negative > 0):
        raise AssertionError("route_pack/verdict_pack cases must include "
                             "drops, drop-free waves and bit 31")
    N, G, wave = 1 << 20, 2, 9
    cw0, cr0, wts0, _ = make_tables(N, G, wave, dev, seed=3)
    for T, Kk in ((1, _dist_cap(lanes, slots, 1, False)),
                  (1, _dist_cap(lanes, slots, 1, True)),
                  (8, _dist_cap(lanes, slots, 8, False))):
        keys, groups, prio, masks = _wide_ops(N, G, T, Kk, dev, T + Kk)
        do_w, do_r, check_w, check_w2, check_r, extra = masks
        for fine in (True, False):
            for dual, bump in ((False, False), (True, True), (False, True)):
                outs = []
                for fn in (K.wave_commit, wave_commit_plain):
                    cw, cr, wt = cw0.clone(), cr0.clone(), wts0.clone()
                    conflict, commit = fn(
                        cw, cr, wt, keys, groups, prio, do_w, do_r, check_w,
                        check_w2, check_r if dual else None, None, wave,
                        fine, dual, bump)
                    outs.append((conflict, commit, cw, cr, wt))
                checks["wave_commit"].compare(*outs)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def dist_kernel_timings(dev, lanes=DIST_LANES, slots=16, wave=9):
    """Times of the sharded wave's kernels at the one-card shapes (one
    destination, M = lanes x slots ops, cap 16,384), and of wave_commit on
    that one wide row.  Returns {name: timing dict}."""
    from repro_torch import kernels as K
    from repro_torch.core.distributed import LANE_FILL, META_FILL, NO_OP
    from repro_torch.kernels.route_pack import route_pack_plain
    from repro_torch.kernels.verdict_pack import (verdict_pack_plain,
                                                  verdict_unpack_plain)
    from repro_torch.kernels.wave_commit import wave_commit_plain
    fills = (NO_OP, META_FILL, LANE_FILL)
    M, cap = lanes * slots, _dist_cap(lanes, slots, 1, False)
    owner, vals = _route_inputs(M, 1, dev, 5)
    live = int(((owner >= 0) & (owner < 1)).sum())
    cap8 = _dist_cap(lanes, slots, 8, False)
    owner8, vals8 = _route_inputs(M, 8, dev, 7)
    v = _verdict_bytes(1, cap, dev, 6)
    words = K.verdict_pack(v)
    N, G = YCSB_N, 2
    cw0, _, wts0, _ = make_tables(N, G, wave, dev, seed=4)
    keys, groups, prio, masks = _wide_ops(N, G, 1, cap, dev, 8)
    do_w, check_w = masks[0], masks[2]
    cw = cw0.clone()
    everyone = torch.ones_like(do_w)
    wave_bytes = (cap * (4 + 4 + 4 + 1 + 1 + 1) + 1
                  + _distinct(keys, groups, everyone, G, N) * 4
                  + _distinct(keys, groups, do_w, G, N) * 4)
    return {
        # Owner and three channels in, the buffer, pos and took out; one
        # compare per op.
        "route_pack": dict(
            ms=time_ms(lambda: K.route_pack(owner, vals, 1, cap, fills),
                       dev),
            plain_ms=time_ms(lambda: route_pack_plain(owner, vals, 1, cap,
                                                      fills), dev),
            library_ms=None,
            bound=bound_ms(M * 4 + 3 * M * 4 + 3 * cap * 4 + M * 4 + M, M),
            live_ops=live, shape=f"M={M} n_dest=1 cap={cap} W=3"),
        # The same wave routed to 8 shards (one block each).
        "route_pack_8": dict(
            ms=time_ms(lambda: K.route_pack(owner8, vals8, 8, cap8, fills),
                       dev),
            plain_ms=time_ms(lambda: route_pack_plain(owner8, vals8, 8,
                                                      cap8, fills), dev),
            library_ms=None,
            bound=bound_ms(M * 4 + 3 * M * 4 + 3 * 8 * cap8 * 4 + M * 4 + M,
                           M),
            shape=f"M={M} n_dest=8 cap={cap8} W=3"),
        "verdict_pack": dict(
            ms=time_ms(lambda: K.verdict_pack(v), dev),
            plain_ms=time_ms(lambda: verdict_pack_plain(v), dev),
            library_ms=None,
            bound=bound_ms(cap + cap // 16 * 4, cap),
            shape=f"[1, {cap}] int8"),
        "verdict_unpack": dict(
            ms=time_ms(lambda: K.verdict_unpack(words, cap), dev),
            plain_ms=time_ms(lambda: verdict_unpack_plain(words, cap), dev),
            library_ms=None,
            bound=bound_ms(cap // 16 * 4 + cap, cap),
            shape=f"[1, {cap // 16}] int32"),
        # The owner's fused claim on one wide row, without bump (as the
        # sharded owner calls it).
        "wave_commit_wide": dict(
            ms=time_ms(lambda: K.wave_commit(
                cw, None, None, keys, groups, prio, do_w, None, check_w,
                None, None, None, wave, True, False, False), dev),
            plain_ms=time_ms(lambda: wave_commit_plain(
                cw, None, None, keys, groups, prio, do_w, None, check_w,
                None, None, None, wave, True, False, False), dev),
            library_ms=None, bound=bound_ms(wave_bytes, 10 * cap),
            shape=f"[1, {cap}]"),
    }


# --------------------------------------------------------------- main path
def _name(r) -> str:
    return f"{r['cc']}-{'fine' if r['granularity'] else 'coarse'}"


def _log_row(workload, r):
    log(f"  {workload} {_name(r):16s} commits {r['commits']:6d} aborts "
        f"{r['aborts']:6d} thpt {r['throughput']:.4f} txn/us  "
        f"{r['waves_per_s']:.1f} waves/s  "
        f"{r['waves'] * r['lanes'] / r['wall_s']:.0f} lane-txns/s  "
        f"causes {r['abort_causes']}  kernels {r['kernel_ops']}")
    if sum(r["abort_causes"].values()) != r["aborts"]:
        raise AssertionError(f"{_name(r)}: causes do not sum to aborts")
    if r["commits"] + r["aborts"] != r["lanes"] * r["waves"]:
        raise AssertionError(f"{_name(r)}: commits + aborts != T * waves")


def _check_kernels(what, rows, launches, dev, scans):
    """Each run launched exactly its mechanism's kernels ("cuda") and no
    other ported op ("not_run"); every kernel of the phase launched."""
    for r in rows:
        want = {op: "cuda" if op in mech_ops(r["cc"], scans) else "not_run"
                for op in r["kernel_ops"]}
        if dev.type == "cuda" and r["kernel_ops"] != want:
            raise AssertionError(f"{what} {_name(r)}: kernel_ops "
                                 f"{r['kernel_ops']} != {want}")
    log(f"  {what} launches {launches}")
    path_ops = {op for r in rows for op in mech_ops(r["cc"], scans)}
    if dev.type == "cuda" and min(launches[op] for op in path_ops) <= 0:
        raise AssertionError(f"{what}: a kernel never launched")


def main_path(workload, dev, waves=WAVES, lanes=LANES, **wl_kw):
    """Drive the grid runner of the benchmark CLI: the five probe-family
    mechanisms x coarse and fine, then AutoGran coarse.  Returns ({name:
    row}, launches during the run)."""
    from repro_torch import kernels as K
    from repro_torch.launch.txn_bench import run_grid
    K.reset_launches()
    rows = run_grid(workload, list(PROBE_FAMILY), (0, 1), [lanes], waves,
                    device=dev, **wl_kw)
    rows += run_grid(workload, ["autogran"], (0,), [lanes], waves,
                     device=dev, **wl_kw)
    launches = K.launch_counts()
    for r in rows:
        _log_row(workload, r)
    _check_kernels(workload, rows, launches, dev, scans=False)
    return {_name(r): r for r in rows}, launches


def scan_path(workload, dev, waves=WAVES, lanes=LANES, **wl_kw):
    """The main path with the workload's scan classes on: the probe
    family and MVCC/MV-OCC x coarse and fine, then AutoGran.  MVCC sees
    no phantom; coarse sees at least fine's phantoms for OCC, TicToc and
    MV-OCC (benchmarks/scan_mix.py).  Returns ({name: row}, launches)."""
    from repro_torch import kernels as K
    from repro_torch.launch.txn_bench import run_grid
    K.reset_launches()
    rows = run_grid(workload, list(PROBE_FAMILY) + ["mvcc", "mvocc"],
                    (0, 1), [lanes], waves, mv_depth=MV_DEPTH, device=dev,
                    **wl_kw)
    rows += run_grid(workload, ["autogran"], (0,), [lanes], waves,
                     device=dev, **wl_kw)
    launches = K.launch_counts()
    by = {}
    for r in rows:
        by[_name(r)] = r
        _log_row(f"{workload} scans", r)
        if r["max_extent"] != wl_kw["scan_len"]:
            raise AssertionError(f"{_name(r)}: max_extent {r['max_extent']}")
    _check_kernels(f"{workload} scans", rows, launches, dev, scans=True)
    ph = {k: r["abort_causes"]["phantom"] for k, r in by.items()}
    log(f"  {workload} phantom aborts: {ph}")
    if ph["mvcc-coarse"] or ph["mvcc-fine"]:
        raise AssertionError("MVCC scans must never abort as phantoms")
    for cc in ("occ", "tictoc", "mvocc"):
        if ph[f"{cc}-coarse"] < ph[f"{cc}-fine"]:
            raise AssertionError(f"{cc}: coarse phantoms < fine phantoms")
    return by, launches


def mv_path(dev, waves=WAVES, lanes=LANES, tpcc_kw=None, ycsb_kw=None):
    """The multi-version mechanisms at full size: MVCC/MV-OCC x coarse and
    fine on point TPC-C; OCC/MVCC/MV-OCC x coarse and fine on YCSB with
    80% writes and 20% read-only transactions; one MVCC run on YCSB with
    snapshots 8 waves old.  Read-only lanes never abort under MVCC/MV-OCC
    and do under coarse OCC; the aged snapshots abort as stale.  Returns
    ({name: row}, launches)."""
    from repro_torch import kernels as K
    from repro_torch.launch.txn_bench import run_grid
    tpcc_kw = dict(scale=1.0) if tpcc_kw is None else tpcc_kw
    ycsb_kw = (dict(n_keys=YCSB_N, theta=0.9, write_frac=0.8, ro_frac=0.2)
               if ycsb_kw is None else ycsb_kw)
    K.reset_launches()
    rows = run_grid("tpcc", ["mvcc", "mvocc"], (0, 1), [lanes], waves,
                    mv_depth=MV_DEPTH, device=dev, **tpcc_kw)
    rows += run_grid("ycsb", ["occ", "mvcc", "mvocc"], (0, 1), [lanes],
                     waves, mv_depth=MV_DEPTH, device=dev, **ycsb_kw)
    (aged,) = run_grid("ycsb", ["mvcc"], (1,), [lanes], waves,
                       mv_depth=MV_DEPTH, snapshot_age=8, device=dev,
                       **ycsb_kw)
    launches = K.launch_counts()
    by = {}
    for r in rows + [aged]:
        by[f"{r['workload']} {_name(r)}"] = r
        _log_row(f"{r['workload']} mv", r)
        log(f"    ro_commits {r['ro_commits']} ro_aborts {r['ro_aborts']}")
    _check_kernels("mv", rows + [aged], launches, dev, scans=False)
    for r in rows:
        if r["cc"] in ("mvcc", "mvocc") and r["ro_aborts"] != 0:
            raise AssertionError(f"{r['workload']} {_name(r)}: a read-only "
                                 "lane aborted under multi-versioning")
    if not by["ycsb occ-coarse"]["ro_aborts"] > 0:
        raise AssertionError("coarse OCC must abort read-only lanes on the "
                             "write-heavy YCSB mix")
    stale = aged["abort_causes"]["stale_snapshot"]
    log(f"  snapshot_age 8 (ring depth {MV_DEPTH}): {stale} stale aborts")
    if not stale > 0:
        raise AssertionError("snapshots older than the ring must abort")
    return by, launches


def unfused_path(dev, fused, waves=WAVES, lanes=LANES, **wl_kw):
    """The probe family's unfused route on TPC-C at full scale: each run
    must launch claim_probe (and commit_install where it bumps), never
    wave_commit, and end with the fused run's results (same seed, same
    draws).  Returns ({name: row}, launches during the phase)."""
    from repro_torch import kernels as K
    from repro_torch.launch.txn_bench import run_grid
    K.reset_launches()
    by = {}
    for cc, gran in UNFUSED:
        before = K.launch_counts()
        (r,) = run_grid("tpcc", [cc], (gran,), [lanes], waves, device=dev,
                        fuse_wave=False, **wl_kw)
        d = {op: n - before[op] for op, n in K.launch_counts().items()}
        by[_name(r)] = r
        _log_row("tpcc unfused", r)
        bumps = cc != "tictoc"
        if dev.type == "cuda" and not (
                d["claim_probe"] > 0 and d["wave_commit"] == 0
                and (d["commit_install"] > 0) == bumps):
            raise AssertionError(f"unfused {_name(r)}: launches {d}")
        ref = fused[_name(r)]
        for key in ("commits", "aborts", "abort_causes", "throughput",
                    "ext_events"):
            if r.get(key) != ref.get(key):
                raise AssertionError(f"unfused {_name(r)}: {key} "
                                     f"{r.get(key)} != fused {ref.get(key)}")
    launches = K.launch_counts()
    log(f"  unfused launches {launches}")
    return by, launches


def _draws(wl, waves, lanes, seed=5):
    """One set of draws made on the CPU: [(batch, ring tails, perm)]."""
    g = torch.Generator()
    g.manual_seed(seed)
    tails = torch.zeros((wl.n_rings,), dtype=torch.int32)
    out = []
    for w in range(waves):
        fresh, tails = wl.gen(g, w, lanes, tails)
        out.append((fresh, tails, torch.randperm(lanes, generator=g)))
    return out


def _replay(cfg, wl, draws, d, active_lanes=None):
    """The wave step on ``d`` over ``draws``; ``active_lanes`` < T masks
    the lanes past it as the sweep runner pads a point."""
    from repro_torch.core import engine as E
    from repro_torch.core import types as t
    st = t.engine_state_init(cfg, wl.init_store(d, cfg.mv_depth))
    active = (None if active_lanes is None else
              torch.arange(cfg.lanes, device=d) < active_lanes)
    step = E.make_wave_step(cfg, active)
    for fresh, tl, perm in draws:
        fb = t.TxnBatch(**{f.name: getattr(fresh, f.name).to(d)
                           for f in dataclasses.fields(t.TxnBatch)})
        st = step(st, fb, tl.to(d), perm.to(d))
    return st


def _replay_open(cfg, wl, draws, offered, d):
    """The open-loop wave step on ``d`` over ``draws`` and the arrival
    counts ``offered``."""
    from repro_torch.core import engine as E
    from repro_torch.core import types as t
    st = t.engine_state_init(cfg, wl.init_store(d, cfg.mv_depth))
    step = E.make_open_wave_step(cfg)
    for (fresh, tl, perm), n in zip(draws, offered):
        fb = t.TxnBatch(**{f.name: getattr(fresh, f.name).to(d)
                           for f in dataclasses.fields(t.TxnBatch)})
        st, _ = step(st, fb, tl.to(d), perm.to(d), n.to(d))
    return st


INT_STATE = ("commits", "aborts", "commits_by_type", "ext_events",
             "abort_causes", "age", "pending_live", "ro_commits",
             "ro_aborts")
INT_TABLES = ("wts", "rts", "claim_w", "claim_r", "ring_tails", "pess_mode",
              "fine_mode", "heat_wave", "mv_begin", "mv_head")


def _same_state(a, b, what, rtol_time=0.0, rtol_heat=0.0):
    """Integer state bit-identical; lane_time and the heats within the
    given rtol (0: bit-identical)."""
    for name in INT_STATE:
        if not torch.equal(getattr(a, name).cpu(), getattr(b, name).cpu()):
            raise AssertionError(f"{what}: {name} differs")
    for name in INT_TABLES:
        if not torch.equal(getattr(a.store, name).cpu(),
                           getattr(b.store, name).cpu()):
            raise AssertionError(f"{what}: {name} differs")
    torch.testing.assert_close(a.lane_time.cpu(), b.lane_time.cpu(),
                               rtol=rtol_time, atol=0)
    for name in ("abort_heat", "false_heat"):
        torch.testing.assert_close(getattr(a.store, name).cpu(),
                                   getattr(b.store, name).cpu(),
                                   rtol=rtol_heat, atol=0)


def fused_unfused(dev, waves=30, scale=0.1, ccs=UNFUSED, scan_len=0):
    """The same CPU-made draws through the fused route (wave_commit) and
    the unfused route (claim_probe + commit_install) on ``dev`` must give
    the same state, bit for bit; ``scan_len`` > 0 turns TPC-C's scans on,
    which moves the fused route's bumps to commit_install."""
    from repro_torch.launch.txn_bench import make_config
    from repro_torch.workloads import TPCCWorkload
    wl = TPCCWorkload.make(n_warehouses=8, scale=scale, scan_len=scan_len)
    draws = _draws(wl, waves, LANES)
    for cc, gran in ccs:
        a, b = (_replay(make_config(wl, cc, gran, LANES, fuse), wl, draws,
                        dev) for fuse in (True, False))
        _same_state(a, b, f"fused/unfused {cc}")
        log(f"  {cc}-{'fine' if gran else 'coarse'}"
            f"{' scans' if scan_len else ''}: {waves} waves, commits "
            f"{int(a.commits)} aborts {int(a.aborts)} phantoms "
            f"{int(a.abort_causes[CAUSE_PHANTOM])}: fused = unfused on "
            f"{dev}")


def cross_device(dev, waves=30, scale=0.1, scan_len=0,
                 configs=POINT_CONFIGS):
    """The same CPU-made draws through the wave step on ``dev`` (kernels)
    and on the CPU (plain versions) must give the same state; TPC-C with
    its scans on when ``scan_len`` > 0."""
    from repro_torch.launch.txn_bench import make_config
    from repro_torch.workloads import TPCCWorkload
    wl = TPCCWorkload.make(n_warehouses=8, scale=scale, scan_len=scan_len)
    draws = _draws(wl, waves, LANES)
    cpu = torch.device("cpu")
    for cc, gran, fuse in configs:
        cfg = make_config(wl, cc, gran, LANES, fuse, mv_depth=MV_DEPTH)
        a, b = (_replay(cfg, wl, draws, d) for d in (dev, cpu))
        what = (f"{cc}-{'fine' if gran else 'coarse'}"
                + (" scans" if scan_len else "") + ("" if fuse else
                                                    " unfused"))
        _same_state(a, b, f"cross-device {what}", rtol_time=1e-5,
                    rtol_heat=1e-6)
        log(f"  {what}: {waves} waves, commits {int(a.commits)} aborts "
            f"{int(a.aborts)} ext {int(a.ext_events)} pess "
            f"{int(a.store.pess_mode.sum())} fine "
            f"{int(a.store.fine_mode.sum())} phantoms "
            f"{int(a.abort_causes[CAUSE_PHANTOM])} ring heads moved "
            f"{int((a.store.mv_head != 0).sum())}: identical on {dev} and "
            "cpu")


# ------------------------------------------------ backend op and figures
def backend_probe_path(dev, wave=9):
    """The backend op ``probe`` on the card: ``wave_commit`` installs one
    wave's write claims at the TPC-C shape (OCC-fine, through the
    backend), then ``Backend.probe`` reads the installed table.  Counters
    set to 0 just before, read just after: one launch each.  Returns the
    launches."""
    from repro_torch import kernels as K
    from repro_torch.core.backend import BACKEND
    from repro_torch.core.claimword import NO_PRIO, inv_wave
    from repro_torch.kernels.wave_commit import probe_plain
    N, G, T, Kk = SHAPES["tpcc"]
    cw, _, wts, _ = make_tables(N, G, wave, dev, seed=31)
    keys, groups, prio, masks, _ = make_ops(N, G, T, Kk, dev, seed=31)
    do_w, _, check_w = masks[:3]
    K.reset_launches()
    _, commit = BACKEND.wave_commit(cw, None, wts, keys, groups, prio, do_w,
                                    None, check_w, None, None, None, wave,
                                    True, False, True)
    got = BACKEND.probe(cw, keys, groups, wave, True)
    launches = K.launch_counts()
    want = probe_plain(cw, keys, groups, inv_wave(wave), True)
    claimed = do_w & (keys >= 0)
    log(f"  wave_commit committed {int(commit.sum())} of {T} lanes; probe "
        f"of the installed table: {int((got != NO_PRIO).sum())} ops see a "
        f"live claimant; launches {launches}")
    if not torch.equal(got, want.to(torch.int32)):
        raise AssertionError("Backend.probe disagrees with probe_plain on "
                             "the installed table")
    if bool((got[claimed] == NO_PRIO).any()):
        raise AssertionError("probe missed a claim wave_commit installed")
    if dev.type == "cuda" and not (launches["probe"] == 1
                                   and launches["wave_commit"] == 1):
        raise AssertionError(f"backend probe: launches {launches}")
    return launches


def quickstart_path(dev):
    """examples/quickstart_torch.py's main as it ships (TPC-C 8
    warehouses, scale 0.5, T = 96, 200 waves) on ``dev``: OCC-fine must
    beat OCC-coarse and TicToc-coarse.  Returns ({name: SimResult},
    launches)."""
    import importlib.util
    from repro_torch import kernels as K
    spec = importlib.util.spec_from_file_location(
        "quickstart_torch", os.path.join(ROOT, "examples",
                                         "quickstart_torch.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    K.reset_launches()
    res = mod.main(["--device", dev.type])
    launches = K.launch_counts()
    th = {k: r.throughput for k, r in res.items()}
    log(f"  quickstart: OCC-fine / OCC-coarse "
        f"{th['occ-fine'] / th['occ-coarse']:.4f}  OCC-fine / "
        f"TicToc-coarse {th['occ-fine'] / th['tictoc-coarse']:.4f} "
        f"(paper: 1.37x at 96 threads); launches {launches}")
    if not th["occ-fine"] > max(th["occ-coarse"], th["tictoc-coarse"]):
        raise AssertionError("quickstart: OCC-fine must beat OCC-coarse "
                             "and TicToc-coarse")
    if dev.type == "cuda" and min(launches[op] for op in MECH_OPS["tictoc"]
                                  ) <= 0:
        raise AssertionError("quickstart: a kernel never launched")
    return res, launches


#: The figures phase's grid: fig3's mechanisms of the paper's headline
#: (and MV-OCC) x coarse and fine x one lane bucket, so 64 and 96 run
#: padded to 128 under the mask.
FIG3_CCS = ("occ", "tictoc", "2pl", "mvocc")
FIG3_LANES = (64, 96, 128)


def figures_path(dev, waves=WAVES, **wl_kw):
    """fig3's grid through the benchmark CLI's grid runner (the port's
    sweep): every padded point's commits + aborts == T x waves and causes
    sum to aborts; every kernel of each mechanism launched; fig3's ratio
    lines printed, OCC-fine@96 > TicToc-coarse@96 (the paper's headline).
    Returns (rows, launches, ratios)."""
    from repro_torch import kernels as K
    from repro_torch.benchmarks.fig3_tpcc import report
    from repro_torch.launch.txn_bench import run_grid
    K.reset_launches()
    rows = run_grid("tpcc", list(FIG3_CCS), (0, 1), list(FIG3_LANES), waves,
                    mv_depth=MV_DEPTH, device=dev, **wl_kw)
    launches = K.launch_counts()
    for r in rows:
        _log_row(f"fig3 T={r['lanes']}/{r['lanes_run']}", r)
        if r["lanes_run"] != max(FIG3_LANES):
            raise AssertionError(f"{_name(r)}@{r['lanes']}: ran at "
                                 f"{r['lanes_run']} lanes")
    _check_kernels("fig3", rows, launches, dev, scans=False)
    ratios = report(rows)
    if not ratios["occ-fine@96/tictoc-coarse@96"] > 1.0:
        raise AssertionError("fig3: OCC-fine@96 must beat TicToc-coarse@96")
    return rows, launches, ratios


#: The open-loop phase's traffic: YCSB at the main path's size, arrivals
#: at 3/4 of the lane width (as benchmarks/scan_mix.py's open loop);
#: txn_bench.make_config gives the queue (4 x 128 lanes = 512 entries) and
#: the 8 incarnations.
OPEN_KW = dict(n_keys=YCSB_N, theta=0.9, write_frac=0.5, arrival_rate=96.0)


def open_loop_path(dev, waves=WAVES, lanes=LANES, **kw):
    """OCC and MVCC x coarse and fine, open-loop, through the grid runner:
    the admission identities hold exactly.  Returns (rows, launches)."""
    from repro_torch import kernels as K
    from repro_torch.launch.txn_bench import run_grid
    K.reset_launches()
    rows = run_grid("ycsb", ["occ", "mvcc"], (0, 1), [lanes], waves,
                    mv_depth=MV_DEPTH, device=dev, **{**OPEN_KW, **kw})
    launches = K.launch_counts()
    for r in rows:
        log(f"  open {_name(r):12s} goodput {r['goodput']:.4f} txn/us  "
            f"p50 {r['p50_ttc_waves']} p99 {r['p99_ttc_waves']} waves  "
            f"offered {r['offered']} admitted {r['admitted']} commits "
            f"{r['commits']} queued {r['queued_final']} inc_drops "
            f"{r['inc_drops']} arrival_drops {r['arrival_drops']} "
            f"reenq_drops {r['reenq_drops']}  {r['waves_per_s']:.1f} "
            f"waves/s  causes {r['abort_causes']}")
        if not (r["admitted"] == r["commits"] + r["queued_final"]
                + r["inc_drops"]
                and r["offered"] == r["admitted"] + r["arrival_drops"]
                and r["reenq_drops"] == 0
                and r["abort_causes"]["inc_cap"] == r["inc_drops"]
                and sum(r["abort_causes"].values()) == r["aborts"]):
            raise AssertionError(f"open loop {_name(r)}: an admission "
                                 "identity fails")
    _check_kernels("open loop", rows, launches, dev, scans=False)
    return rows, launches


def cross_device_padded(dev, waves=30, scale=0.1, active_lanes=96,
                        configs=(("occ", 1), ("tictoc", 0), ("mvocc", 1))):
    """One point below its bucket maximum (``active_lanes`` of LANES) from
    CPU-made draws through the masked wave step on ``dev`` and on the CPU:
    integer state bit-identical, lane_time within rtol 1e-5; padding
    lanes never count."""
    from repro_torch.launch.txn_bench import make_config
    from repro_torch.workloads import TPCCWorkload
    wl = TPCCWorkload.make(n_warehouses=8, scale=scale)
    draws = _draws(wl, waves, LANES)
    cpu = torch.device("cpu")
    for cc, gran in configs:
        cfg = make_config(wl, cc, gran, LANES, mv_depth=MV_DEPTH)
        a, b = (_replay(cfg, wl, draws, d, active_lanes) for d in (dev, cpu))
        what = f"{cc}-{'fine' if gran else 'coarse'} T={active_lanes}"
        _same_state(a, b, f"cross-device padded {what}", rtol_time=1e-5,
                    rtol_heat=1e-6)
        if int(a.commits + a.aborts) != active_lanes * waves:
            raise AssertionError(f"{what}: padding lanes counted")
        log(f"  {what} of {LANES}: {waves} waves, commits {int(a.commits)} "
            f"aborts {int(a.aborts)}: identical on {dev} and cpu")


def cross_device_open(dev, waves=30, n_keys=100_000, configs=(("mvcc", 1),)):
    """One open-loop configuration from CPU-made draws and arrival counts
    through the open step on ``dev`` and on the CPU: integer state, the
    admission counters, the histogram and the queue bit-identical."""
    from repro_torch.launch.txn_bench import make_config, make_workload
    from repro_torch.workloads.arrivals import poisson_offered
    rate = OPEN_KW["arrival_rate"]
    wl = make_workload("ycsb", n_keys=n_keys, theta=0.9)
    draws = _draws(wl, waves, LANES)
    g = torch.Generator()
    g.manual_seed(6)
    offered = [poisson_offered(g, rate, LANES) for _ in range(waves)]
    cpu = torch.device("cpu")
    for cc, gran in configs:
        cfg = make_config(wl, cc, gran, LANES, mv_depth=MV_DEPTH,
                          arrival_rate=rate)
        a, b = (_replay_open(cfg, wl, draws, offered, d) for d in (dev, cpu))
        what = f"open {cc}-{'fine' if gran else 'coarse'}"
        _same_state(a, b, f"cross-device {what}", rtol_time=1e-5,
                    rtol_heat=1e-6)
        for name in ("next_id", "offered", "admitted", "arrival_drops",
                     "inc_drops", "reenq_drops", "lat_hist"):
            if not torch.equal(getattr(a.ol, name).cpu(),
                               getattr(b.ol, name).cpu()):
                raise AssertionError(f"cross-device {what}: {name} differs")
        for f in dataclasses.fields(a.ol.queue):
            if not torch.equal(getattr(a.ol.queue, f.name).cpu(),
                               getattr(b.ol.queue, f.name).cpu()):
                raise AssertionError(f"cross-device {what}: queue "
                                     f"{f.name} differs")
        log(f"  {what} (queue {cfg.queue_cap}, {cfg.max_incarnations} "
            f"incarnations): {waves} waves, offered {int(a.ol.offered)} "
            f"commits {int(a.commits)} queued {int(a.ol.queue.size)} inc_drops "
            f"{int(a.ol.inc_drops)}: identical on {dev} and cpu")



# ------------------------------------------------------------ sharded path
#: The sharded phase's sources: the main path's YCSB and TPC-C and YCSB
#: workload E, at their own sizes.
DIST_SOURCES = {
    "ycsb": ("ycsb", dict(n_keys=YCSB_N, theta=0.9, write_frac=0.5)),
    "tpcc": ("tpcc", dict(scale=1.0)),
    "ycsb_e": ("ycsb", dict(n_keys=YCSB_N, theta=0.9, **{
        k: v for k, v in SCAN_KW["ycsb"].items() if k.startswith("scan")})),
}
#: (cc, granularity, fused) per source: OCC, MVCC and MV-OCC at both
#: granularities and OCC fine unfused on the point mixes; OCC and MV-OCC
#: fine on workload E.
_DIST_POINT = (("occ", 0, True), ("occ", 1, True), ("mvcc", 0, True),
               ("mvcc", 1, True), ("mvocc", 0, True), ("mvocc", 1, True),
               ("occ", 1, False))
DIST_CONFIGS = {"ycsb": _DIST_POINT, "tpcc": _DIST_POINT,
                "ycsb_e": (("occ", 1, True), ("mvocc", 1, True))}
#: The card = CPU check's reduced sources and configurations.
DIST_CROSS_SOURCES = {
    "ycsb": ("ycsb", dict(n_keys=100_000, theta=0.9, write_frac=0.5)),
    "tpcc": ("tpcc", dict(scale=0.05)),
    "ycsb_e": ("ycsb", dict(n_keys=100_000, theta=0.9, scan_frac=0.95,
                            scan_len=100)),
}
DIST_CROSS_CONFIGS = {
    "ycsb": (("occ", 0, True), ("occ", 1, False), ("mvcc", 1, True),
             ("mvocc", 0, True)),
    "tpcc": (("occ", 1, True), ("mvcc", 0, True), ("mvocc", 1, True)),
    "ycsb_e": (("occ", 0, True), ("mvcc", 1, True), ("mvocc", 1, True)),
}


def dist_config(wl, cc, gran, fuse, lanes):
    from repro_torch.core.distributed import DistConfig
    return DistConfig(n_records=wl.n_records, n_groups=wl.n_groups,
                      lanes_per_shard=lanes, slots=wl.slots,
                      granularity=gran, cc=cc,
                      mv_depth=MV_DEPTH if cc != "occ" else 0,
                      max_extent=wl.max_extent, fuse_wave=fuse)


def dist_draws(wl, waves, lanes, dev, seed=13):
    """``waves`` fresh batches from the workload's generator on ``dev``, each
    with a lane permutation as its prio: ([(batch, prio)], the stacked
    wire inputs (keys, groups, kinds, prio)); kinds pack each op's extent
    (``kind | extent << 2``) when the workload scans."""
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    tails = torch.zeros((wl.n_rings,), dtype=torch.int32, device=dev)
    out = []
    for w in range(waves):
        b, tails = wl.gen(g, w, lanes, tails)
        out.append((b, torch.randperm(lanes, generator=g, device=dev).to(
            torch.int32)))
    kinds = [b.op_kind | (b.op_extent << 2) if wl.max_extent > 1
             else b.op_kind for b, _ in out]
    return out, (torch.stack([b.op_key for b, _ in out]),
                 torch.stack([b.op_group for b, _ in out]),
                 torch.stack(kinds), torch.stack([p for _, p in out]))


def run_sharded(cfg, group, stacked, dev):
    """One run of the sharded engine over the stacked draws on fresh
    tables: (commit [waves, T], tables, stats [waves, STATS_LEN], host
    seconds, bytes handed to the collective)."""
    from repro_torch.core import distributed as D
    waves = stacked[0].shape[0]
    tables = D.init_tables(cfg, group, dev)
    run = D.make_run_fn(cfg, waves, group)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    commit, tables, stats = run(*stacked, tables)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return (commit, tables, stats, time.perf_counter() - t0,
            run.exchange.bytes_sent)


def local_replay(wl, cc, gran, lanes, draws, dev):
    """The local validator of ``cc`` on the same draws and prio, without
    window thinning: (commit [waves, T], its tables in the sharded
    engine's order)."""
    from repro_torch.core import types as t
    from repro_torch.core.cc import VALIDATORS
    from repro_torch.launch.txn_bench import make_config
    cfg = dataclasses.replace(
        make_config(wl, cc, gran, lanes, mv_depth=MV_DEPTH),
        cost=t.CostModel(opt_overlap=1.0, phase_overlap=1.0))
    store = t.store_init(wl.n_records, wl.n_groups, wl.n_rings, device=dev,
                         mv_depth=cfg.mv_depth)
    commits = []
    for w, (batch, prio) in enumerate(draws):
        store, res = VALIDATORS[cfg.cc](store, batch, prio, w, cfg)
        commits.append(res.commit)
    tables = ((store.claim_w, store.claim_r, store.mv_begin, store.mv_head)
              if cfg.cc in t.MV_CCS else (store.wts, store.claim_w))
    return torch.stack(commits), tables


def _same_run(a, b, what):
    """Commit masks, tables and stats (where both have them)
    bit-identical."""
    for name, x, y in (("commit", a[0], b[0]), ("stats", a[2], b[2])):
        if x is not None and y is not None and not torch.equal(x.cpu(),
                                                               y.cpu()):
            raise AssertionError(f"{what}: {name} differs")
    for i, (x, y) in enumerate(zip(a[1], b[1])):
        if not torch.equal(x.cpu(), y.cpu()):
            raise AssertionError(f"{what}: table {i} differs")


def _profile_run(cfg, group, stacked, dev, n=20):
    """Device events, busy ms, idle share and top kernels per wave over
    ``n`` waves (the card only)."""
    if dev.type != "cuda":
        return {}
    from repro_torch.launch.wave_profile import profile_device
    head = tuple(x[:n] for x in stacked)
    r = profile_device(lambda: run_sharded(cfg, group, head, dev), n)
    return {k: r[k] for k in ("device_events_per_wave",
                              "device_busy_ms_per_wave",
                              "device_idle_share", "top_device")}


def sharded_path(dev, group=None, waves=WAVES, lanes=DIST_LANES,
                 sources=DIST_SOURCES, configs=DIST_CONFIGS):
    """The sharded engine (core/distributed.make_run_fn) on ``group``'s
    shards over the port's generators: every configuration's kernels
    launch ("cuda" for every op, iterate_validate only with scans), the
    causes sum to the aborts, MVCC sees no phantom and MVCC/MV-OCC abort
    no read-only lane; at one shard each run commits exactly the lanes the
    local validator commits, with the same tables; fused = unfused.  The
    launch counters are set to 0 just before each run and read just
    after.  Returns ({name: row}, launches over the runs, runs)."""
    from repro_torch import kernels as K
    from repro_torch.core import distributed as D
    from repro_torch.core import types as t
    from repro_torch.core.backend import dist_kernel_coverage
    from repro_torch.launch.txn_bench import make_workload
    ns = D.n_shards(group)
    total = {op: 0 for op in K.WRAPPERS}
    by, path_ops = {}, set()
    for src, (kind, kw) in sources.items():
        wl = make_workload(kind, **kw)
        draws, stacked = dist_draws(wl, waves, lanes, dev)
        fused = {}
        # A short run first, so that no configuration's pace pays for the
        # first use of the collective and the kernels.
        run_sharded(dist_config(wl, *configs[src][0], lanes), group,
                    tuple(x[:3] for x in stacked), dev)
        for cc, gran, fuse in configs[src]:
            cfg = dist_config(wl, cc, gran, fuse, lanes)
            name = (f"{src} {cc}-{'fine' if gran else 'coarse'}"
                    + ("" if fuse else " unfused"))
            K.reset_launches()
            out = run_sharded(cfg, group, stacked, dev)
            launches, calls = K.launch_counts(), K.call_counts()
            for op in total:
                total[op] += launches[op]
            commit, tables, stats, secs, sent = out
            s = stats.to(torch.int64).sum(dim=0).cpu().tolist()
            cov = dist_kernel_coverage(cc, launches, calls, fuse)
            scans = cfg.max_extent > 1
            want = {op: ("not_run" if op == "iterate_validate" and not scans
                         else "cuda" if dev.type == "cuda" else "torch")
                    for op in cov}
            row = {"commits": s[D.STAT_COMMITS], "aborts": s[D.STAT_ABORTS],
                   "ro_commits": s[D.STAT_RO_COMMITS],
                   "ro_aborts": s[D.STAT_RO_ABORTS],
                   "dropped_ops": s[D.STAT_DROPPED_OPS],
                   "abort_causes": {t.CAUSE_NAMES[i]: n for i, n in
                                    enumerate(s[D.STAT_CAUSES])},
                   "waves_per_s": waves / secs,
                   "coll_bytes_per_wave": sent / waves,
                   "wire_bytes_per_wave": D.wire_bytes_per_wave(
                       cfg, ns)["wire_bytes_per_wave"],
                   "cap": cfg.cap(ns), "kernel_ops": cov,
                   **_profile_run(cfg, group, stacked, dev)}
            by[name] = row
            log(f"  {name:24s} commits {row['commits']:6d} aborts "
                f"{row['aborts']:6d} ro {row['ro_commits']}/"
                f"{row['ro_aborts']}  {row['waves_per_s']:.1f} waves/s  "
                f"coll {row['coll_bytes_per_wave']:.0f} B/wave  device ops/"
                f"wave {row.get('device_events_per_wave', 'not measured')}"
                f"  busy ms/wave "
                f"{row.get('device_busy_ms_per_wave', 'not measured')}"
                f"  idle {row.get('device_idle_share', 'not measured')}  "
                f"causes {row['abort_causes']}  kernels {cov}  top "
                f"{row.get('top_device', [])[:3]}")
            path_ops |= {op for op, v in want.items() if v != "not_run"}
            if cov != want:                                        # (a)
                raise AssertionError(f"sharded {name}: kernel_ops {cov} != "
                                     f"{want}")
            if sum(s[D.STAT_CAUSES]) != s[D.STAT_ABORTS]:          # (e)
                raise AssertionError(f"sharded {name}: causes do not sum "
                                     "to aborts")
            if s[D.STAT_COMMITS] + s[D.STAT_ABORTS] != lanes * ns * waves:
                raise AssertionError(f"sharded {name}: commits + aborts != "
                                     "lanes x waves")
            if cc == "mvcc" and s[D.STAT_CAUSE0 + CAUSE_PHANTOM]:
                raise AssertionError(f"sharded {name}: MVCC saw a phantom")
            if cc != "occ" and s[D.STAT_RO_ABORTS]:
                raise AssertionError(f"sharded {name}: a read-only lane "
                                     "aborted under multi-versioning")
            if row["coll_bytes_per_wave"] != row["wire_bytes_per_wave"]:
                raise AssertionError(f"sharded {name}: collective bytes "
                                     "differ from the wire model")
            if ns == 1:                                            # (b)
                lc, lt = local_replay(wl, cc, gran, lanes, draws, dev)
                _same_run((commit, tables, None), (lc, lt, None),
                          f"sharded {name} vs the local validator")
            if cc == "occ" and gran == 1:
                fused[fuse] = out[:3]
        if len(fused) == 2:                                        # (d)
            _same_run(fused[True], fused[False], f"{src} fused/unfused")
            log(f"  {src}: OCC fine fused = unfused")
        if ns == 1:
            log(f"  {src}: one shard = the local validator in every "
                "configuration")
    log(f"  sharded launches {total}")
    if dev.type == "cuda" and min(total[op] for op in path_ops) <= 0:
        raise AssertionError("sharded path: a kernel never launched")
    return by, total, sum(len(c) for c in configs.values())


def sharded_cross_device(dev, group=None, cpu_group=None, waves=30,
                         lanes=DIST_LANES, sources=DIST_CROSS_SOURCES,
                         configs=DIST_CROSS_CONFIGS):
    """The same CPU-made draws through the sharded engine on ``dev`` (the
    kernels, over ``group``) and on the CPU (the plain versions, over the
    gloo ``cpu_group``): commit masks, tables and stats bit-identical."""
    from repro_torch.core import distributed as D
    from repro_torch.launch.txn_bench import make_workload
    cpu = torch.device("cpu")
    for src, (kind, kw) in sources.items():
        wl = make_workload(kind, **kw)
        _, stacked = dist_draws(wl, waves, lanes, cpu)
        on_dev = tuple(x.to(dev) for x in stacked)
        for cc, gran, fuse in configs[src]:
            cfg = dist_config(wl, cc, gran, fuse, lanes)
            a = run_sharded(cfg, group, on_dev, dev)
            b = run_sharded(cfg, cpu_group, stacked, cpu)
            what = (f"{src} {cc}-{'fine' if gran else 'coarse'}"
                    + ("" if fuse else " unfused"))
            _same_run(a[:3], b[:3], f"sharded cross-device {what}")
            st = a[2].to(torch.int64).sum(dim=0).tolist()
            log(f"  {what}: {waves} waves, commits {st[D.STAT_COMMITS]} "
                f"aborts {st[D.STAT_ABORTS]} "
                f"dropped ops {st[D.STAT_DROPPED_OPS]} phantoms "
                f"{st[D.STAT_CAUSE0 + CAUSE_PHANTOM]}: "
                f"identical on {dev} and cpu")


# ------------------------------------------------------------- LM serving
#: The language-model kernels (slice 5): source and the TPU kernel each
#: replaces.
LM_KERNEL_META = {
    "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:80"),
    "rglru": ("src/repro_torch/csrc/rglru.cu",
              "src/repro/kernels/rglru_scan.py:38"),
    "rwkv6": ("src/repro_torch/csrc/rwkv6.cu",
              "src/repro/kernels/rwkv6_scan.py:43"),
}
#: H100 SXM dense bf16 tensor-core peak (NVIDIA data sheet).
PEAK_BF16_OPS_PER_S = 989e12
#: The served models at full width, and their traffic: 4 requests of
#: 3,072-token prompts (longer than recurrentgemma's 2,048 window and the
#: JAX kernels' 2,048-step chunk), 32 tokens each.
LM_ARCHS = ("recurrentgemma-9b", "rwkv6-3b")
LM_TRAFFIC = dict(n_requests=4, prompt_len=3072, gen=32)
#: Relative L2 error allowed between the kernel route's and the plain
#: route's last-position logits on the card (the float32 model; the bf16
#: model's is reported against it, see lm_serve_path).
LM_ROUTE_RTOL = 1e-2
#: Kernel-check cases: (label, shape dict, dtype).  The first of each is
#: the full-width prefill shape, the second decode (S = 1).
FLASH_CASES = (
    ("rg9b-prefill", dict(B=4, Hq=16, Hkv=1, Sq=3072, Sk=3072, D=256,
                          causal=True, window=2048), torch.bfloat16),
    ("S=1", dict(B=4, Hq=16, Hkv=1, Sq=1, Sk=2048, D=256, causal=False,
                 window=None), torch.bfloat16),
    ("ragged sk_valid rep4", dict(B=2, Hq=8, Hkv=2, Sq=100, Sk=300, D=64,
                                  causal=True, window=64, sk_valid=250),
     torch.float32),
    ("rep1 D128", dict(B=1, Hq=4, Hkv=4, Sq=200, Sk=200, D=128,
                       causal=True, window=None), torch.float32),
    ("rep16 window", dict(B=1, Hq=16, Hkv=1, Sq=130, Sk=130, D=256,
                          causal=True, window=50), torch.bfloat16),
    ("full D64", dict(B=2, Hq=4, Hkv=1, Sq=70, Sk=70, D=64, causal=False,
                      window=None), torch.bfloat16),
    ("sq_valid", dict(B=1, Hq=4, Hkv=2, Sq=64, Sk=100, D=128, causal=True,
                      window=None, sq_valid=40, sk_valid=90),
     torch.float32),
    ("D16", dict(B=2, Hq=4, Hkv=2, Sq=45, Sk=45, D=16, causal=True,
                 window=32), torch.float32),
    ("D32", dict(B=2, Hq=2, Hkv=1, Sq=77, Sk=77, D=32, causal=True,
                 window=32), torch.bfloat16),
)
RGLRU_CASES = (
    ("rg9b-prefill", dict(B=4, S=3072, D=4096), torch.bfloat16),
    ("S=1", dict(B=4, S=1, D=4096), torch.bfloat16),
    ("ragged f32", dict(B=2, S=1000, D=300), torch.float32),
    ("short bf16", dict(B=3, S=17, D=4096), torch.bfloat16),
)
RWKV_CASES = (
    ("rwkv6-3b-prefill", dict(B=4, H=48, S=3072, Dk=64, Dv=64),
     torch.bfloat16),
    ("S=1", dict(B=4, H=48, S=1, Dk=64, Dv=64), torch.bfloat16),
    ("f32", dict(B=2, H=3, S=100, Dk=64, Dv=64), torch.float32),
    ("Dk16", dict(B=2, H=4, S=37, Dk=16, Dv=16), torch.float32),
    ("Dk32 Dv48", dict(B=1, H=2, S=20, Dk=32, Dv=48), torch.bfloat16),
    ("Dk128", dict(B=1, H=2, S=9, Dk=128, Dv=128), torch.float32),
)


def bf16_ulps(a: torch.Tensor, b: torch.Tensor) -> int:
    """Largest distance of two bfloat16 tensors in units in the last
    place."""
    def ordered(x):
        i = x.contiguous().view(torch.int16).to(torch.int32)
        return torch.where(i >= 0, i, -(i & 0x7FFF))
    return int((ordered(a) - ordered(b)).abs().max()) if a.numel() else 0


class LMCheck:
    """A kernel against its plain version: float32 within rtol 1e-5 /
    atol 1e-5; bfloat16 within 2 bf16 ulps (values within 1e-5 of each
    other pass: near 0 one float32 rounding step spans many ulps)."""

    def __init__(self, name):
        self.name, self.cases, self.max_err, self.max_ulps = name, 0, 0.0, 0

    def compare(self, label, got, want):
        for i, (a, b) in enumerate(zip(got, want)):
            what = f"{self.name} {label} output {i}"
            if a.dtype != b.dtype or a.shape != b.shape:
                raise AssertionError(f"{what}: {a.dtype}{tuple(a.shape)} "
                                     f"vs {b.dtype}{tuple(b.shape)}")
            if not bool(torch.isfinite(a.float()).all()):
                raise AssertionError(f"{what}: not finite")
            err = (a.float() - b.float()).abs()
            self.max_err = max(self.max_err, float(err.max()))
            if a.dtype == torch.bfloat16:
                far = err > 1e-5
                ulps = bf16_ulps(a[far], b[far])
                self.max_ulps = max(self.max_ulps, ulps)
                if ulps > 2:
                    raise AssertionError(f"{what}: {ulps} bf16 ulps apart")
            elif not bool((err <= 1e-5 + 1e-5 * b.float().abs()).all()):
                raise AssertionError(f"{what}: beyond rtol/atol 1e-5 (max "
                                     f"abs err {float(err.max())})")
        self.cases += 1


def _randn(shape, dev, gen, scale=1.0, dtype=torch.float32):
    return (torch.randn(shape, generator=gen, device=dev) * scale).to(dtype)


def flash_inputs(s, dtype, dev, gen):
    D = s["D"]
    q = _randn((s["B"], s["Hq"], s["Sq"], D), dev, gen, D ** -0.25, dtype)
    k = _randn((s["B"], s["Hkv"], s["Sk"], D), dev, gen, D ** -0.25, dtype)
    v = _randn((s["B"], s["Hkv"], s["Sk"], D), dev, gen, 1.0, dtype)
    kw = dict(causal=s["causal"], window=s["window"],
              sq_valid=s.get("sq_valid"), sk_valid=s.get("sk_valid"))
    return (q, k, v), kw


def rglru_inputs(s, dtype, dev, gen):
    B, S, D = s["B"], s["S"], s["D"]
    # log_a as the model makes it: -8 softplus(lam) sigmoid(.) in [-0.1, 0)
    log_a = -0.1 * torch.rand((B, S, D), generator=gen, device=dev)
    return (log_a, _randn((B, S, D), dev, gen, 1.0, dtype),
            _randn((B, D), dev, gen)), {}


def rwkv_inputs(s, dtype, dev, gen):
    B, H, S, Dk, Dv = s["B"], s["H"], s["S"], s["Dk"], s["Dv"]
    r = _randn((B, H, S, Dk), dev, gen, 0.5, dtype)
    k = _randn((B, H, S, Dk), dev, gen, 0.5, dtype)
    v = _randn((B, H, S, Dv), dev, gen, 1.0, dtype)
    w = torch.rand((B, H, S, Dk), generator=gen, device=dev) * 0.9 + 0.05
    u = _randn((H, Dk), dev, gen)
    s0 = _randn((B, H, Dk, Dv), dev, gen)
    return (r, k, v, w, u, s0), {}


def flash_work(s, dtype, dev) -> tuple[float, float, float]:
    """(bytes, operations, peak rate) of one call: q, k, v read once and
    out written once; 4 D flops per visible (q, k) pair of this mask."""
    from repro_torch.kernels.flash_attention import attention_mask
    Sq, Sk = s["Sq"], s["Sk"]
    mask = attention_mask(Sq, Sk, causal=s["causal"], window=s["window"],
                          sq_valid=s.get("sq_valid") or Sq,
                          sk_valid=s.get("sk_valid") or Sk, device=dev)
    pairs = int(mask.sum()) * s["B"] * s["Hq"]
    el = torch.finfo(dtype).bits // 8
    n_bytes = el * s["D"] * (2 * s["B"] * s["Hq"] * Sq
                             + 2 * s["B"] * s["Hkv"] * Sk)
    rate = PEAK_BF16_OPS_PER_S if dtype == torch.bfloat16 else PEAK_OPS_PER_S
    return n_bytes, 4.0 * s["D"] * pairs, rate


def rglru_work(s, dtype, dev):
    n = s["B"] * s["S"] * s["D"]
    el = torch.finfo(dtype).bits // 8
    # log_a (f32) and x read, h written; h0 read and h_last written (f32);
    # an exp, a sqrt and five flops an element.
    return (n * (4 + 2 * el) + 8 * s["B"] * s["D"], 7.0 * n,
            PEAK_OPS_PER_S)


def rwkv_work(s, dtype, dev):
    B, H, S, Dk, Dv = s["B"], s["H"], s["S"], s["Dk"], s["Dv"]
    el = torch.finfo(dtype).bits // 8
    n_bytes = (el * B * H * S * (2 * Dk + 2 * Dv) + 4 * B * H * S * Dk
               + 4 * H * Dk + 8 * B * H * Dk * Dv)
    return n_bytes, 4.0 * B * H * S * Dk * Dv, PEAK_OPS_PER_S


def _flash_library(args, kw):
    """One PyTorch call computing the same function: scaled dot-product
    attention with the same boolean mask (kv heads repeated first,
    outside the timing).  A yardstick only; the port never calls it."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import attention_mask
    q, k, v = args
    rep = q.shape[1] // k.shape[1]
    kk, vv = (k.repeat_interleave(rep, 1), v.repeat_interleave(rep, 1))
    Sq, Sk = q.shape[2], k.shape[2]
    mask = attention_mask(Sq, Sk, causal=kw["causal"], window=kw["window"],
                          sq_valid=kw["sq_valid"] or Sq,
                          sk_valid=kw["sk_valid"] or Sk, device=q.device)
    return lambda: F.scaled_dot_product_attention(q, kk, vv, attn_mask=mask)


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def lm_kernel_phase(dev, seed=21, cases=None):
    """Each LM kernel against its plain version on the card over its
    cases (full-width prefill shape, S = 1 and the edges), then timed at
    the first case's shape (the full-width prefill) beside its plain
    version, its bound and, for flash_attention, the PyTorch yardstick.
    ``cases`` ({name: cases}) replaces the default cases (a rehearsal on
    the CPU at small shapes).  Returns ({name: LMCheck}, {name: timing
    row})."""
    from repro_torch import kernels as K
    from repro_torch.kernels.flash_attention import flash_attention_plain
    from repro_torch.kernels.rglru import rglru_plain
    from repro_torch.kernels.rwkv6 import rwkv6_plain
    table = {
        "flash_attention": (K.flash_attention, flash_attention_plain,
                            FLASH_CASES, flash_inputs, flash_work),
        "rglru": (K.rglru, rglru_plain, RGLRU_CASES, rglru_inputs,
                  rglru_work),
        "rwkv6": (K.rwkv6, rwkv6_plain, RWKV_CASES, rwkv_inputs,
                  rwkv_work),
    }
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    checks, timings = {}, {}
    for name, (kernel, plain, default, inputs, work) in table.items():
        chk = checks[name] = LMCheck(name)
        for i, (label, s, dtype) in enumerate((cases or {}).get(name,
                                                                default)):
            args, kw = inputs(s, dtype, dev, gen)
            got, want = kernel(*args, **kw), plain(*args, **kw)
            _sync(dev)
            got = got if isinstance(got, tuple) else (got,)
            want = want if isinstance(want, tuple) else (want,)
            chk.compare(label, got, want)
            if i:
                continue
            n_bytes, n_ops, rate = work(s, dtype, dev)
            tb, to = n_bytes / PEAK_BYTES_PER_S, n_ops / rate
            row = {"ms": time_ms(lambda: kernel(*args, **kw), dev),
                   "plain_ms": time_ms(lambda: plain(*args, **kw), dev, n=3,
                                       warmup=1),
                   "bound": (max(tb, to) * 1e3,
                             "bytes" if tb >= to else "operations"),
                   "library_ms": None, "bytes": n_bytes, "ops": n_ops,
                   "shape": f"{label} "
                            + " ".join(f"{k}={v}" for k, v in s.items())
                            + f" {str(dtype).split('.')[-1]}"}
            if name == "flash_attention":
                row["library_ms"] = time_ms(_flash_library(args, kw), dev)
            timings[name] = row
            del args, got, want
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        log(f"  {name:15s} {chk.cases} cases vs plain: max_abs_err "
            f"{chk.max_err:.3g}, max bf16 ulps {chk.max_ulps}")
        r = timings[name]
        log(f"  {name:15s} kernel {r['ms']:.6f} ms  plain "
            f"{r['plain_ms']:.4f} ms  library "
            f"{'-' if r['library_ms'] is None else '%.4f' % r['library_ms']}"
            f" ms  bound {r['bound'][0]:.6f} ms ({r['bound'][1]}; "
            f"{r['bytes'] / 1e6:.1f} MB, {r['ops'] / 1e9:.2f} Gop)  "
            f"[{r['shape']}]")
    return checks, timings


def _lm_profiles(cfg, params, prompt, first, s_cache, n_decode=4):
    """torch.profiler over one prefill and ``n_decode`` decode steps of the
    kernel route: wall and device-busy ms, idle share, device events and
    the top kernels, per prefill and per decode step."""
    from repro_torch.launch.wave_profile import profile_device
    from repro_torch.models import steps
    prefill = steps.build_prefill_step(cfg, s_cache)
    decode = steps.build_decode_step(cfg)
    state = {}

    def run_prefill():
        state["cache"], _ = prefill(params, {"tokens": prompt})

    def run_decode():
        for i in range(n_decode):
            _, state["cache"] = decode(params, state["cache"], first,
                                       prompt.shape[1] + i)

    return {"prefill": profile_device(run_prefill, 1),
            "decode step": profile_device(run_decode, n_decode)}


def _route_logits(cfg, params, prompt, first, s_cache, plain):
    """Last-position logits of the prefill of ``prompt`` and of one
    decode step on ``first``, float32 on the host."""
    from repro_torch.models import steps
    cache, prefill = steps.build_prefill_step(cfg, s_cache, plain=plain)(
        params, {"tokens": prompt})
    decode, _ = steps.build_decode_step(cfg, plain=plain)(
        params, cache, first, prompt.shape[1])
    return prefill.float().cpu(), decode.float().cpu()


def rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm().clamp_min(1e-300))


def lm_serve_path(dev, arch, seed=0, smoke=False, **traffic):
    """``arch`` at full width through repro_torch.launch.serve.serve, the
    kernels' launch counters set to 0 just before and read just after:
    flash_attention once per attention layer in the prefill and never in
    decode, rglru and rwkv6 once per recurrent layer in the prefill and
    in every decode step, nothing else.  Then the same weights and prompt
    through the plain route (prefill and one decode step on the kernel
    route's first token), and both routes on the float32 model of the
    same weights.  Checked: the float32 routes' last-position logits
    within relative L2 LM_ROUTE_RTOL, and the bf16 kernel route at most
    twice as far from the float32 model as the bf16 plain route (plus
    LM_ROUTE_RTOL): both round the same model to bf16, where a wrong
    kernel is off by the logits' whole scale.  The bf16 routes' distance
    to each other is reported against LM_ROUTE_RTOL, not checked: bf16
    rounding of the residual stream turns any last-bit difference of a
    kernel's output into 1-ulp changes of many of the next residual's
    elements, layer after layer, so two correct evaluations of the bf16
    model can differ by more than that bound.  ``smoke`` serves the smoke
    configuration (a rehearsal on the CPU, where nothing launches).
    Returns (summary row, launches of the served run)."""
    import gc
    from repro_torch import configs
    from repro_torch import kernels as K
    from repro_torch.data.pipeline import tokens as draw_tokens
    from repro_torch.launch.serve import serve
    from repro_torch.models import model as model_mod
    from repro_torch.models.common import flatten, tree_map
    traffic = {**LM_TRAFFIC, **traffic}
    B, S, G = traffic["n_requests"], traffic["prompt_len"], traffic["gen"]
    cfg = configs.get_smoke(arch) if smoke else configs.get(arch)
    t0 = time.perf_counter()
    params = model_mod.init_params(cfg, seed, dev)
    n_params = sum(t.numel() for _, t in flatten(params))
    g = torch.Generator(device=dev)
    g.manual_seed(seed + 1)
    prompt = draw_tokens(g, (B, S), cfg.vocab)
    _sync(dev)
    log(f"  {arch}: {n_params / 1e9:.3f} B parameters drawn on the card in "
        f"{time.perf_counter() - t0:.2f} s")

    K.reset_launches()
    res = serve(cfg, seed=seed, device=dev, tokens=prompt, params=params,
                **traffic)
    launches = K.launch_counts()
    types = cfg.layer_types()
    per_layer = {}          # the CPU launches no kernel
    if dev.type == "cuda":
        per_layer = {"flash_attention": types.count("attn"),
                     "rglru": types.count("rec"),
                     "rwkv6": types.count("rwkv")}
    want_prefill = {op: per_layer.get(op, 0) for op in K.WRAPPERS}
    want_decode = dict(want_prefill, flash_attention=0)
    if len(res.launches) != G or res.launches[0] != want_prefill:
        raise AssertionError(f"{arch} prefill launches {res.launches[0]}, "
                             f"want {want_prefill}")
    for i, step in enumerate(res.launches[1:]):
        if step != want_decode:
            raise AssertionError(f"{arch} decode step {i} launches {step}, "
                                 f"want {want_decode}")
    if launches != {op: want_prefill[op] + (G - 1) * want_decode[op]
                    for op in K.WRAPPERS}:
        raise AssertionError(f"{arch}: launches over the run {launches}")
    toks = torch.from_numpy(res.tokens)
    if (res.tokens.shape != (B, G) or int(toks.min()) < 0
            or int(toks.max()) >= cfg.vocab):
        raise AssertionError(f"{arch}: tokens {res.tokens.shape} out of "
                             f"range")
    for what, lg in (("prefill", res.prefill_logits),
                     ("decode", res.decode_logits)):
        if lg.shape != (B, cfg.vocab) or not bool(torch.isfinite(lg).all()):
            raise AssertionError(f"{arch} {what} logits {lg.shape} not "
                                 f"finite")

    # Where the device time goes: one prefill and 4 decode steps of the
    # served (kernel) route under torch.profiler.
    first = toks[:, :1].to(dev)
    profiles = {}
    if dev.type == "cuda":
        profiles = _lm_profiles(cfg, params, prompt, first, S + G)

    # The plain route on the same weights, prompt and first token; then
    # both routes on the float32 model of the same weights.
    logits = {("bf16", "kernel"): (res.prefill_logits, res.decode_logits),
              ("bf16", "plain"): _route_logits(cfg, params, prompt, first,
                                               S + G, plain=True)}
    cfg32 = dataclasses.replace(cfg, param_dtype="float32")
    params = tree_map(lambda t: t.float(), params)
    for route in ("kernel", "plain"):
        logits[("f32", route)] = _route_logits(cfg32, params, prompt, first,
                                               S + G, plain=route == "plain")
    errs = {}
    for i, step in enumerate(("prefill", "decode")):
        def e(a, b):
            return rel_l2(logits[a][i], logits[b][i])
        errs[step] = {
            "bf16 kernel vs plain": e(("bf16", "kernel"), ("bf16", "plain")),
            "f32 kernel vs plain": e(("f32", "kernel"), ("f32", "plain")),
            "bf16 kernel vs f32 plain": e(("bf16", "kernel"),
                                          ("f32", "plain")),
            "bf16 plain vs f32 plain": e(("bf16", "plain"),
                                         ("f32", "plain"))}
    same_first = bool((logits[("bf16", "plain")][0].argmax(-1)
                       == toks[:, 0]).all())
    row = {"arch": arch, "params": n_params, "requests": B,
           "prompt_len": S, "gen": G,
           "prefill_ms": res.prefill_s * 1e3,
           "decode_tok_per_s": res.decode_tokens_per_s,
           "decode_ms_per_step": res.decode_s * 1e3 / max(G - 1, 1),
           "peak_gib": res.peak_bytes / 2**30,
           "route_rel_l2": errs, "plain_first_token_same": same_first,
           "bf16_routes_within_bound": all(
               v["bf16 kernel vs plain"] <= LM_ROUTE_RTOL
               for v in errs.values()),
           "tokens_request0": res.tokens[0].tolist(),
           "launches": {op: n for op, n in launches.items() if n},
           "profile": profiles}
    log(f"  {arch}: prefill {row['prefill_ms']:.3f} ms, decode "
        f"{row['decode_tok_per_s']:.2f} tok/s "
        f"({row['decode_ms_per_step']:.3f} ms a step), peak "
        f"{row['peak_gib']:.3f} GiB (torch.cuda.max_memory_allocated)")
    for step, v in errs.items():
        log(f"  {arch}: {step} logits, relative L2: "
            + ", ".join(f"{k} {x:.4g}" for k, x in v.items()))
    log(f"  {arch}: bf16 kernel vs plain route within {LM_ROUTE_RTOL}: "
        f"{row['bf16_routes_within_bound']}; same first token: "
        f"{same_first}")
    for step, pr in profiles.items():
        log(f"  {arch} profiled {step}: {pr['wall_ms_per_wave_profiled']:.3f}"
            f" ms wall, {pr['device_busy_ms_per_wave']:.3f} ms device-busy, "
            f"idle share {pr['device_idle_share']:.4f}, "
            f"{pr['device_events_per_wave']:.1f} device events; top: "
            + "; ".join(f"{t['name'][:48]} {t['ms_per_wave']:.3f} ms "
                        f"x{t['per_wave']:.0f}" for t in pr["top_device"][:5]))
    log(f"  {arch}: greedy tokens of request 0: {row['tokens_request0']}")
    log(f"  {arch}: launches {row['launches']}")
    for step, v in errs.items():
        if not v["f32 kernel vs plain"] <= LM_ROUTE_RTOL:
            raise AssertionError(f"{arch} {step}: float32 kernel and plain "
                                 f"routes differ by relative L2 "
                                 f"{v['f32 kernel vs plain']}")
        if not (v["bf16 kernel vs f32 plain"]
                <= 2 * v["bf16 plain vs f32 plain"] + LM_ROUTE_RTOL):
            raise AssertionError(f"{arch} {step}: the bf16 kernel route is "
                                 f"more than twice as far from the float32 "
                                 f"model as the plain route: {v}")
    del params, res, logits, prompt
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return row, launches


def ratios(workload, by):
    """Log the paper's orderings: OCC-fine over OCC-coarse and
    TicToc-coarse (quickstart), 2PL over TicToc coarse at T=128 (Fig 3a),
    and AutoGran's share of the coarse-to-fine OCC gain
    (benchmarks/auto_granularity.py)."""
    th = {k: r["throughput"] for k, r in by.items()}
    share = ((th["autogran-coarse"] - th["occ-coarse"])
             / max(th["occ-fine"] - th["occ-coarse"], 1e-9))
    log(f"  {workload}: OCC-fine / OCC-coarse "
        f"{th['occ-fine'] / th['occ-coarse']:.4f}  OCC-fine / TicToc-coarse "
        f"{th['occ-fine'] / th['tictoc-coarse']:.4f}  2PL / TicToc coarse "
        f"{th['2pl-coarse'] / th['tictoc-coarse']:.4f}  AutoGran-coarse / "
        f"OCC-coarse {th['autogran-coarse'] / th['occ-coarse']:.4f}, "
        f"recovering {share:.4f} of the OCC fine gain")


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False: this smoke "
              "test needs an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch import kernels as K
    from repro_torch.kernels import build
    dev = torch.device("cuda")
    t_start = time.perf_counter()
    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__}  CUDA {torch.version.cuda}  "
        f"python {sys.version.split()[0]}")

    t0 = time.perf_counter()
    logs = build.build()
    log(f"build: {time.perf_counter() - t0:.2f} s for {sorted(logs)}")
    for name, text in sorted(logs.items()):
        for line in text.splitlines():
            if ("registers" in line or "spill" in line
                    or "error" in line.lower()):
                log(f"  {name}: {line.strip()}")

    log("kernels vs plain versions:")
    checks, timings = kernel_phase(dev, SHAPES)

    log("main path, TPC-C:")
    tpcc, l_tpcc = main_path("tpcc", dev, scale=1.0)
    ratios("tpcc", tpcc)
    occ_f = tpcc["occ-fine"]["throughput"]
    if not (occ_f > tpcc["occ-coarse"]["throughput"]
            and occ_f > tpcc["tictoc-coarse"]["throughput"]):
        raise AssertionError("quickstart ordering fails: OCC-fine must beat "
                             "OCC-coarse and TicToc-coarse on TPC-C")
    # The JAX reference orders them so at TPC-C scale 0.1, T=128 (its CLI,
    # jnp backend, on the CPU).
    if not tpcc["autogran-coarse"]["throughput"] > tpcc["occ-coarse"][
            "throughput"]:
        raise AssertionError("AutoGran-coarse must beat OCC-coarse on TPC-C")

    log("main path, YCSB:")
    ycsb, l_ycsb = main_path("ycsb", dev, n_keys=YCSB_N, theta=0.9,
                             write_frac=0.5)
    ratios("ycsb", ycsb)

    log("unfused route, TPC-C:")
    _, l_unf = unfused_path(dev, tpcc, scale=1.0)

    log("scan path, TPC-C:")
    tpcc_s, l_tpcc_s = scan_path("tpcc", dev, **SCAN_KW["tpcc"])
    log("scan path, YCSB:")
    ycsb_s, l_ycsb_s = scan_path("ycsb", dev, **SCAN_KW["ycsb"])

    log("multi-version path:")
    mv, l_mv = mv_path(dev)

    log("fused = unfused on the card:")
    fused_unfused(dev)
    fused_unfused(dev, scan_len=SCAN_KW["tpcc"]["scan_len"])

    log("cross-device identity:")
    cross_device(dev)
    cross_device(dev, waves=20, scan_len=SCAN_KW["tpcc"]["scan_len"],
                 configs=SCAN_CONFIGS)

    log("backend op probe on the card:")
    l_probe = backend_probe_path(dev)
    log("quickstart (examples/quickstart_torch.py):")
    _, l_quick = quickstart_path(dev)
    log("figures: fig3's grid through the port's sweep:")
    fig_rows, l_fig, fig_ratios = figures_path(dev, scale=1.0)
    log("fig3_ratios " + json.dumps(fig_ratios))
    log("cross-device identity with padding:")
    cross_device_padded(dev)
    log("open loop, YCSB:")
    open_rows, l_open = open_loop_path(dev)
    log("cross-device identity, open loop:")
    cross_device_open(dev)

    log("sharded engine, one-rank NCCL group:")
    import torch.distributed as dist
    from repro_torch.launch import txn_scaling
    from repro_torch.launch.mesh import close_shards, init_shards
    shards = init_shards(dev)
    try:
        dist_rows, l_dist, n_dist = sharded_path(dev)
        log("sharded engine, card = CPU (gloo group for the CPU run):")
        sharded_cross_device(dev, cpu_group=dist.new_group(backend="gloo"))
        log("sharded scaling rows (repro_torch.launch.txn_scaling):")
        K.reset_launches()
        scaling = txn_scaling.scaling_rows(shards, waves=30)
        l_scale = K.launch_counts()
        for r in scaling:
            log("  " + json.dumps(r))
    finally:
        close_shards(shards)

    log("LM serving:")
    torch.cuda.empty_cache()
    lm_checks, lm_timings = lm_kernel_phase(dev)
    lm_rows, lm_launches = [], {op: 0 for op in K.WRAPPERS}
    for arch in LM_ARCHS:
        row, launched = lm_serve_path(dev, arch)
        lm_rows.append(row)
        for op, n in launched.items():
            lm_launches[op] += n
    log("lm_serving " + json.dumps(lm_rows))

    runs = {"tpcc": (l_tpcc, len(tpcc) * WAVES),
            "ycsb": (l_ycsb, len(ycsb) * WAVES),
            "tpcc_unfused": (l_unf, len(UNFUSED) * WAVES),
            "tpcc_scans": (l_tpcc_s, len(tpcc_s) * WAVES),
            "ycsb_scans": (l_ycsb_s, len(ycsb_s) * WAVES),
            "mv": (l_mv, len(mv) * WAVES),
            "backend_probe": (l_probe, 1),
            "quickstart": (l_quick, 3 * WAVES),
            "fig3": (l_fig, len(fig_rows) * WAVES),
            "open_loop": (l_open, len(open_rows) * WAVES),
            "sharded": (l_dist, n_dist * WAVES),
            "scaling": (l_scale, (30 + txn_scaling.WARMUP_WAVES)
                        * len(scaling))}
    per_wave = {op: {k: n[op] / w for k, (n, w) in runs.items()}
                for op in KERNEL_META}
    log("launches per wave (mean over each phase's configurations): "
        + json.dumps(per_wave))
    log("kernel_times " + json.dumps(
        {label: {n: {k: (v if k != "bound" else list(v)) for k, v in r.items()}
                 for n, r in t.items()} for label, t in timings.items()}))
    kernels = []
    for name, (src, replaces) in KERNEL_META.items():
        t = timings["dist" if name in DIST_KERNELS else "tpcc"][name]
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces,
            "launches": sum(n[name] for n, _ in runs.values()),
            "max_abs_err": checks[name].max_err,
            "equal": checks[name].equal,
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound"][0], "bound_by": t["bound"][1],
            "library_ms": t["library_ms"],
            "shape": t.get("shape", "tpcc T=128 K=64 N=2450808 G=2"),
        })
    for name, (src, replaces) in LM_KERNEL_META.items():
        t = lm_timings[name]
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": lm_launches[name],
            "max_abs_err": lm_checks[name].max_err,
            "max_bf16_ulps": lm_checks[name].max_ulps,
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound"][0], "bound_by": t["bound"][1],
            "library_ms": t["library_ms"], "shape": t["shape"],
        })
    log(f"total: {time.perf_counter() - t_start:.1f} s")
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
