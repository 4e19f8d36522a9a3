"""Smoke test of the PyTorch + CUDA port (src/repro_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's twelve CUDA kernels (eleven sources) from
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
     drawn by the scan-configured workload generator;
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
     heats within rtol 1e-6.

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
    "validate": ("src/repro_torch/csrc/occ_validate.cu",
                 "src/repro/kernels/occ_validate.py:86"),
    "iterate_validate": ("src/repro_torch/csrc/iterate_validate.cu",
                         "src/repro/kernels/iterate_validate.py:122"),
    "mv_gather": ("src/repro_torch/csrc/mv_gather.cu",
                  "src/repro/kernels/mv_gather.py:64"),
    "mv_install": ("src/repro_torch/csrc/mv_install.cu",
                   "src/repro/kernels/mv_install.py:60"),
}
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


def kernel_phase(dev, shapes, wave=9):
    """Compare every kernel with its plain version over every flag
    combination at ``shapes``; time them at the first shape.  Returns
    ({name: KernelCheck}, {name: timing dict})."""
    from repro_torch import kernels as K
    from repro_torch.core.claimword import claim_word
    from repro_torch.kernels.claim_probe import claim_probe_plain
    from repro_torch.kernels.claim_scatter import claim_scatter_plain
    from repro_torch.kernels.occ_commit import commit_install_plain
    from repro_torch.kernels.occ_validate import validate_dual_plain
    from repro_torch.kernels.segment_count import segment_count_plain
    from repro_torch.kernels.ts_gather import ts_gather_plain
    from repro_torch.kernels.ts_install import ts_install_max_plain
    from repro_torch.kernels.wave_commit import wave_commit_plain
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
        for name, r in t.items():
            log(f"  {label:5s} {name:15s} kernel {r['ms']:.6f} ms  plain "
                f"{r['plain_ms']:.4f} ms  library "
                f"{'-' if r['library_ms'] is None else '%.4f' % r['library_ms']}"
                f" ms  bound {r['bound'][0]:.6f} ms ({r['bound'][1]})")
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


def _replay(cfg, wl, draws, d):
    from repro_torch.core import engine as E
    from repro_torch.core import types as t
    st = t.engine_state_init(cfg, wl.init_store(d, cfg.mv_depth))
    step = E.make_wave_step(cfg)
    for fresh, tl, perm in draws:
        fb = t.TxnBatch(**{f.name: getattr(fresh, f.name).to(d)
                           for f in dataclasses.fields(t.TxnBatch)})
        st = step(st, fb, tl.to(d), perm.to(d))
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

    runs = {"tpcc": (l_tpcc, len(tpcc) * WAVES),
            "ycsb": (l_ycsb, len(ycsb) * WAVES),
            "tpcc_unfused": (l_unf, len(UNFUSED) * WAVES),
            "tpcc_scans": (l_tpcc_s, len(tpcc_s) * WAVES),
            "ycsb_scans": (l_ycsb_s, len(ycsb_s) * WAVES),
            "mv": (l_mv, len(mv) * WAVES)}
    per_wave = {op: {k: n[op] / w for k, (n, w) in runs.items()}
                for op in l_tpcc}
    log("launches per wave (mean over each phase's configurations): "
        + json.dumps(per_wave))
    log("kernel_times " + json.dumps(
        {label: {n: {k: (v if k != "bound" else list(v)) for k, v in r.items()}
                 for n, r in t.items()} for label, t in timings.items()}))
    kernels = []
    for name, (src, replaces) in KERNEL_META.items():
        t = timings["tpcc"][name]
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces,
            "launches": sum(n[name] for n, _ in runs.values()),
            "max_abs_err": checks[name].max_err,
            "equal": checks[name].equal,
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound"][0], "bound_by": t["bound"][1],
            "library_ms": t["library_ms"],
            "shape": "tpcc T=128 K=64 N=2450808 G=2",
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
