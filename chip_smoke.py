"""Smoke test of the PyTorch + CUDA port (src/repro_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's eight CUDA kernels from src/repro_torch/csrc, then:

  1. kernels: each kernel against its plain PyTorch version on the card, at
     the main path's shapes (TPC-C: N = 2,450,808 records, T = 128 lanes,
     K = 64 slots; YCSB: N = 10M, K = 16; G = 2), over every flag
     combination, with hot, duplicated, masked (key -1) and stale-tag
     inputs, masks with and without live ops, and a wave whose claim tag
     has its top bit clear.  Outputs and updated tables must be
     bit-identical.  Each is timed with CUDA events (warm-up, then the
     median of 30 calls queued behind a device sleep so that host overhead
     stays out of the device time) beside its plain version and, where one
     PyTorch call computes the same function, that call;
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
  6. cross-device identity: one set of draws made on the CPU, run through
     the wave step on the card (kernels) and on the CPU (plain versions);
     integer state must be bit-identical, lane_time within rtol 1e-5 and
     the heats within rtol 1e-6.

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
}
#: The kernels each mechanism's (fused) wave launches.
_PROBE_OPS = ("wave_commit", "segment_count")
MECH_OPS = {"occ": _PROBE_OPS,
            "tictoc": _PROBE_OPS + ("ts_gather", "ts_install_max"),
            "2pl": _PROBE_OPS, "swisstm": _PROBE_OPS, "adaptive": _PROBE_OPS,
            "autogran": ("validate_dual", "claim_scatter", "commit_install",
                         "segment_count")}
PROBE_FAMILY = ("occ", "tictoc", "2pl", "swisstm", "adaptive")
#: One granularity per probe-family mechanism for the unfused phases.
UNFUSED = (("occ", 1), ("tictoc", 0), ("2pl", 0), ("swisstm", 1),
           ("adaptive", 0))
#: A wave whose claim tag 0xFFFF - wave has its top bit clear.
HIGH_WAVE = 40_000


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
    by = {}
    for r in rows:
        by[_name(r)] = r
        _log_row(workload, r)
        # The mechanism's kernels launched; its other ported ops (the
        # unfused bump on the fused route) never ran.
        want = {op: "cuda" if op in MECH_OPS[r["cc"]] else "not_run"
                for op in r["kernel_ops"]}
        if dev.type == "cuda" and r["kernel_ops"] != want:
            raise AssertionError(f"{_name(r)}: kernel_ops {r['kernel_ops']}"
                                 f" != {want}")
    log(f"  {workload} launches {launches}")
    path_ops = {op for ops in MECH_OPS.values() for op in ops}
    if dev.type == "cuda" and min(launches[op] for op in path_ops) <= 0:
        raise AssertionError(f"{workload}: a kernel never launched")
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
    st = t.engine_state_init(cfg, wl.init_store(d))
    step = E.make_wave_step(cfg)
    for fresh, tl, perm in draws:
        fb = t.TxnBatch(**{f.name: getattr(fresh, f.name).to(d)
                           for f in dataclasses.fields(t.TxnBatch)})
        st = step(st, fb, tl.to(d), perm.to(d))
    return st


INT_STATE = ("commits", "aborts", "commits_by_type", "ext_events",
             "abort_causes", "age", "pending_live")
INT_TABLES = ("wts", "rts", "claim_w", "claim_r", "ring_tails", "pess_mode",
              "fine_mode", "heat_wave")


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


def fused_unfused(dev, waves=30, scale=0.1, ccs=UNFUSED):
    """The same CPU-made draws through the fused route (wave_commit) and
    the unfused route (claim_probe + commit_install) on ``dev`` must give
    the same state, bit for bit."""
    from repro_torch.launch.txn_bench import make_config
    from repro_torch.workloads import TPCCWorkload
    wl = TPCCWorkload.make(n_warehouses=8, scale=scale)
    draws = _draws(wl, waves, LANES)
    for cc, gran in ccs:
        a, b = (_replay(make_config(wl, cc, gran, LANES, fuse), wl, draws,
                        dev) for fuse in (True, False))
        _same_state(a, b, f"fused/unfused {cc}")
        log(f"  {cc}-{'fine' if gran else 'coarse'}: {waves} waves, commits "
            f"{int(a.commits)} aborts {int(a.aborts)}: fused = unfused "
            f"on {dev}")


def cross_device(dev, waves=30, scale=0.1):
    """The same CPU-made draws through the wave step on ``dev`` (kernels)
    and on the CPU (plain versions) must give the same state."""
    from repro_torch.launch.txn_bench import make_config
    from repro_torch.workloads import TPCCWorkload
    wl = TPCCWorkload.make(n_warehouses=8, scale=scale)
    draws = _draws(wl, waves, LANES)
    cpu = torch.device("cpu")
    for cc, gran, fuse in (("occ", 1, True), ("tictoc", 0, True),
                           ("2pl", 0, True), ("swisstm", 1, True),
                           ("adaptive", 1, True), ("autogran", 0, True),
                           ("adaptive", 0, False)):
        cfg = make_config(wl, cc, gran, LANES, fuse)
        a, b = (_replay(cfg, wl, draws, d) for d in (dev, cpu))
        what = f"{cc}-{'fine' if gran else 'coarse'}" + ("" if fuse else
                                                         " unfused")
        _same_state(a, b, f"cross-device {what}", rtol_time=1e-5,
                    rtol_heat=1e-6)
        log(f"  {what}: {waves} waves, commits {int(a.commits)} aborts "
            f"{int(a.aborts)} ext {int(a.ext_events)} pess "
            f"{int(a.store.pess_mode.sum())} fine "
            f"{int(a.store.fine_mode.sum())}: identical on {dev} and cpu")


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

    log("fused = unfused on the card:")
    fused_unfused(dev)

    log("cross-device identity:")
    cross_device(dev)

    runs = {"tpcc": (l_tpcc, len(tpcc) * WAVES),
            "ycsb": (l_ycsb, len(ycsb) * WAVES),
            "tpcc_unfused": (l_unf, len(UNFUSED) * WAVES)}
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
