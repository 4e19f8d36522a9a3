"""Transaction-engine benchmark CLI on the port (the paper's experiments).

    PYTHONPATH=src python -m repro_torch.launch.txn_bench --workload tpcc \
        --cc occ tictoc 2pl swisstm adaptive mvcc mvocc --granularity both \
        --lanes 16 64 128 --waves 300

The grid runs through ``core/engine.sweep``, point by point, on
``--device`` (CUDA by default; ``cpu`` runs the plain versions of the
kernels): lane counts are grouped into buckets, and a point below its
bucket's widest lane count runs at that width with its padding lanes
masked, as in the JAX package.  ``--scan-len`` switches on TPC-C's
scan classes (Order-status's order-line interval and a Stock-level scan);
``--scan-frac``/``--scan-len`` add YCSB's scan class.  The multi-version
mechanisms get a version ring of ``--mv-depth`` slots (only they allocate
one); ``--snapshot-age`` ages their snapshots and needs an all-MV grid.
``--arrival-rate`` switches every point to the open-loop front-end
(Poisson arrivals into an admission queue of ``--queue-cap`` entries,
default 4x the widest lane count; aborts retry up to
``--max-incarnations`` times, default 8).
Rows carry the JAX CLI's keys (``repro/launch/txn_bench.py``) plus
``abort_causes``; ``backend`` names the device, ``device_name`` the card,
``kernel_ops`` which ported ops ran as CUDA kernels, as plain versions or
not at all (from the wrappers' counters around the point), and ``wall_s``
/ ``waves_per_s`` the point's wave loop's synchronized host time at
``lanes_run`` lanes (its bucket's width).  Open-loop rows add goodput,
the admission counters (``reenq_drops`` too) and the per-class
time-to-commit percentiles.  Every row carries the cost-model columns
(``_cost_fields``, analysis/txn_cost.py on the port's tables, on the
roofline of ``gpu_h100``).  ``--trace PATH`` (or ``REPRO_TRACE=1`` /
``=PATH``) writes the grid's per-wave timeline as a Chrome trace
(analysis/trace.py): one process row per point, one slice per wave on the
simulated-time axis, the point's measured ``wall_s`` and device in the
row's metadata.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os

import torch


def make_workload(workload: str, *, scale: float = 1.0,
                  n_keys: int = 1_000_000, write_frac: float = 0.5,
                  theta: float = 0.9, ro_frac: float = 0.0,
                  scan_frac: float = 0.0, scan_len: int = 0):
    """The benchmark's workload; ``scan_len`` 0 means no scans (YCSB's
    scan class then defaults to 8 keys, as in the JAX CLI)."""
    from repro_torch.workloads import TPCCWorkload, YCSBWorkload
    if workload == "tpcc":
        return TPCCWorkload.make(n_warehouses=8, scale=scale,
                                 scan_len=scan_len)
    return YCSBWorkload.make(n_keys=n_keys, write_frac=write_frac,
                             theta=theta, ro_frac=ro_frac,
                             scan_frac=scan_frac, scan_len=scan_len or 8)


#: ``--cc`` choices: the mechanisms the port runs.
CCS = ("occ", "tictoc", "2pl", "swisstm", "adaptive", "autogran", "mvcc",
       "mvocc")


def make_config(wl, cc_name: str, gran: int, lanes: int,
                fuse_wave: bool = True, *, mv_depth: int = 4,
                snapshot_age: int = 0, arrival_rate: float = 0.0,
                queue_cap: int | None = None,
                max_incarnations: int | None = None):
    """The run's EngineConfig.  Only the multi-version mechanisms get a
    version ring (``mv_depth`` slots); ``arrival_rate > 0`` makes it an
    open-loop run, whose queue holds 4x ``lanes`` entries and whose
    transactions get 8 incarnations unless ``queue_cap`` /
    ``max_incarnations`` say otherwise (0 incarnations drops every
    abort)."""
    from repro_torch.core import types as t
    cc = t.CC_IDS[cc_name]
    if queue_cap is None:
        queue_cap = 4 * lanes if arrival_rate > 0 else 0
    if max_incarnations is None:
        max_incarnations = 8 if arrival_rate > 0 else 0
    return t.EngineConfig(
        cc=cc, lanes=lanes, slots=wl.slots,
        n_records=wl.n_records, n_groups=wl.n_groups, n_cols=wl.n_cols,
        n_txn_types=wl.n_txn_types, granularity=gran, n_rings=wl.n_rings,
        max_extent=wl.max_extent, fuse_wave=fuse_wave,
        mv_depth=mv_depth if cc in t.MV_CCS else 0,
        snapshot_age=snapshot_age, arrival_rate=arrival_rate,
        queue_cap=queue_cap, max_incarnations=max_incarnations)


def _cost_fields(cc_name: str, lanes: int, granularity: int, slots: int,
                 n_groups: int, mv_depth: int, max_extent: int = 1,
                 bucket_size: int = 8) -> dict:
    """The cost-model columns (analysis/txn_cost.py): analytic bytes and
    flops per transaction attempt, the mechanism's fraction of the
    H100's roofline, the port's kernel launches per wave and, for the
    probe family, the fused and unfused probe chains' touched-row visits
    per wave.  Closed-form in the wave shape, so the same on every
    device."""
    from repro_torch.analysis import txn_cost as tc
    shape = tc.WaveShape(lanes=lanes, slots=slots, n_groups=n_groups,
                         granularity=granularity, mv_depth=mv_depth,
                         max_extent=max_extent, bucket_size=bucket_size)
    cost = tc.txn_cost(cc_name, shape)
    fields = {
        "bytes_per_txn": round(cost["bytes_per_txn"], 1),
        "flops_per_txn": round(cost["flops_per_txn"], 1),
        "roofline_frac": round(cost["roofline_frac"], 6),
        "roofline_bound": cost["bound"],
        "roofline_chip": cost["chip"],
        "launches_per_wave": cost["launches_per_wave"],
    }
    if cc_name in tc.PROBE_CHAIN_LAUNCHES:
        chain = tc.probe_chain(cc_name, shape, fused=True)
        unfused = tc.probe_chain(cc_name, shape, fused=False)
        fields.update({
            "dma_rows_per_wave": chain["dma_rows_per_wave"],
            "dma_rows_per_wave_unfused": unfused["dma_rows_per_wave"],
        })
    return fields


def row(workload: str, p, *, slots: int, n_groups: int, mv_depth: int,
        max_extent: int, bucket_size: int) -> dict:
    """One JSON row for a finished sweep point ``p``, with the cost-model
    columns at the run's wave shape."""
    from repro_torch.core import types as t
    from repro_torch.core.backend import kernel_coverage
    dev = torch.device(p.device)
    cc_name = t.CC_NAMES[p.cc]
    r = {
        "workload": workload, "cc": cc_name, "granularity": p.granularity,
        "lanes": p.lanes, "waves": p.waves,
        "commits": p.commits, "aborts": p.aborts,
        "abort_rate": round(p.abort_rate, 4),
        "ro_commits": p.ro_commits, "ro_aborts": p.ro_aborts,
        "ro_abort_rate": round(p.ro_abort_rate, 4),
        "throughput": round(p.throughput, 4),
        "ext_events": p.ext_events,
        "wall_s": p.wall_s,
        "waves_per_s": p.waves / p.wall_s if p.wall_s else None,
        "lanes_run": p.lanes_run,
        "backend": str(dev),
        "device_name": (torch.cuda.get_device_name(dev)
                        if dev.type == "cuda" else "cpu"),
        "kernel_ops": kernel_coverage(p.cc, p.kernel_launches,
                                      p.kernel_calls),
        "max_extent": max_extent,
        "abort_causes": {t.CAUSE_NAMES[i]: n
                         for i, n in enumerate(p.abort_causes)},
    }
    r.update(_cost_fields(cc_name, p.lanes, p.granularity, slots, n_groups,
                          mv_depth if p.cc in t.MV_CCS else 0, max_extent,
                          bucket_size))
    if p.open_loop:
        r.update({
            "open_loop": True, "goodput": round(p.goodput, 4),
            "offered": p.offered, "admitted": p.admitted,
            "arrival_drops": p.arrival_drops, "inc_drops": p.inc_drops,
            "reenq_drops": p.reenq_drops, "queued_final": p.queued_final,
            "p50_ttc_waves": p.p50_ttc, "p99_ttc_waves": p.p99_ttc,
        })
    return r


def run_grid(workload: str, ccs: list, grans, lanes: list, waves: int, *,
             scale: float = 1.0, n_keys: int = 1_000_000, seed: int = 0,
             write_frac: float = 0.5, theta: float = 0.9,
             ro_frac: float = 0.0, scan_frac: float = 0.0,
             scan_len: int = 0, mv_depth: int = 4, snapshot_age: int = 0,
             arrival_rate: float = 0.0, queue_cap: int | None = None,
             max_incarnations: int | None = None, device=None,
             fuse_wave: bool = True, per_wave: bool = False,
             return_points: bool = False):
    """Run the (cc, granularity, lanes) grid through ``engine.sweep``;
    returns row dicts in the JAX grid order.  ``fuse_wave=False`` takes
    the probe family's unfused route; ``snapshot_age > 0`` needs an
    all-MV ``ccs``; ``arrival_rate > 0`` runs every point open-loop, with
    ``make_config``'s queue and incarnation defaults at the widest lane
    count.  ``per_wave`` keeps each point's per-wave timeline, and
    ``return_points`` returns ``(rows, SweepPoints)``, the points
    carrying it (analysis/trace.py reads them)."""
    from repro_torch.core import types as t
    from repro_torch.core.engine import sweep
    if snapshot_age and not all(t.CC_IDS[c] in t.MV_CCS for c in ccs):
        raise ValueError("snapshot_age > 0 needs an all-MV cc grid "
                         "(mvcc/mvocc): single-version mechanisms have no "
                         "snapshots to age")
    wl = make_workload(workload, scale=scale, n_keys=n_keys,
                       write_frac=write_frac, theta=theta, ro_frac=ro_frac,
                       scan_frac=scan_frac, scan_len=scan_len)
    need_mv = any(t.CC_IDS[c] in t.MV_CCS for c in ccs)
    # The base config anchors on the first mechanism, so an aged-snapshot
    # grid (all-MV) validates; sweep sets each point's cc and ring.
    base = dataclasses.replace(
        make_config(wl, ccs[0], 0, max(lanes), fuse_wave,
                    mv_depth=mv_depth, snapshot_age=snapshot_age,
                    arrival_rate=arrival_rate, queue_cap=queue_cap,
                    max_incarnations=max_incarnations),
        mv_depth=mv_depth if need_mv else 0)
    points = sweep(base, wl, waves, ccs=[t.CC_IDS[c] for c in ccs],
                   grans=tuple(grans), lane_counts=tuple(lanes),
                   seeds=(seed,), per_wave=per_wave, device=device)
    rows = [row(workload, p, slots=wl.slots, n_groups=wl.n_groups,
                mv_depth=mv_depth, max_extent=base.max_extent,
                bucket_size=base.bucket_size) for p in points]
    return (rows, points) if return_points else rows


def trace_path(arg: str | None, default: str) -> str | None:
    """Where ``--trace`` writes: its path, else ``REPRO_TRACE`` (``1`` or
    ``true`` for ``default``, any other value but ``0`` a path), else
    nowhere (None)."""
    if arg is not None:
        return arg
    env = os.environ.get("REPRO_TRACE", "")
    if env and env != "0":
        return env if env not in ("1", "true") else default
    return None


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", choices=("tpcc", "ycsb"), default="tpcc")
    ap.add_argument("--cc", nargs="+", choices=CCS,
                    default=["occ", "tictoc", "2pl", "swisstm", "adaptive",
                             "mvcc", "mvocc"])
    ap.add_argument("--granularity", choices=("coarse", "fine", "both"),
                    default="both")
    ap.add_argument("--lanes", type=int, nargs="+", default=[16, 64, 128])
    ap.add_argument("--waves", type=int, default=300)
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--n-keys", type=int, default=1_000_000)
    ap.add_argument("--write-frac", type=float, default=None,
                    help="YCSB per-op write probability (default 0.5)")
    ap.add_argument("--theta", type=float, default=None,
                    help="YCSB Zipf skew (default 0.9)")
    ap.add_argument("--ro-frac", type=float, default=None,
                    help="YCSB fraction of read-only transactions "
                         "(default 0)")
    ap.add_argument("--scan-frac", type=float, default=None,
                    help="YCSB fraction of scan transactions (one interval "
                         "READ of --scan-len keys plus one point WRITE)")
    ap.add_argument("--scan-len", type=int, default=None,
                    help="interval width of a scan in records: the YCSB "
                         "scan class's (default 8; needs --scan-frac) or, "
                         "for TPC-C, switches on the Order-status and "
                         "Stock-level scans at this stock window")
    ap.add_argument("--mv-depth", type=int, default=4,
                    help="version-ring depth of mvcc/mvocc (ignored by "
                         "the other mechanisms)")
    ap.add_argument("--snapshot-age", type=int, default=0,
                    help="pin MV reader snapshots this many waves in the "
                         "past (needs an all-mvcc/mvocc --cc list)")
    ap.add_argument("--arrival-rate", type=float, default=None,
                    help="open-loop traffic: expected Poisson arrivals per "
                         "wave (capped at the lane width); switches every "
                         "grid point from the closed-loop retry buffer to "
                         "the admission queue")
    ap.add_argument("--queue-cap", type=int, default=None,
                    help="admission-queue ring capacity (open loop only; "
                         "default 4x the widest --lanes)")
    ap.add_argument("--max-incarnations", type=int, default=None,
                    help="re-executions allowed per transaction before it "
                         "is dropped and counted (open loop only; "
                         "default 8)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cpu runs the plain PyTorch versions of the "
                         "kernels")
    ap.add_argument("--json", default=None)
    ap.add_argument("--trace", nargs="?", const="reports/txn_trace.json",
                    default=None, metavar="PATH",
                    help="export the per-wave timeline as Chrome-trace JSON "
                         "(analysis/trace.py; open in chrome://tracing or "
                         "ui.perfetto.dev): one process row per grid point, "
                         "one slice per wave with its commit and abort-cause "
                         "deltas on the simulated-time axis; REPRO_TRACE=1 "
                         "(or =PATH) does the same without the flag")
    args = ap.parse_args(argv)
    ycsb_flags = (args.write_frac, args.theta, args.ro_frac)
    if args.workload == "tpcc" and any(v is not None for v in ycsb_flags):
        ap.error("--write-frac/--theta/--ro-frac shape the ycsb workload "
                 "only; TPC-C's mix is fixed by the standard")
    if args.scan_frac is not None:
        if args.workload == "tpcc":
            ap.error("--scan-frac shapes the ycsb scan class only; TPC-C's "
                     "mix is fixed by the standard (--scan-len switches on "
                     "its Order-status/Stock-level scans)")
        if not 0 < args.scan_frac <= 1:
            ap.error(f"--scan-frac must be in (0, 1], got {args.scan_frac}")
    if args.scan_len is not None:
        if args.scan_len < 1:
            ap.error(f"--scan-len must be >= 1, got {args.scan_len}")
        if args.workload == "ycsb" and args.scan_frac is None:
            ap.error("--scan-len sizes the ycsb scan class: set "
                     "--scan-frac > 0 to add scan transactions to the mix")
    if args.snapshot_age and not all(c in ("mvcc", "mvocc")
                                     for c in args.cc):
        ap.error("--snapshot-age only ages multi-version snapshots: use it "
                 "with an all-mvcc/mvocc --cc list")
    if args.arrival_rate is None:
        if args.queue_cap is not None or args.max_incarnations is not None:
            ap.error("--queue-cap/--max-incarnations shape the open-loop "
                     "admission queue only: set --arrival-rate > 0 (the "
                     "open-loop switch) to use them")
    elif args.arrival_rate <= 0:
        ap.error(f"--arrival-rate must be > 0 (got {args.arrival_rate}); "
                 "omit the flag for the closed-loop retry buffer")
    trace = trace_path(args.trace, "reports/txn_trace.json")
    grans = {"coarse": (0,), "fine": (1,), "both": (0, 1)}[args.granularity]
    rows, points = run_grid(
        args.workload, args.cc, grans, args.lanes, args.waves,
        scale=args.scale, n_keys=args.n_keys, seed=args.seed,
        write_frac=0.5 if args.write_frac is None else args.write_frac,
        theta=0.9 if args.theta is None else args.theta,
        ro_frac=args.ro_frac or 0.0, scan_frac=args.scan_frac or 0.0,
        scan_len=args.scan_len or 0, mv_depth=args.mv_depth,
        snapshot_age=args.snapshot_age,
        arrival_rate=args.arrival_rate or 0.0,
        queue_cap=args.queue_cap, max_incarnations=args.max_incarnations,
        device=args.device, per_wave=bool(trace), return_points=True)
    for r in rows:
        line = (f"{r['workload']} {r['cc']:9s} "
                f"{'fine' if r['granularity'] else 'coarse'} "
                f"T={r['lanes']:4d}: thpt={r['throughput']:8.3f} txn/us  "
                f"abort={100 * r['abort_rate']:6.2f}%")
        if r.get("open_loop"):
            line += (f"  goodput={r['goodput']:8.3f} txn/us  "
                     f"p50/p99 ttc={max(r['p50_ttc_waves']):g}/"
                     f"{max(r['p99_ttc_waves']):g} waves")
        print(line + f"  {r['waves_per_s']:8.1f} waves/s at "
              f"T={r['lanes_run']} on {r['device_name']}")
    if args.json:
        with open(args.json, "w") as f:
            json.dump(rows, f, indent=1)
    if trace:
        from repro_torch.analysis.trace import sweep_trace, write_trace
        os.makedirs(os.path.dirname(trace) or ".", exist_ok=True)
        write_trace(trace, sweep_trace(points))
        print(f"wrote Chrome trace -> {trace} ({len(points)} grid points; "
              "load in chrome://tracing or ui.perfetto.dev)")
    return rows


if __name__ == "__main__":
    main()
