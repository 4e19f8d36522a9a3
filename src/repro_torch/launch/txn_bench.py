"""Transaction-engine benchmark CLI on the port (the paper's experiments).

    PYTHONPATH=src python -m repro_torch.launch.txn_bench --workload tpcc \
        --cc occ tictoc 2pl swisstm adaptive mvcc mvocc --granularity both \
        --lanes 16 64 128 --waves 300

The grid is a loop of ``core/engine.run`` calls, one per (cc,
granularity, lanes) point, on ``--device`` (CUDA by default; ``cpu`` runs
the plain versions of the kernels).  ``--scan-len`` switches on TPC-C's
scan classes (Order-status's order-line interval and a Stock-level scan);
``--scan-frac``/``--scan-len`` add YCSB's scan class.  The multi-version
mechanisms get a version ring of ``--mv-depth`` slots (only they allocate
one); ``--snapshot-age`` ages their snapshots and needs an all-MV grid.
Rows carry the JAX CLI's keys (``repro/launch/txn_bench.py``) plus
``abort_causes``; ``backend`` names the device, ``device_name`` the card,
``kernel_ops`` which ported ops ran as CUDA kernels, as plain versions or
not at all (from the wrappers' counters), and ``wall_s`` /
``waves_per_s`` the wave loop's synchronized host time.  The JAX rows'
cost-model columns wait for ROADMAP A.10.
"""
from __future__ import annotations

import argparse
import json

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
                snapshot_age: int = 0):
    """The run's EngineConfig.  Only the multi-version mechanisms get a
    version ring (``mv_depth`` slots)."""
    from repro_torch.core import types as t
    cc = t.CC_IDS[cc_name]
    return t.EngineConfig(
        cc=cc, lanes=lanes, slots=wl.slots,
        n_records=wl.n_records, n_groups=wl.n_groups, n_cols=wl.n_cols,
        n_txn_types=wl.n_txn_types, granularity=gran, n_rings=wl.n_rings,
        max_extent=wl.max_extent, fuse_wave=fuse_wave,
        mv_depth=mv_depth if cc in t.MV_CCS else 0,
        snapshot_age=snapshot_age)


def row(workload: str, cc_name: str, gran: int, res, launches: dict,
        calls: dict, max_extent: int = 1) -> dict:
    """One JSON row for a finished run; ``launches`` and ``calls`` are the
    run's deltas of ``kernels.launch_counts()`` and
    ``kernels.call_counts()``."""
    from repro_torch.core import types as t
    from repro_torch.core.backend import kernel_coverage
    dev = torch.device(res.device)
    return {
        "workload": workload, "cc": cc_name, "granularity": gran,
        "lanes": res.lanes, "waves": res.waves,
        "commits": res.commits, "aborts": res.aborts,
        "abort_rate": round(res.abort_rate, 4),
        "ro_commits": res.ro_commits, "ro_aborts": res.ro_aborts,
        "ro_abort_rate": round(res.ro_abort_rate, 4),
        "throughput": round(res.throughput, 4),
        "ext_events": res.ext_events,
        "wall_s": res.wall_s,
        "waves_per_s": res.waves / res.wall_s if res.wall_s else None,
        "backend": str(dev),
        "device_name": (torch.cuda.get_device_name(dev)
                        if dev.type == "cuda" else "cpu"),
        "kernel_ops": kernel_coverage(t.CC_IDS[cc_name], launches, calls),
        "max_extent": max_extent,
        "abort_causes": {t.CAUSE_NAMES[i]: n
                         for i, n in enumerate(res.abort_causes)},
    }


def run_grid(workload: str, ccs: list, grans, lanes: list, waves: int, *,
             scale: float = 1.0, n_keys: int = 1_000_000, seed: int = 0,
             write_frac: float = 0.5, theta: float = 0.9,
             ro_frac: float = 0.0, scan_frac: float = 0.0,
             scan_len: int = 0, mv_depth: int = 4, snapshot_age: int = 0,
             device=None, fuse_wave: bool = True) -> list:
    """Run every (cc, granularity, lanes) point; returns row dicts.
    ``fuse_wave=False`` takes the probe family's unfused route;
    ``snapshot_age > 0`` needs an all-MV ``ccs``."""
    from repro_torch import kernels
    from repro_torch.core import types as t
    from repro_torch.core.engine import run
    if snapshot_age and not all(t.CC_IDS[c] in t.MV_CCS for c in ccs):
        raise ValueError("snapshot_age > 0 needs an all-MV cc grid "
                         "(mvcc/mvocc): single-version mechanisms have no "
                         "snapshots to age")
    wl = make_workload(workload, scale=scale, n_keys=n_keys,
                       write_frac=write_frac, theta=theta, ro_frac=ro_frac,
                       scan_frac=scan_frac, scan_len=scan_len)
    rows = []
    for g in grans:
        for cc in ccs:
            for T in lanes:
                cfg = make_config(wl, cc, g, T, fuse_wave,
                                  mv_depth=mv_depth,
                                  snapshot_age=snapshot_age)
                before = (kernels.launch_counts(), kernels.call_counts())
                res = run(cfg, wl, waves, seed=seed, device=device)
                after = (kernels.launch_counts(), kernels.call_counts())
                launches, calls = ({op: a[op] - b[op] for op in a}
                                   for a, b in zip(after, before))
                rows.append(row(workload, cc, g, res, launches, calls,
                                cfg.max_extent))
    return rows


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
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cpu runs the plain PyTorch versions of the "
                         "kernels")
    ap.add_argument("--json", default=None)
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
    grans = {"coarse": (0,), "fine": (1,), "both": (0, 1)}[args.granularity]
    rows = run_grid(
        args.workload, args.cc, grans, args.lanes, args.waves,
        scale=args.scale, n_keys=args.n_keys, seed=args.seed,
        write_frac=0.5 if args.write_frac is None else args.write_frac,
        theta=0.9 if args.theta is None else args.theta,
        ro_frac=args.ro_frac or 0.0, scan_frac=args.scan_frac or 0.0,
        scan_len=args.scan_len or 0, mv_depth=args.mv_depth,
        snapshot_age=args.snapshot_age, device=args.device)
    for r in rows:
        print(f"{r['workload']} {r['cc']:9s} "
              f"{'fine' if r['granularity'] else 'coarse'} "
              f"T={r['lanes']:4d}: thpt={r['throughput']:8.3f} txn/us  "
              f"abort={100 * r['abort_rate']:6.2f}%  "
              f"{r['waves_per_s']:8.1f} waves/s on {r['device_name']}")
    if args.json:
        with open(args.json, "w") as f:
            json.dump(rows, f, indent=1)


if __name__ == "__main__":
    main()
