"""Transaction-engine benchmark CLI on the port (the paper's experiments).

    PYTHONPATH=src python -m repro_torch.launch.txn_bench --workload tpcc \
        --cc occ tictoc 2pl swisstm adaptive --granularity both \
        --lanes 16 64 128 --waves 300

The grid is a loop of ``core/engine.run`` calls, one per (cc,
granularity, lanes) point, on ``--device`` (CUDA by default; ``cpu`` runs
the plain versions of the kernels).  Rows carry the JAX CLI's keys
(``repro/launch/txn_bench.py``) plus ``abort_causes``; ``backend`` names
the device, ``device_name`` the card, ``kernel_ops`` which ported ops ran
as CUDA kernels, as plain versions or not at all (from the wrappers'
counters), and ``wall_s`` / ``waves_per_s`` the wave loop's synchronized
host time.  The JAX rows' cost-model columns wait for ROADMAP A.10.
"""
from __future__ import annotations

import argparse
import json

import torch


def make_workload(workload: str, *, scale: float = 1.0,
                  n_keys: int = 1_000_000, write_frac: float = 0.5,
                  theta: float = 0.9):
    from repro_torch.workloads import TPCCWorkload, YCSBWorkload
    if workload == "tpcc":
        return TPCCWorkload.make(n_warehouses=8, scale=scale)
    return YCSBWorkload.make(n_keys=n_keys, write_frac=write_frac,
                             theta=theta)


#: ``--cc`` choices: the mechanisms the port runs.
CCS = ("occ", "tictoc", "2pl", "swisstm", "adaptive", "autogran")


def make_config(wl, cc_name: str, gran: int, lanes: int,
                fuse_wave: bool = True):
    from repro_torch.core import types as t
    return t.EngineConfig(
        cc=t.CC_IDS[cc_name], lanes=lanes, slots=wl.slots,
        n_records=wl.n_records, n_groups=wl.n_groups, n_cols=wl.n_cols,
        n_txn_types=wl.n_txn_types, granularity=gran, n_rings=wl.n_rings,
        max_extent=wl.max_extent, fuse_wave=fuse_wave)


def row(workload: str, cc_name: str, gran: int, res, launches: dict,
        calls: dict) -> dict:
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
        "max_extent": 1,
        "abort_causes": {t.CAUSE_NAMES[i]: n
                         for i, n in enumerate(res.abort_causes)},
    }


def run_grid(workload: str, ccs: list, grans, lanes: list, waves: int, *,
             scale: float = 1.0, n_keys: int = 1_000_000, seed: int = 0,
             write_frac: float = 0.5, theta: float = 0.9,
             device=None, fuse_wave: bool = True) -> list:
    """Run every (cc, granularity, lanes) point; returns row dicts.
    ``fuse_wave=False`` takes the probe family's unfused route."""
    from repro_torch import kernels
    from repro_torch.core.engine import run
    wl = make_workload(workload, scale=scale, n_keys=n_keys,
                       write_frac=write_frac, theta=theta)
    rows = []
    for g in grans:
        for cc in ccs:
            for T in lanes:
                before = (kernels.launch_counts(), kernels.call_counts())
                res = run(make_config(wl, cc, g, T, fuse_wave), wl, waves,
                          seed=seed, device=device)
                after = (kernels.launch_counts(), kernels.call_counts())
                launches, calls = ({op: a[op] - b[op] for op in a}
                                   for a, b in zip(after, before))
                rows.append(row(workload, cc, g, res, launches, calls))
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", choices=("tpcc", "ycsb"), default="tpcc")
    ap.add_argument("--cc", nargs="+", choices=CCS,
                    default=["occ", "tictoc", "2pl", "swisstm", "adaptive"])
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
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cpu runs the plain PyTorch versions of the "
                         "kernels")
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)
    if args.workload == "tpcc" and (args.write_frac is not None
                                    or args.theta is not None):
        ap.error("--write-frac/--theta shape the ycsb workload only; "
                 "TPC-C's mix is fixed by the standard")
    grans = {"coarse": (0,), "fine": (1,), "both": (0, 1)}[args.granularity]
    rows = run_grid(
        args.workload, args.cc, grans, args.lanes, args.waves,
        scale=args.scale, n_keys=args.n_keys, seed=args.seed,
        write_frac=0.5 if args.write_frac is None else args.write_frac,
        theta=0.9 if args.theta is None else args.theta,
        device=args.device)
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
