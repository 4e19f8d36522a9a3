"""Beyond the paper: open-loop traffic — goodput and time-to-commit
latency vs offered load, from the port.  The twin of
``benchmarks/open_loop.py``.

    PYTHONPATH=src python -m repro_torch.benchmarks.open_loop \
        [--waves 200] [--lanes 64] [--n-keys 1000000] [--device cuda|cpu] \
        [--trace [PATH]]

The paper's experiments are closed-loop (every thread always has a
transaction; aborts retry in place).  This drives the same engine
open-loop: Poisson arrivals queue for admission (core/admission.py) and
aborts re-enqueue with a bounded incarnation counter, so the figure reads
as a load-latency curve — goodput (unique committed txns per simulated
us) saturates at the closed-loop capacity while p50/p99 time-to-commit
(waves from first admission to commit) grows past the knee.  Fine
timestamps move the knee right for both occ and mvcc.  Rows go to
``reports/open_loop.json``.  ``--trace`` (or ``REPRO_TRACE``) writes ONE
combined Chrome trace across the offered loads (analysis/trace.py): each
(rate, cc, granularity) point is a process row labelled cc/gran/rate on
the simulated-time axis.
"""
from __future__ import annotations

import argparse

import os

from repro_torch.benchmarks.common import one, save_rows, sweep


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--waves", type=int, default=200)
    ap.add_argument("--lanes", type=int, default=64)
    ap.add_argument("--rates", type=float, nargs="+", default=None,
                    help="offered loads (expected arrivals/wave); default "
                         "0.25/0.5/0.75/1.0x the lane width")
    ap.add_argument("--n-keys", type=int, default=1_000_000)
    ap.add_argument("--max-incarnations", type=int, default=8)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--json", default="reports/open_loop.json")
    ap.add_argument("--trace", nargs="?", const="reports/open_loop_trace"
                    ".json", default=None, metavar="PATH",
                    help="export ONE combined Chrome-trace timeline across "
                         "all offered loads (analysis/trace.py; rows are "
                         "labelled cc/gran/rate); REPRO_TRACE=1 also "
                         "enables it")
    args = ap.parse_args(argv)
    from repro_torch.launch.txn_bench import trace_path
    trace = trace_path(args.trace, "reports/open_loop_trace.json")

    T = args.lanes
    rates = args.rates or [0.25 * T, 0.5 * T, 0.75 * T, 1.0 * T]
    rows = []
    traced = []
    for rate in rates:
        got = sweep("ycsb", ccs=["occ", "mvcc"], lanes=[T],
                    waves=args.waves, n_keys=args.n_keys,
                    device=args.device, quiet=True, warm=True,
                    arrival_rate=rate, queue_cap=4 * T,
                    max_incarnations=args.max_incarnations,
                    per_wave=bool(trace), return_points=bool(trace))
        if trace:
            got, points = got
            traced += [(rate, p) for p in points]
        for r in got:
            r["arrival_rate"] = rate
        rows += got
        for r in got:
            print(f"  rate={rate:6.1f} {r['cc']:5s} "
                  f"{'fine' if r['granularity'] else 'coarse'}: "
                  f"goodput={r['goodput']:7.3f} txn/us  "
                  f"p50={max(r['p50_ttc_waves']):3g} "
                  f"p99={max(r['p99_ttc_waves']):3g} waves  "
                  f"dropped={r['inc_drops']}")
    save_rows(rows, args.json)
    if trace:
        from repro_torch.analysis.trace import (point_events, point_meta,
                                                write_trace)
        from repro_torch.core import types as t
        events = []
        for pid, (rate, p) in enumerate(traced, start=1):
            label = (f"{t.CC_NAMES[p.cc]}/"
                     f"{'fine' if p.granularity else 'coarse'}/"
                     f"rate{rate:g}")
            events += point_events(label, pid, p.per_wave_commits,
                                   p.per_wave_aborts, p.per_wave_us,
                                   p.per_wave_causes, point_meta(p))
        os.makedirs(os.path.dirname(trace) or ".", exist_ok=True)
        write_trace(trace, {
            "traceEvents": events, "displayTimeUnit": "ms",
            "otherData": {"source": "repro open-loop wave trace",
                          "time_axis": "simulated microseconds"}})
        print(f"[saved] {trace} ({len(traced)} trace rows)")

    # The headline ordering: at the highest offered load, fine
    # granularity sustains more goodput than coarse for both mechanisms.
    hi = rates[-1]
    picked = [r for r in rows if r["arrival_rate"] == hi]
    for cc in ("occ", "mvcc"):
        g0 = one(picked, cc=cc, granularity=0)["goodput"]
        g1 = one(picked, cc=cc, granularity=1)["goodput"]
        print(f"at rate={hi:g}: {cc} fine/coarse goodput = {g1/g0:.2f}x "
              "(expected > 1 under contention)")
    return rows


if __name__ == "__main__":
    main()
