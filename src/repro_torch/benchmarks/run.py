"""Benchmark aggregator of the port: one entry per paper table or figure
(the twin of the JAX package's ``benchmarks/run.py``).

    PYTHONPATH=src python -m repro_torch.benchmarks.run [--full] \
        [--waves N] [--device cuda|cpu]

Runs Fig 2, Fig 3, the abort rates, auto-granularity and the open loop on
``--device`` (CUDA by default; ``cpu`` runs the plain versions of the
kernels) and prints a ``name,wall_s,headline`` CSV at the end.
``--full`` uses the figures' paper-scale tables; the default is reduced
but structurally identical (orderings, not absolute numbers, are the
claims).
"""
from __future__ import annotations

import argparse
import sys
import time


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--waves", type=int, default=None)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)

    from repro_torch.benchmarks import (abort_rates, auto_granularity,
                                        fig2_ycsb, fig3_tpcc, open_loop)
    from repro_torch.benchmarks.common import one

    results = []

    def timed(name, fn, argv):
        t0 = time.perf_counter()
        rows = fn(argv)
        results.append((name, time.perf_counter() - t0, rows))
        return rows

    waves = args.waves or (300 if args.full else 150)
    common = ["--waves", str(waves), "--device", args.device]
    full = ["--full"] if args.full else []

    print("== Fig 2: YCSB coarse/fine ==", flush=True)
    timed("fig2_ycsb", fig2_ycsb.main, common + full)
    print("\n== Fig 3: TPC-C coarse/fine ==", flush=True)
    r3 = timed("fig3_tpcc", fig3_tpcc.main, common)
    print("\n== Abort rates (section 4.3) ==", flush=True)
    timed("abort_rates", abort_rates.main, common + full)
    print("\n== Auto-granularity (beyond paper) ==", flush=True)
    timed("auto_granularity", auto_granularity.main, common)
    print("\n== Open-loop load-latency (beyond paper) ==", flush=True)
    ro = timed("open_loop", open_loop.main, common)

    print("\n== CSV summary ==")
    print("name,wall_s,headline")
    occ128f = one(r3, cc="occ", granularity=1, lanes=128)["throughput"]
    tic128f = one(r3, cc="tictoc", granularity=1, lanes=128)["throughput"]
    peak = max(r["goodput"] for r in ro)
    heads = {
        "fig2_ycsb": "see orderings above",
        "fig3_tpcc": f"OCCfine/TicTocfine@128={occ128f / tic128f:.2f}x",
        "abort_rates": "see table above",
        "auto_granularity": "see recovery above",
        "open_loop": f"peak goodput={peak:.2f} txn/us",
    }
    for name, wall, _rows in results:
        print(f"{name},{wall:.1f},{heads[name]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
