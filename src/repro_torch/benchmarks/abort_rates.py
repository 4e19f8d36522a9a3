"""Paper section 4.3 abort-rate numbers, plus the multi-version
extension, from the port.  The twin of ``benchmarks/abort_rates.py``.

    PYTHONPATH=src python -m repro_torch.benchmarks.abort_rates \
        [--full] [--waves 400] [--device cuda|cpu]

    TPC-C coarse @64:  TicToc 9.79%  vs OCC 17.57%
    TPC-C @128:        OCC coarse 30.91% -> fine 1.75% (largest drop)

Beyond the paper: a write-heavy, high-contention YCSB mix (Zipf 0.9, 80%
writes, 20% read-only transactions; 100k keys, 1M with ``--full``).
Multi-version snapshot reads never abort a read-only transaction, while
single-version coarse OCC aborts them on any conflicting concurrent
write.  Rows go to ``reports/abort_rates.json``, the cost-model columns
included.  ``main``'s keywords override both grids (a CPU test runs it
small).
"""
from __future__ import annotations

import argparse

from repro_torch.benchmarks.common import one, save_rows, sweep


def main(argv=None, **grid):
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--waves", type=int, default=400)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--json", default="reports/abort_rates.json")
    args = ap.parse_args(argv)

    rows = sweep("tpcc", waves=args.waves, device=args.device, quiet=True,
                 warm=True, **{"lanes": [64, 128], "scale": 1.0, **grid})
    save_rows(rows, args.json)

    print("lanes  cc        gran    abort%")
    for T in (64, 128):
        for cc in ("occ", "tictoc", "2pl", "swisstm", "adaptive",
                   "mvcc", "mvocc"):
            for g in (0, 1):
                r = one(rows, cc=cc, granularity=g, lanes=T)
                print(f"{T:5d}  {cc:9s} {'fine' if g else 'coarse':6s} "
                      f"{100*r['abort_rate']:7.2f}")
    o64c = one(rows, cc="occ", granularity=0, lanes=64)["abort_rate"]
    t64c = one(rows, cc="tictoc", granularity=0, lanes=64)["abort_rate"]
    o128c = one(rows, cc="occ", granularity=0, lanes=128)["abort_rate"]
    o128f = one(rows, cc="occ", granularity=1, lanes=128)["abort_rate"]
    print(f"\ncoarse @64: TicToc {100*t64c:.2f}% < OCC {100*o64c:.2f}% "
          f"(paper: 9.79% vs 17.57%)")
    print(f"OCC @128: coarse {100*o128c:.2f}% -> fine {100*o128f:.2f}% "
          f"(paper: 30.91% -> 1.75%)")

    # ---- multi-version row set: read-only abort rates under write-heavy,
    # high-contention YCSB (Zipf 0.9, 80% writes, 20% read-only) ----
    mv_rows = sweep("ycsb", ccs=["occ", "mvcc", "mvocc"], waves=args.waves,
                    device=args.device, write_frac=0.8, ro_frac=0.2,
                    theta=0.9, quiet=True, warm=True,
                    **{"lanes": [64, 128],
                       "n_keys": 1_000_000 if args.full else 100_000,
                       **grid})
    for r in mv_rows:
        r["variant"] = "ycsb_writeheavy_ro"
    save_rows(rows + mv_rows, args.json)

    print("\nread-only clients, YCSB write-heavy (80% writes, Zipf 0.9):")
    print("lanes  cc        gran    abort%  ro_abort%")
    for T in (64, 128):
        for cc in ("occ", "mvcc", "mvocc"):
            for g in (0, 1):
                r = one(mv_rows, cc=cc, granularity=g, lanes=T)
                print(f"{T:5d}  {cc:9s} {'fine' if g else 'coarse':6s} "
                      f"{100*r['abort_rate']:7.2f} "
                      f"{100*r['ro_abort_rate']:9.2f}")
    occ_ro = one(mv_rows, cc="occ", granularity=0, lanes=128)["ro_abort_rate"]
    mv_ro = one(mv_rows, cc="mvcc", granularity=0, lanes=128)["ro_abort_rate"]
    print(f"\nread-only abort @128 coarse: OCC {100*occ_ro:.2f}% vs "
          f"MVCC {100*mv_ro:.2f}% (snapshot readers never abort)")
    return rows + mv_rows


if __name__ == "__main__":
    main()
