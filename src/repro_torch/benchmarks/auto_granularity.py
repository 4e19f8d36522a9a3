"""Beyond the paper: auto-granularity OCC (the paper's section-5
sketch), from the port.  The twin of ``benchmarks/auto_granularity.py``.

    PYTHONPATH=src python -m repro_torch.benchmarks.auto_granularity \
        [--waves 400] [--lanes 64 128] [--device cuda|cpu]

Starts coarse everywhere; promotes records with false-conflict evidence
to fine-grained timestamps.  Success = recovers manual-fine OCC
throughput on TPC-C without annotations; each lane count prints the
recovered share of the fine gain.  Rows go to
``reports/auto_granularity.json``, the cost-model columns included.
``main``'s keywords override the grid (a CPU test runs it at
``scale=0.01``).
"""
from __future__ import annotations

import argparse

from repro_torch.benchmarks.common import one, save_rows, sweep


def main(argv=None, **grid):
    ap = argparse.ArgumentParser()
    ap.add_argument("--waves", type=int, default=400)
    ap.add_argument("--lanes", type=int, nargs="+", default=[64, 128])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--json", default="reports/auto_granularity.json")
    args = ap.parse_args(argv)

    kw = {"scale": 1.0, **grid}
    rows = []
    rows += sweep("tpcc", ccs=["occ"], lanes=args.lanes, grans=(0, 1),
                  waves=args.waves, device=args.device, **kw)
    rows += sweep("tpcc", ccs=["autogran"], lanes=args.lanes, grans=(0,),
                  waves=args.waves, device=args.device, **kw)
    save_rows(rows, args.json)

    for T in args.lanes:
        coarse = one(rows, cc="occ", granularity=0, lanes=T)["throughput"]
        fine = one(rows, cc="occ", granularity=1, lanes=T)["throughput"]
        auto = one(rows, cc="autogran", granularity=0,
                   lanes=T)["throughput"]
        rec = (auto - coarse) / max(fine - coarse, 1e-9)
        print(f"T={T:4d}: coarse {coarse:.3f}  auto {auto:.3f}  "
              f"fine {fine:.3f}  -> auto recovers {100*rec:.0f}% of the "
              f"fine-granularity gain")
    return rows


if __name__ == "__main__":
    main()
