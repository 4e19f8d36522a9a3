"""Paper Figure 3 from the port: TPC-C, 8 warehouses fixed (contention
grows with thread count), coarse (3a) vs fine (3b) timestamps.  The twin
of ``benchmarks/fig3_tpcc.py``.

    PYTHONPATH=src python -m repro_torch.benchmarks.fig3_tpcc \
        [--waves 300] [--device cuda|cpu]

Validated claims (paper section 4.3):
  3a: TicToc gains over OCC as contention increases (through T=96);
      TicToc degrades at 128 threads, losing to 2PL.
  3b: OCC fastest at almost all core counts; fine granularity lifts all.
  ratios: OCC+fine >= 1.37x TicToc+coarse @ 96;
          OCC+fine >= 1.14x TicToc+fine  @ 128.

The grid is the twin's (every mechanism of ``common.CCS`` x coarse and
fine x ``common.LANES``, TPC-C scale 1.0), warm, with rows in
``reports/fig3_tpcc.json``, the cost-model columns included.  ``main``'s
keywords override the grid (a CPU test runs it at ``scale=0.01``).
"""
from __future__ import annotations

import argparse

from repro_torch.benchmarks.common import one, save_rows, sweep


def report(rows) -> dict:
    """Print the figure's ordering and ratio lines beside the paper's
    numbers; returns the ratios by name."""
    def th(cc, g, T):
        return one(rows, cc=cc, granularity=g, lanes=T)["throughput"]
    r = {
        "tictoc/occ coarse@64": th("tictoc", 0, 64) / th("occ", 0, 64),
        "2pl/tictoc coarse@128": th("2pl", 0, 128) / th("tictoc", 0, 128),
        "occ-fine@96/tictoc-coarse@96": th("occ", 1, 96) / th("tictoc", 0,
                                                               96),
        "occ-fine@128/tictoc-fine@128": th("occ", 1, 128) / th("tictoc", 1,
                                                                128),
    }
    print(f"3a: TicToc/OCC coarse @64: {r['tictoc/occ coarse@64']:.2f}x "
          "(paper: >1)")
    print(f"3a: 2PL/TicToc coarse @128: {r['2pl/tictoc coarse@128']:.2f}x "
          "(paper: >1)")
    print(f"ratio: OCC-fine@96 / TicToc-coarse@96 = "
          f"{r['occ-fine@96/tictoc-coarse@96']:.2f}x (paper: 1.37x)")
    print(f"ratio: OCC-fine@128 / TicToc-fine@128 = "
          f"{r['occ-fine@128/tictoc-fine@128']:.2f}x (paper: 1.14x)")
    # Beyond the paper: serializable MV-OCC validates reads and inherits
    # TPC-C's New-order/Payment false-conflict structure, so its
    # fine/coarse gap mirrors OCC's.
    if any(x["cc"] == "mvocc" for x in rows):
        r["mvocc fine/coarse@128"] = th("mvocc", 1, 128) / th("mvocc", 0,
                                                              128)
        print(f"mv: mvocc fine/coarse @128 = "
              f"{r['mvocc fine/coarse@128']:.2f}x "
              "(granularity still matters without read-only aborts)")
    return r


def main(argv=None, **grid):
    ap = argparse.ArgumentParser()
    ap.add_argument("--waves", type=int, default=300)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--json", default="reports/fig3_tpcc.json")
    args = ap.parse_args(argv)

    kw = {"scale": 1.0, **grid}
    print(f"# Fig 3a (coarse) + 3b (fine), 8 warehouses, "
          f"scale={kw['scale']} [repro_torch on {args.device}]")
    rows = sweep("tpcc", waves=args.waves, device=args.device, warm=True,
                 **kw)
    save_rows(rows, args.json)
    report(rows)
    return rows


if __name__ == "__main__":
    main()
