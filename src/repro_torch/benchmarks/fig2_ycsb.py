"""Paper Figure 2 from the port: YCSB-like workload, high contention
(Zipf theta=0.9, 50% writes), coarse (2a) vs fine (2b) timestamps,
throughput vs threads.  The twin of ``benchmarks/fig2_ycsb.py``.

    PYTHONPATH=src python -m repro_torch.benchmarks.fig2_ycsb \
        [--full] [--waves 300] [--device cuda|cpu]

Validated orderings (paper section 4.2):
  2a: TicToc starts above OCC at low threads, falls below OCC at high
      threads (rts-extension CAS contention); SwissTM/Adaptive/2PL
      uniformly below OCC.
  2b: all mechanisms improve; OCC and SwissTM gain the most.

The grid is the twin's (``common.CCS`` x coarse and fine x
``common.LANES``; 1M keys, 10M with ``--full``), warm, with rows in
``reports/fig2_ycsb.json``, the cost-model columns included.  ``main``'s
keywords override the grid (a CPU test runs it at ``n_keys=2000``).
"""
from __future__ import annotations

import argparse

from repro_torch.benchmarks.common import LANES, one, save_rows, sweep


def report(rows, lanes=LANES) -> dict:
    """Print the figure's ordering lines beside the paper's claims;
    returns the ratios by name."""
    hiT, loT = max(lanes), min(lanes)

    def th(cc, g, T):
        return one(rows, cc=cc, granularity=g, lanes=T)["throughput"]
    r = {f"tictoc/occ coarse@{loT}": th("tictoc", 0, loT) / th("occ", 0,
                                                               loT),
         f"tictoc/occ coarse@{hiT}": th("tictoc", 0, hiT) / th("occ", 0,
                                                               hiT)}
    print(f"2a: TicToc/OCC at T={loT}: {r[f'tictoc/occ coarse@{loT}']:.2f}x"
          f"  at T={hiT}: {r[f'tictoc/occ coarse@{hiT}']:.2f}x "
          f"(paper: >1 at low T, <1 at high T)")
    for cc in ("2pl", "swisstm", "adaptive"):
        r[f"{cc}/occ coarse@{hiT}"] = th(cc, 0, hiT) / th("occ", 0, hiT)
        print(f"2a: {cc}/OCC at T={hiT}: {r[f'{cc}/occ coarse@{hiT}']:.2f}x"
              " (paper: <1)")
    for cc in ("occ", "swisstm", "tictoc", "2pl", "adaptive", "mvcc",
               "mvocc"):
        r[f"{cc} fine/coarse@{hiT}"] = th(cc, 1, hiT) / th(cc, 0, hiT)
        print(f"2b: {cc} fine/coarse at T={hiT}: "
              f"{r[f'{cc} fine/coarse@{hiT}']:.2f}x (paper: >1)")
    # Beyond the paper: YCSB's random columns put write-write pairs in
    # different groups, so the MV mechanisms' per-group
    # first-committer-wins keeps the fine advantage.
    print(f"mv: mvcc fine/coarse at T={hiT}: "
          f"{r[f'mvcc fine/coarse@{hiT}']:.2f}x "
          "(write-write resolution stays per-group)")
    return r


def main(argv=None, **grid):
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true",
                    help="paper-scale: 10M keys (slower)")
    ap.add_argument("--waves", type=int, default=300)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--json", default="reports/fig2_ycsb.json")
    args = ap.parse_args(argv)

    kw = {"n_keys": 10_000_000 if args.full else 1_000_000, **grid}
    print(f"# Fig 2a (coarse) + 2b (fine), {kw['n_keys']} keys "
          f"[repro_torch on {args.device}]")
    rows = sweep("ycsb", waves=args.waves, device=args.device, warm=True,
                 **kw)
    save_rows(rows, args.json)
    report(rows, kw.get("lanes", LANES))
    return rows


if __name__ == "__main__":
    main()
