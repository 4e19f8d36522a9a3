"""Quickstart on the PyTorch + CUDA port: the paper's central result.

    PYTHONPATH=src python examples/quickstart_torch.py [--device cuda|cpu]

Runs TPC-C (8 warehouses, scale 0.5, 96 simulated threads, 200 waves)
under OCC with coarse (one timestamp per row) vs fine (the paper's
two-timestamp split) version timestamps, and under TicToc with coarse
timestamps — showing that plain OCC with fine-grained timestamps beats
the fancier mechanism.  The same experiment as examples/quickstart.py,
on ``repro_torch`` (CUDA by default; ``--device cpu`` runs the plain
versions of the kernels).
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

from repro_torch.core import types as t  # noqa: E402
from repro_torch.core.engine import run  # noqa: E402
from repro_torch.workloads import TPCCWorkload  # noqa: E402


def main(argv=None, *, scale=0.5, lanes=96, waves=200):
    """Print the three runs and the headline ratios; returns {name:
    SimResult}.  The keywords are the experiment's size (a CPU test runs
    it small)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    wl = TPCCWorkload.make(n_warehouses=8, scale=scale)
    T = lanes

    def go(cc, gran):
        cfg = t.EngineConfig(
            cc=cc, lanes=T, slots=wl.slots, n_records=wl.n_records,
            n_groups=wl.n_groups, n_cols=wl.n_cols,
            n_txn_types=wl.n_txn_types, granularity=gran,
            n_rings=wl.n_rings)
        return run(cfg, wl, n_waves=waves, seed=0, device=args.device)

    print(f"TPC-C, 8 warehouses, {T} simulated threads, {waves} waves "
          f"[repro_torch on {args.device}]\n")
    res = {"occ-coarse": go(t.CC_OCC, 0), "occ-fine": go(t.CC_OCC, 1),
           "tictoc-coarse": go(t.CC_TICTOC, 0)}
    names = {"occ-coarse": "OCC, coarse timestamps",
             "occ-fine": "OCC, fine timestamps  ",
             "tictoc-coarse": "TicToc, coarse        "}
    for key, r in res.items():
        print(f"  {names[key]}: {r.throughput:7.2f} txn/us   "
              f"abort rate {100*r.abort_rate:5.2f}%   "
              f"{waves / r.wall_s:7.1f} waves/s")
    occ_c, occ_f, tic_c = res.values()
    print(f"\nfine-grained timestamps cut OCC's abort rate "
          f"{occ_c.abort_rate/max(occ_f.abort_rate,1e-9):.0f}x and "
          f"outperform TicToc by {occ_f.throughput/tic_c.throughput:.2f}x "
          f"(the paper's headline: 1.37x at 96 threads).")
    return res


if __name__ == "__main__":
    main()
