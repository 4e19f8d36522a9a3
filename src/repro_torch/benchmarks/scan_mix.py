"""Interval read-sets from the port: fine vs coarse abort rates and
goodput as the scan mix grows (the phantom-protection cost of timestamp
granularity).  The twin of ``benchmarks/scan_mix.py``.

    PYTHONPATH=src python -m repro_torch.benchmarks.scan_mix \
        [--waves 200] [--n-keys 100000] [--closed-loop] [--device cuda|cpu]

Fig2-style rows over a YCSB-E-like mix: ``scan_frac`` of the
transactions carry one interval READ of ``scan_len`` consecutive keys,
validated at commit by ``iterate_validate``.  Two sweeps:

  (a) scan FRACTION at a fixed length (16);
  (b) scan LENGTH at a fixed fraction (0.25).

Printed per point, and checked:
  - coarse phantom aborts >= fine phantom aborts (bucket claims
    over-approximate the interval);
  - mvcc aborts ZERO phantoms (snapshot scans read a consistent cut)
    while mvocc, which re-validates, pays.

Open-loop by default (arrivals at 3/4 of the lane width).  Rows carry
``scan_frac``/``scan_len`` and the cost-model columns and go to
``reports/scan_mix.json``.  ``main``'s ``lanes`` keyword replaces the
twin's 64 lanes (a CPU test runs it small).
"""
from __future__ import annotations

import argparse

from repro_torch.benchmarks.common import one, save_rows, sweep

CCS = ["occ", "tictoc", "mvcc", "mvocc"]
LANES = [64]
SCAN_FRACS = (0.1, 0.3, 0.5)
SCAN_LENS = (4, 16, 64)


def _scan_rows(waves, n_keys, device, *, scan_frac, scan_len, lanes,
               open_loop):
    kw = {}
    if open_loop:
        # Offered load at 3/4 of the lane width keeps the admission queue
        # busy without saturating it: goodput then reflects abort-driven
        # retries, not queue overflow.
        kw["arrival_rate"] = 0.75 * max(lanes)
    rows = sweep("ycsb", ccs=CCS, lanes=lanes, waves=waves, n_keys=n_keys,
                 device=device, warm=True, quiet=True,
                 scan_frac=scan_frac, scan_len=scan_len, **kw)
    for r in rows:
        r["scan_frac"] = scan_frac
        r["scan_len"] = scan_len
    return rows


def _report(rows, axis, value, lanes):
    for cc in CCS:
        c = one(rows, cc=cc, granularity=0, lanes=lanes)
        f = one(rows, cc=cc, granularity=1, lanes=lanes)
        cp, fp = (r["abort_causes"]["phantom"] for r in (c, f))
        line = (f"  {axis}={value:<5g} {cc:7s} phantoms "
                f"coarse={cp:6d} fine={fp:6d}  "
                f"abort {100 * c['abort_rate']:6.2f}% -> "
                f"{100 * f['abort_rate']:6.2f}%")
        if "goodput" in c:
            line += (f"  goodput {c['goodput']:7.3f} -> "
                     f"{f['goodput']:7.3f} txn/us")
        else:
            line += (f"  thpt {c['throughput']:7.3f} -> "
                     f"{f['throughput']:7.3f} txn/us")
        print(line)
        if cc == "mvcc":
            if cp or fp:
                raise AssertionError("snapshot scans admit phantoms (SI)")
        elif cp < fp:
            raise AssertionError(f"{cc}: coarse bucket claims "
                                 "over-approximate, yet fine saw more "
                                 "phantoms")


def main(argv=None, lanes=LANES):
    ap = argparse.ArgumentParser()
    ap.add_argument("--waves", type=int, default=200)
    ap.add_argument("--n-keys", type=int, default=100_000)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--closed-loop", action="store_true",
                    help="skip the open-loop front-end (rows then carry "
                         "throughput instead of goodput)")
    ap.add_argument("--json", default="reports/scan_mix.json")
    args = ap.parse_args(argv)
    open_loop = not args.closed_loop

    rows = []
    print(f"# scan-fraction sweep (scan_len=16, T={lanes[0]}, "
          f"repro_torch on {args.device})")
    for sf in SCAN_FRACS:
        r = _scan_rows(args.waves, args.n_keys, args.device,
                       scan_frac=sf, scan_len=16, lanes=lanes,
                       open_loop=open_loop)
        _report(r, "frac", sf, lanes[0])
        rows += r
    print(f"# scan-length sweep (scan_frac=0.25, T={lanes[0]})")
    for sl in SCAN_LENS:
        r = _scan_rows(args.waves, args.n_keys, args.device,
                       scan_frac=0.25, scan_len=sl, lanes=lanes,
                       open_loop=open_loop)
        _report(r, "len", sl, lanes[0])
        rows += r
    save_rows(rows, args.json)
    return rows


if __name__ == "__main__":
    main()
