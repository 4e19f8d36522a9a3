"""Shared sweep machinery of the port's paper-figure scripts (the twin of
``benchmarks/common.py``).

Every figure runs its grid through ``launch/txn_bench.run_grid``, which
runs ``core/engine.sweep`` on ``device`` (CUDA by default, ``"cpu"`` for
the plain versions of the kernels).  Rows carry the JAX rows' keys, the
cost-model columns (``bytes_per_txn``, ``flops_per_txn``, ``roofline_*``,
``launches_per_wave``, ``dma_rows_per_wave*``; analysis/txn_cost.py on
the port's tables) included, plus ``device_name``, ``waves_per_s``,
``lanes_run`` and ``kernel_ops``.
"""
from __future__ import annotations

import json
import os
import time

import torch

CCS = ["occ", "tictoc", "2pl", "swisstm", "adaptive", "mvcc", "mvocc"]
LANES = [8, 16, 32, 64, 96, 128]


def _synchronize():
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def warm_then_time(fn, *args, **kw):
    """Call ``fn`` once (the first call builds the kernels and warms the
    allocator) and synchronize, then time a second call up to a device
    synchronize.  Returns ``(result of the second call, seconds)``."""
    fn(*args, **kw)
    _synchronize()
    t0 = time.perf_counter()
    out = fn(*args, **kw)
    _synchronize()
    return out, time.perf_counter() - t0


def sweep(workload: str, *, ccs=None, lanes=None, grans=(0, 1), waves=300,
          scale=1.0, n_keys=1_000_000, seed=1, quiet=False, device="cuda",
          warm=False, **wl_kw):
    """One grid through ``run_grid``; extra keywords (write_frac, ro_frac,
    theta, scan_frac, scan_len, arrival_rate, per_wave, return_points,
    ...) pass through, and with ``return_points`` the result is ``(rows,
    SweepPoints)``.  ``warm=True`` runs the grid twice through
    ``warm_then_time`` and keeps the second pass's rows, whose ``wall_s``
    is each point's own warm wave loop."""
    from repro_torch.launch.txn_bench import run_grid
    grid_args = (workload, list(ccs or CCS), tuple(grans),
                 list(lanes or LANES), waves)
    grid_kw = dict(scale=scale, n_keys=n_keys, seed=seed, device=device,
                   **wl_kw)
    if warm:
        ret, _ = warm_then_time(run_grid, *grid_args, **grid_kw)
    else:
        ret = run_grid(*grid_args, **grid_kw)
    rows = ret[0] if isinstance(ret, tuple) else ret
    if not quiet:
        for r in rows:
            line = (f"  {workload} {r['cc']:9s} "
                    f"{'fine' if r['granularity'] else 'coarse'} "
                    f"T={r['lanes']:4d}  "
                    f"thpt={r['throughput']:8.3f}  "
                    f"abort={100*r['abort_rate']:6.2f}%  "
                    f"{r['waves_per_s']:8.1f} waves/s")
            if r.get("open_loop"):
                line += (f"  goodput={r['goodput']:8.3f}  "
                         f"p99ttc={max(r['p99_ttc_waves']):g}w")
            print(line)
    return ret


def save_rows(rows, path):
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(rows, f, indent=1)
    print(f"[saved] {path}")


def by(rows, **kv):
    return [r for r in rows if all(r.get(k) == v for k, v in kv.items())]


def one(rows, **kv):
    m = by(rows, **kv)
    if len(m) != 1:
        raise LookupError(f"{len(m)} rows match {kv}, expected one")
    return m[0]
