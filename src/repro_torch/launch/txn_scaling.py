"""Sharded-engine scaling on the port (counterpart of
benchmarks/txn_scaling.py).

    PYTHONPATH=src python -m repro_torch.launch.txn_scaling --waves 30
    PYTHONPATH=src torchrun --nproc-per-node 4 \
        -m repro_torch.launch.txn_scaling --pipeline-depth 2 --waves 30 \
        --json build/scaling.json

A ``shards=0`` anchor row first runs the local engine (core/engine.run)
on YCSB at the same global lane count, OCC fine.  Then, on this process
group's shards (one when run alone), the sharded runner
(core/distributed.make_run_fn) runs OCC and MVCC (ring depth 4) on the
JAX benchmark's draws: ``--n-keys`` uniform keys, 2 groups, READ/WRITE
ops, the global lanes split evenly over the ranks, one batch for every
wave and a fresh lane permutation per wave; each mechanism at the
effective pipeline depths {1, ``--pipeline-depth``} (``depths``: one
shard runs depth 1 only, as the JAX benchmark's rows).  Rows carry the
JAX rows' keys (``shards``, ``cc``, ``commits``, ``waves_per_s``,
``pipeline_depth``, ``ro_commits``, ``ro_aborts``, ``abort_causes``,
``kernel_ops``, the ``wire_bytes_per_wave`` fields) plus
``device_name``; ``coll_bytes_per_wave`` is what this rank handed to
``all_to_all_single`` per exchange step, counted by the port's
``Exchange`` (a pipelined run's ``n_waves + 3`` steps, as the JAX
benchmark divides).  ``waves_per_s`` is the
slowest rank's synchronized host time of the timed run, after a warm-up
run.

Then the open-loop row family (``mode: "open_loop"``), at the effective
depth of ``--pipeline-depth``: the same routed wave behind each rank's
admission ring (core/distributed.run_open_loop) for OCC and MVCC at both
granularities, a queue of 4 x the rank's lanes, 8 incarnations, 32
time-to-commit bins, Poisson arrivals at 0.75 x the global lanes a wave
split over the ranks (``PoissonArrivals.shard_counts``, seed 7) and the
JAX benchmark's fresh candidates per wave (numpy, seed 5000 + wave).
Rows add ``goodput_txn_per_s`` (commits over the run's host seconds, the
candidates' generation included, as in the JAX benchmark), p50/p99
time-to-commit in waves from the ranks' summed histograms and the
admission counters.  ``--device`` defaults to CUDA (one card per rank,
NCCL); ``cpu`` runs the plain versions over gloo.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch
import torch.distributed as dist

#: The JAX benchmark's sizes: global lanes, slots, records, and the
#: pipeline depth of its second sweep.
GLOBAL_LANES, SLOTS, N_KEYS = 256, 16, 1_000_000
PIPELINE_DEPTH = 2
WARMUP_WAVES = 3


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _device_name(dev: torch.device) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def _deltas(before: tuple) -> tuple:
    from repro_torch import kernels
    after = (kernels.launch_counts(), kernels.call_counts())
    return tuple({op: a[op] - b[op] for op in a}
                 for a, b in zip(after, before))


def anchor_row(dev: torch.device, waves: int, lanes: int,
               n_keys: int) -> dict:
    """The local engine's OCC-fine run on YCSB at ``lanes`` lanes."""
    from repro_torch import kernels
    from repro_torch.core import types as t
    from repro_torch.core.backend import kernel_coverage
    from repro_torch.core.engine import run
    from repro_torch.launch.txn_bench import make_config, make_workload
    wl = make_workload("ycsb", n_keys=n_keys)
    cfg = make_config(wl, "occ", 1, lanes)
    run(cfg, wl, WARMUP_WAVES, device=dev)
    before = (kernels.launch_counts(), kernels.call_counts())
    res = run(cfg, wl, waves, device=dev)
    launches, calls = _deltas(before)
    return {"shards": 0, "cc": "occ", "commits": res.commits,
            "waves_per_s": waves / res.wall_s, "coll_bytes_per_wave": 0,
            "ro_commits": res.ro_commits, "ro_aborts": res.ro_aborts,
            "abort_causes": res.abort_causes, "backend": dev.type,
            "kernel_ops": kernel_coverage(t.CC_OCC, launches, calls),
            "device_name": _device_name(dev)}


def draws(waves: int, lanes: int, slots: int, n_keys: int, rank: int,
          ns: int, dev: torch.device) -> tuple:
    """This rank's slice of the JAX benchmark's draws: (keys, groups,
    kinds [waves, T, K], prio [waves, T])."""
    from repro_torch.core import types as t
    rng = np.random.default_rng(0)
    keys = rng.integers(0, n_keys, (lanes, slots), dtype=np.int32)
    groups = rng.integers(0, 2, (lanes, slots), dtype=np.int32)
    kinds = rng.choice([t.READ, t.WRITE], (lanes, slots)).astype(np.int32)
    prio = np.stack([np.random.default_rng(w).permutation(lanes)
                     for w in range(waves)]).astype(np.int32)
    T = lanes // ns
    mine = slice(rank * T, (rank + 1) * T)

    def stack(a):
        a = np.ascontiguousarray(np.broadcast_to(a[mine],
                                                 (waves, T, slots)))
        return torch.from_numpy(a).to(dev)
    return (stack(keys), stack(groups), stack(kinds),
            torch.from_numpy(np.ascontiguousarray(prio[:, mine])).to(dev))


def depths(ns: int, depth: int) -> list:
    """The effective pipeline depths {1, ``depth``} on ``ns`` shards,
    deduplicated (one shard runs depth 1 only)."""
    from repro_torch.core.distributed import DistConfig
    return sorted({DistConfig(n_records=1, pipeline_depth=d).depth(ns)
                   for d in (1, depth)})


def _steps(cfg, ns: int, waves: int) -> int:
    """Exchange steps of a run: a pipelined run adds three drain steps, so
    bytes per step are the steady-state wave's, as the JAX benchmark
    divides them."""
    return waves + (3 if cfg.depth(ns) >= 2 else 0)


def sharded_row(cc: str, shards, waves: int, lanes: int, slots: int,
                n_keys: int, depth: int = 1) -> dict:
    """One sharded run of ``cc`` at pipeline depth ``depth`` on every rank
    of the group; every rank returns the row (counts summed over
    ranks)."""
    from repro_torch import kernels
    from repro_torch.core import distributed as D
    from repro_torch.core.backend import dist_kernel_coverage
    dev, ns = shards.device, shards.size
    cfg = D.DistConfig(n_records=n_keys, n_groups=2,
                       lanes_per_shard=lanes // ns, slots=slots, cc=cc,
                       mv_depth=4 if cc != "occ" else 0,
                       pipeline_depth=depth)
    keys, groups, kinds, prio = draws(waves, lanes, slots, n_keys,
                                      shards.rank, ns, dev)
    n = min(WARMUP_WAVES, waves)
    D.make_run_fn(cfg, n)(keys[:n], groups[:n], kinds[:n], prio[:n],
                          D.init_tables(cfg, None, dev))
    run = D.make_run_fn(cfg, waves)
    tables = D.init_tables(cfg, None, dev)
    before = (kernels.launch_counts(), kernels.call_counts())
    dist.barrier()
    _sync(dev)
    t0 = time.perf_counter()
    commit, tables, stats = run(keys, groups, kinds, prio, tables)
    _sync(dev)
    dt = time.perf_counter() - t0
    launches, calls = _deltas(before)
    total = stats.to(torch.int64).sum(dim=0)
    dist.all_reduce(total)
    slowest = torch.tensor([dt], dtype=torch.float64, device=dev)
    dist.all_reduce(slowest, op=dist.ReduceOp.MAX)
    s = total.cpu().tolist()
    return {"shards": ns, "cc": cc, "commits": s[D.STAT_COMMITS],
            "aborts": s[D.STAT_ABORTS], "waves": waves,
            "waves_per_s": waves / float(slowest),
            "pipeline_depth": cfg.depth(ns),
            "coll_bytes_per_wave": run.exchange.bytes_sent
            / _steps(cfg, ns, waves),
            "ro_commits": s[D.STAT_RO_COMMITS],
            "ro_aborts": s[D.STAT_RO_ABORTS],
            "abort_causes": s[D.STAT_CAUSES],
            "dropped_ops": s[D.STAT_DROPPED_OPS], "backend": dev.type,
            "kernel_ops": dist_kernel_coverage(cc, launches, calls),
            "device_name": _device_name(dev),
            **D.wire_bytes_per_wave(cfg, ns)}


def open_candidates(lanes: int, slots: int, n_keys: int,
                    seed_base: int = 5000):
    """The JAX benchmark's open-loop candidates: ``gen(wave) -> (keys,
    groups, kinds [lanes, slots], prio [lanes])`` from numpy, globally
    shaped (each rank takes its own lanes)."""
    from repro_torch.core import types as t

    def gen(w):
        rng = np.random.default_rng(seed_base + w)
        keys = rng.integers(0, n_keys, (lanes, slots), dtype=np.int32)
        groups = rng.integers(0, 2, (lanes, slots), dtype=np.int32)
        kinds = rng.choice([t.READ, t.WRITE], (lanes, slots)).astype(
            np.int32)
        return keys, groups, kinds, rng.permutation(lanes).astype(np.int32)
    return gen


def open_row(cc: str, gran: int, shards, waves: int, lanes: int,
             slots: int, n_keys: int, depth: int = PIPELINE_DEPTH) -> dict:
    """One open-loop run of ``cc`` at granularity ``gran`` and pipeline
    depth ``depth`` on every rank of the group; every rank returns the
    row."""
    from repro_torch import kernels
    from repro_torch.core import distributed as D
    from repro_torch.core.admission import ttc_percentiles
    from repro_torch.core.backend import dist_kernel_coverage
    from repro_torch.workloads.arrivals import PoissonArrivals
    dev, ns = shards.device, shards.size
    T = lanes // ns
    cfg = D.DistConfig(n_records=n_keys, n_groups=2, lanes_per_shard=T,
                       slots=slots, granularity=gran, cc=cc,
                       mv_depth=4 if cc != "occ" else 0, queue_cap=4 * T,
                       max_incarnations=8, lat_bins=32, pipeline_depth=depth)
    gen = open_candidates(lanes, slots, n_keys)
    arrivals = PoissonArrivals(rate=0.75 * lanes, seed=7)
    n = min(WARMUP_WAVES, waves)
    D.run_open_loop(cfg, arrivals.shard_counts(n, ns, T), gen, n,
                    device=dev)
    before = (kernels.launch_counts(), kernels.call_counts())
    dist.barrier()
    s = D.run_open_loop(cfg, arrivals.shard_counts(waves, ns, T), gen,
                        waves, device=dev)
    launches, calls = _deltas(before)
    slowest = torch.tensor([s["wall_s"]], dtype=torch.float64, device=dev)
    dist.all_reduce(slowest, op=dist.ReduceOp.MAX)
    dt = float(slowest)
    (p50,), (p99,) = ttc_percentiles(s["lat_hist"].sum(axis=0)[None, :])
    return {"shards": ns, "cc": cc, "mode": "open_loop",
            "granularity": gran, "pipeline_depth": cfg.depth(ns),
            "commits": s["commits"], "aborts": s["aborts"], "waves": waves,
            "waves_per_s": waves / dt,
            "coll_bytes_per_wave": s["exchange_bytes"]
            / _steps(cfg, ns, waves),
            "goodput_txn_per_s": s["commits"] / dt,
            "p50_ttc_waves": p50, "p99_ttc_waves": p99,
            "offered": s["offered"], "admitted": s["admitted"],
            "arrival_drops": s["arrival_drops"],
            "inc_drops": s["inc_drops"],
            "queued_final": s["queued_final"],
            "ro_commits": s["ro_commits"], "ro_aborts": s["ro_aborts"],
            "abort_causes": s["abort_causes"], "backend": dev.type,
            "kernel_ops": dist_kernel_coverage(cc, launches, calls),
            "device_name": _device_name(dev),
            **D.wire_bytes_per_wave(cfg, ns)}


def scaling_rows(shards, waves: int = 30, lanes: int = GLOBAL_LANES,
                 slots: int = SLOTS, n_keys: int = N_KEYS,
                 depth: int = PIPELINE_DEPTH) -> list:
    """The anchor row (rank 0 only), the sharded OCC and MVCC rows at the
    effective depths {1, ``depth``}, then the open-loop rows (OCC and MVCC
    x coarse and fine) at ``depth``."""
    if lanes % shards.size:
        raise ValueError(f"{lanes} global lanes do not split over "
                         f"{shards.size} shards")
    rows = []
    if shards.rank == 0:
        rows.append(anchor_row(shards.device, waves, lanes, n_keys))
    for cc in ("occ", "mvcc"):
        for d in depths(shards.size, depth):
            rows.append(sharded_row(cc, shards, waves, lanes, slots, n_keys,
                                    d))
    for cc in ("occ", "mvcc"):
        for gran in (0, 1):
            rows.append(open_row(cc, gran, shards, waves, lanes, slots,
                                 n_keys, depth))
    return rows


def main(argv=None):
    from repro_torch.launch.mesh import close_shards, init_shards
    ap = argparse.ArgumentParser()
    ap.add_argument("--waves", type=int, default=30)
    ap.add_argument("--lanes", type=int, default=GLOBAL_LANES,
                    help="global lanes, split evenly over the ranks")
    ap.add_argument("--n-keys", type=int, default=N_KEYS)
    ap.add_argument("--pipeline-depth", type=int, default=PIPELINE_DEPTH,
                    help="software-pipeline depth of the second closed "
                         "row and the open rows (1 keeps every row "
                         "synchronous; one shard runs depth 1)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cpu runs the plain versions over gloo")
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)
    if args.waves < 1:
        ap.error(f"--waves must be >= 1, got {args.waves}")
    if args.pipeline_depth < 1:
        ap.error(f"--pipeline-depth must be >= 1, got "
                 f"{args.pipeline_depth}")
    shards = init_shards(args.device)
    try:
        rows = scaling_rows(shards, args.waves, args.lanes,
                            n_keys=args.n_keys, depth=args.pipeline_depth)
    finally:
        close_shards(shards)
    if shards.rank:
        return
    for r in rows:
        if r.get("mode") == "open_loop":
            print(f"open {r['cc']:4s} g={r['granularity']} "
                  f"shards={r['shards']} depth={r['pipeline_depth']}: "
                  f"goodput={r['goodput_txn_per_s']:8.1f} txn/s  p50/p99 "
                  f"ttc={r['p50_ttc_waves']:g}/{r['p99_ttc_waves']:g} "
                  f"waves  dropped={r['inc_drops']} on {r['device_name']}")
            continue
        print(f"{r['cc']:4s} shards={r['shards']} "
              f"depth={r.get('pipeline_depth', 1)}: "
              f"{r['waves_per_s']:8.1f} waves/s  {r['commits']} commits  "
              f"ro={r['ro_commits']}/{r['ro_aborts']}  coll/wave="
              f"{r['coll_bytes_per_wave'] / 1024:.1f} KiB on "
              f"{r['device_name']}")
    print("JSON:" + json.dumps(rows))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(rows, f, indent=1)


if __name__ == "__main__":
    main()
