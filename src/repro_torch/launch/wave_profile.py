"""Where a wave's time goes on the card.

    PYTHONPATH=src python -m repro_torch.launch.wave_profile \
        --workload tpcc --cc occ tictoc 2pl --lanes 128 --waves 50
    PYTHONPATH=src python -m repro_torch.launch.wave_profile \
        --workload ycsb --cc occ mvcc --scan-frac 0.95 --scan-len 100
    PYTHONPATH=src python -m repro_torch.launch.wave_profile \
        --workload ycsb --cc occ mvcc --arrival-rate 96

For each (cc, granularity) of the ``--cc`` mechanisms (OCC and TicToc by
default): the host wall time per wave
(``core/engine.run_waves``, the wave loop of ``run``, synchronized, without
the profiler), then one ``torch.profiler`` pass over the same number of waves
giving the device kernels per wave, the device-busy time per wave (the
union of kernel and copy intervals), the idle share of the profiled wall
time, and the kernels that take the most device time.  The workload
flags are txn_bench's (scans, read-only share, write share), and so is
``--arrival-rate`` (the open loop, with ``txn_bench.make_config``'s
queue and incarnations); the multi-version mechanisms get txn_bench's
default ring of 4 slots.
Prints one JSON line per configuration and needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import time
from collections import defaultdict

import torch


def profile_device(fn, n: int, top: int = 8) -> dict:
    """Run ``fn()`` (``n`` waves) once under ``torch.profiler``: device
    events per wave, device-busy ms per wave (the union of kernel and copy
    intervals), the idle share of the profiled, synchronized wall time and
    the kernels that take the most device time."""
    from torch.autograd import DeviceType
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kern = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    spans = sorted((e.time_range.start, e.time_range.end) for e in kern)
    busy, end = 0.0, float("-inf")
    for s, e in spans:  # union of device intervals (us)
        if e > end:
            busy += e - max(s, end)
            end = e
    by_name = defaultdict(lambda: [0.0, 0])
    for e in kern:
        by_name[e.name][0] += e.time_range.elapsed_us()
        by_name[e.name][1] += 1
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]
    return {
        "wall_ms_per_wave_profiled": wall / n * 1e3,
        "device_events_per_wave": len(kern) / n,
        "device_busy_ms_per_wave": busy / n / 1e3,
        "device_idle_share": 1.0 - busy / 1e6 / wall,
        "top_device": [
            {"name": k[:80], "ms_per_wave": us / n / 1e3, "per_wave": c / n}
            for k, (us, c) in ranked],
    }


def profile(workload: str, cc: str, gran: int, lanes: int, waves: int,
            warmup: int = 10, top: int = 8, arrival_rate: float = 0.0,
            **wl_kw) -> dict:
    """``arrival_rate > 0`` makes the run open-loop."""
    from repro_torch.core.engine import (make_open_wave_step, make_wave_step,
                                         run_waves)
    from repro_torch.core.types import engine_state_init, resolve_device
    from repro_torch.launch.txn_bench import make_config, make_workload
    dev = resolve_device("cuda")
    wl = make_workload(workload, **wl_kw)
    cfg = make_config(wl, cc, gran, lanes, arrival_rate=arrival_rate)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    state = engine_state_init(cfg, wl.init_store(dev, cfg.mv_depth))
    step = (make_open_wave_step if cfg.open_loop else make_wave_step)(cfg)
    state, _ = run_waves(cfg, wl, state, step, gen, warmup)
    state, wall = run_waves(cfg, wl, state, step, gen, waves)
    return {
        "workload": workload, "cc": cc, "granularity": gran,
        "lanes": lanes, "waves": waves, "max_extent": cfg.max_extent,
        "workload_kw": wl_kw, "arrival_rate": arrival_rate,
        "device_name": torch.cuda.get_device_name(dev),
        "wall_ms_per_wave": wall / waves * 1e3,
        **profile_device(lambda: run_waves(cfg, wl, state, step, gen, waves),
                         waves, top),
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", choices=("tpcc", "ycsb"), default="tpcc")
    from repro_torch.launch.txn_bench import CCS
    ap.add_argument("--cc", nargs="+", choices=CCS, default=["occ", "tictoc"])
    ap.add_argument("--lanes", type=int, default=128)
    ap.add_argument("--waves", type=int, default=50)
    ap.add_argument("--n-keys", type=int, default=10_000_000)
    ap.add_argument("--write-frac", type=float, default=0.5)
    ap.add_argument("--ro-frac", type=float, default=0.0)
    ap.add_argument("--scan-frac", type=float, default=0.0)
    ap.add_argument("--scan-len", type=int, default=0,
                    help="TPC-C: switches its scans on at this stock "
                         "window; YCSB: the scan class's width")
    ap.add_argument("--arrival-rate", type=float, default=0.0,
                    help="open loop: expected Poisson arrivals per wave")
    args = ap.parse_args(argv)
    kw = {"scan_len": args.scan_len}
    if args.workload == "ycsb":
        kw.update(n_keys=args.n_keys, write_frac=args.write_frac,
                  ro_frac=args.ro_frac, scan_frac=args.scan_frac)
    for gran in (0, 1):
        for cc in args.cc:
            print(json.dumps(profile(args.workload, cc, gran, args.lanes,
                                     args.waves,
                                     arrival_rate=args.arrival_rate, **kw)),
                  flush=True)


if __name__ == "__main__":
    main()
