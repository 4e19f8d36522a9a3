"""Where a wave's time goes on the card.

    PYTHONPATH=src python -m repro_torch.launch.wave_profile \
        --workload tpcc --cc occ tictoc 2pl --lanes 128 --waves 50
    PYTHONPATH=src python -m repro_torch.launch.wave_profile \
        --workload ycsb --cc occ mvcc --scan-frac 0.95 --scan-len 100
    PYTHONPATH=src python -m repro_torch.launch.wave_profile \
        --workload ycsb --cc occ mvcc --arrival-rate 96
    PYTHONPATH=src python -m repro_torch.launch.wave_profile \
        --workload tpcc --cc 2pl adaptive --unfused
    PYTHONPATH=src python -m repro_torch.launch.wave_profile \
        --workload tpcc --cc occ --track-conflicts --per-wave
    PYTHONPATH=src python -m repro_torch.launch.wave_profile \
        --workload tpcc --cc occ mvcc --track-values

For each (cc, granularity) of the ``--cc`` mechanisms (OCC and TicToc by
default): the host wall time per wave
(``core/engine.run_waves``, the wave loop of ``run``, synchronized, without
the profiler) and the port's kernel launches per wave in that run (the
wrappers' counters), then one ``torch.profiler`` pass over the same
number of waves giving the device kernels per wave, the device-busy time
per wave (the union of kernel and copy intervals), the idle share of the
profiled wall time, the kernels that take the most device time, and the
device ms a wave under each of the engine's named ranges
(``core/ranges.py``: the device time of the kernels launched inside the
range, nested ranges included, so ``repro:validate`` holds
``repro:wave_commit``'s; kineto draws each range as a span on the device,
which counts as no device event and no busy time).  The workload flags
are txn_bench's (scans, read-only share, write share), and so is
``--arrival-rate`` (the open loop, with ``txn_bench.make_config``'s queue
and incarnations); ``--unfused`` takes the probe family's unfused route;
the multi-version mechanisms get txn_bench's default ring of 4 slots.
``--track-conflicts`` keeps the conflict histogram (three more kernel
launches a wave), ``--track-values`` the record values (the
``apply_values`` replay once a wave, twice under MVCC and MV-OCC, under
the range ``repro:apply_values`` for the flat values) and ``--per-wave``
the per-wave timeline (``engine.Timeline``), as ``run`` does.
Prints one JSON line per configuration and needs a CUDA device.
"""
from __future__ import annotations

import argparse
import bisect
import json
import time
from collections import defaultdict

import torch


def device_ops(events) -> tuple[list, list]:
    """Split a profile's device-side events into (kernels and copies, the
    spans kineto draws on the device for named ranges).  A range's span
    runs from its first kernel's start to its last kernel's end, gaps
    included, so it is no device operation and no busy time."""
    from torch.autograd import DeviceType
    ops, spans = [], []
    for e in events:
        if e.device_type != DeviceType.CUDA:
            continue
        ranged = (getattr(e, "is_user_annotation", False)
                  or e.name.startswith("repro:"))
        (spans if ranged else ops).append(e)
    return ops, spans


def range_busy_us(ops: list, spans: list) -> dict:
    """{range name: device µs of the kernels and copies that start inside
    one of its spans}.  A wave runs on one stream, so the operations
    inside a range's span are the ones launched inside the range, nested
    ranges' included."""
    starts = sorted((e.time_range.start, e.time_range.elapsed_us())
                    for e in ops)
    at = [s for s, _ in starts]
    csum = [0.0]
    for _, us in starts:
        csum.append(csum[-1] + us)
    out = defaultdict(float)
    for e in spans:
        lo = bisect.bisect_left(at, e.time_range.start)
        hi = bisect.bisect_right(at, e.time_range.end)
        out[e.name] += csum[hi] - csum[lo]
    return out


def profile_device(fn, n: int, top: int = 8) -> dict:
    """Run ``fn()`` (``n`` waves) once under ``torch.profiler``: device
    events per wave, device-busy ms per wave (the union of kernel and copy
    intervals), the idle share of the profiled, synchronized wall time,
    the kernels that take the most device time and the device ms a wave
    of each named range (``range_busy_us``)."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kern, spans = device_ops(prof.events())
    ivals = sorted((e.time_range.start, e.time_range.end) for e in kern)
    busy, end = 0.0, float("-inf")
    for s, e in ivals:  # union of device intervals (us)
        if e > end:
            busy += e - max(s, end)
            end = e
    by_name = defaultdict(lambda: [0.0, 0])
    for e in kern:
        by_name[e.name][0] += e.time_range.elapsed_us()
        by_name[e.name][1] += 1
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]
    ranges = range_busy_us(kern, spans)
    return {
        "wall_ms_per_wave_profiled": wall / n * 1e3,
        "device_events_per_wave": len(kern) / n,
        "device_busy_ms_per_wave": busy / n / 1e3,
        "device_idle_share": 1.0 - busy / 1e6 / wall,
        "top_device": [
            {"name": k[:80], "ms_per_wave": us / n / 1e3, "per_wave": c / n}
            for k, (us, c) in ranked],
        "range_device_ms_per_wave": {k: us / n / 1e3
                                     for k, us in sorted(ranges.items())},
    }


def profile(workload: str, cc: str, gran: int, lanes: int, waves: int,
            warmup: int = 10, top: int = 8, arrival_rate: float = 0.0,
            fuse_wave: bool = True, track_conflicts: bool = False,
            per_wave: bool = False, track_values: bool = False,
            **wl_kw) -> dict:
    """``arrival_rate > 0`` makes the run open-loop; ``fuse_wave=False``
    takes the probe family's unfused route; ``track_conflicts`` keeps the
    conflict histogram, ``track_values`` the record values and
    ``per_wave`` the per-wave timeline."""
    import dataclasses
    from repro_torch import kernels as K
    from repro_torch.core.engine import (Timeline, make_open_wave_step,
                                         make_wave_step, run_waves)
    from repro_torch.core.types import engine_state_init, resolve_device
    from repro_torch.launch.txn_bench import make_config, make_workload
    dev = resolve_device("cuda")
    wl = make_workload(workload, **wl_kw)
    cfg = dataclasses.replace(
        make_config(wl, cc, gran, lanes, fuse_wave,
                    arrival_rate=arrival_rate),
        track_conflicts=track_conflicts, track_values=track_values)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    state = engine_state_init(cfg, wl.init_store(dev, cfg.mv_depth,
                                                 track_values))
    step = (make_open_wave_step if cfg.open_loop else make_wave_step)(cfg)

    def loop(state, n):
        timeline = Timeline(n, state.wave) if per_wave else None
        return run_waves(cfg, wl, state, step, gen, n, timeline=timeline)
    state, _ = loop(state, warmup)
    before = K.launch_counts()
    state, wall = loop(state, waves)
    launched = {op: (n - before[op]) / waves
                for op, n in K.launch_counts().items() if n > before[op]}
    return {
        "workload": workload, "cc": cc, "granularity": gran,
        "lanes": lanes, "waves": waves, "max_extent": cfg.max_extent,
        "workload_kw": wl_kw, "arrival_rate": arrival_rate,
        "fuse_wave": fuse_wave, "track_conflicts": track_conflicts,
        "track_values": track_values, "per_wave": per_wave,
        "device_name": torch.cuda.get_device_name(dev),
        "wall_ms_per_wave": wall / waves * 1e3,
        "kernel_launches_per_wave": launched,
        **profile_device(lambda: loop(state, waves), waves, top),
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
    ap.add_argument("--unfused", action="store_true",
                    help="the probe family's unfused route (claim_probe "
                         "and commit_install in place of wave_commit)")
    ap.add_argument("--track-conflicts", action="store_true",
                    help="keep the conflict histogram (commit_install, "
                         "segment_count and ts_install_max once more a "
                         "wave)")
    ap.add_argument("--track-values", action="store_true",
                    help="track the record values (apply_values once a "
                         "wave, twice under MVCC and MV-OCC)")
    ap.add_argument("--per-wave", action="store_true",
                    help="keep the per-wave timeline, as engine.run does")
    args = ap.parse_args(argv)
    kw = {"scan_len": args.scan_len}
    if args.workload == "ycsb":
        kw.update(n_keys=args.n_keys, write_frac=args.write_frac,
                  ro_frac=args.ro_frac, scan_frac=args.scan_frac)
    for gran in (0, 1):
        for cc in args.cc:
            print(json.dumps(profile(args.workload, cc, gran, args.lanes,
                                     args.waves,
                                     arrival_rate=args.arrival_rate,
                                     fuse_wave=not args.unfused,
                                     track_conflicts=args.track_conflicts,
                                     per_wave=args.per_wave,
                                     track_values=args.track_values, **kw)),
                  flush=True)


if __name__ == "__main__":
    main()
