"""Wave-level trace timeline -> Chrome-trace / Perfetto JSON (the twin of
the JAX package's ``analysis/trace.py``: the same schema and event
layout, so both packages' traces of the same per-wave arrays are equal).

The engine's per-wave counters (``sweep(..., per_wave=True)`` /
``run(...)``: per_wave_commits / per_wave_aborts / per_wave_causes /
per_wave_us) become one trace row per grid point: an X "complete" event
per wave on the SIMULATED-time axis (ts = cumulative simulated
microseconds, dur = the wave's simulated microseconds), with the wave's
commit / abort / per-cause deltas in ``args``, plus C "counter" events
so the commit and abort series plot as stacked tracks.  Load the file
into chrome://tracing or https://ui.perfetto.dev.

A point's measured host seconds (``wall_s``) and device go into the
process-name metadata's ``args`` (``meta``), never onto the time axis,
which stays simulated.  ``--trace`` / ``REPRO_TRACE`` in
launch/txn_bench.py and benchmarks/open_loop.py write the file.  The
measured timeline of the card is ``torch.profiler``'s: the engine names
its phases with ``torch.profiler.record_function`` ranges of the JAX
package's names (``repro:validate``, ``repro:cost``, ``repro:claim``,
...; ``core/ranges.py``), while a profiler runs.

``validate_chrome_trace`` is the minimal schema check run on every
emitted file.
"""
from __future__ import annotations

import json

from repro_torch.core import types as t

#: Trace-event phase codes this exporter emits.
PH_COMPLETE = "X"
PH_COUNTER = "C"
PH_METADATA = "M"


def _args_for_wave(commits: int, aborts: int, causes) -> dict:
    a = {"commits": int(commits), "aborts": int(aborts)}
    if causes is not None:
        for code, name in t.CAUSE_NAMES.items():
            a[f"abort_{name}"] = int(causes[code])
    return a


def point_events(label: str, pid: int, per_wave_commits, per_wave_aborts,
                 per_wave_us, per_wave_causes=None, meta=None) -> list:
    """Trace events for ONE grid point (one process row in the viewer).
    ``meta`` ({key: JSON value}, e.g. the measured ``wall_s`` and the
    device) joins the process name's ``args``."""
    evs = [{"ph": PH_METADATA, "name": "process_name", "pid": pid, "tid": 0,
            "args": {"name": label, **(meta or {})}},
           {"ph": PH_METADATA, "name": "thread_name", "pid": pid, "tid": 0,
            "args": {"name": "waves"}}]
    ts = 0.0
    for w in range(len(per_wave_commits)):
        dur = float(per_wave_us[w]) if per_wave_us is not None else 1.0
        dur = max(dur, 1e-3)       # zero-width slices vanish in the viewer
        c, a = int(per_wave_commits[w]), int(per_wave_aborts[w])
        causes = (per_wave_causes[w] if per_wave_causes is not None
                  else None)
        evs.append({"ph": PH_COMPLETE, "name": f"wave {w}", "cat": "wave",
                    "pid": pid, "tid": 0, "ts": ts, "dur": dur,
                    "args": _args_for_wave(c, a, causes)})
        evs.append({"ph": PH_COUNTER, "name": "txns", "pid": pid,
                    "ts": ts, "args": {"commits": c, "aborts": a}})
        ts += dur
    return evs


def point_meta(p) -> dict:
    """The measured facts of a point that a trace carries beside its
    label: ``wall_s`` (host seconds of its wave loop) and ``device``, where
    the point has them (the port's SweepPoints do)."""
    return {k: getattr(p, k) for k in ("wall_s", "device")
            if getattr(p, k, None) is not None}


def sweep_trace(points, label_fn=None) -> dict:
    """Chrome-trace dict from SweepPoints carrying per-wave timelines
    (``sweep(..., per_wave=True)``).  Points without per-wave data are
    skipped; ``label_fn(point) -> str`` names each process row (default:
    ``"<cc>/<granularity>/T<lanes>"``); ``point_meta`` fills the process
    name's ``args``."""
    if label_fn is None:
        def label_fn(p):
            return (f"{t.CC_NAMES.get(p.cc, p.cc)}/"
                    f"{'fine' if p.granularity else 'coarse'}/T{p.lanes}")
    events = []
    pid = 0
    for p in points:
        if getattr(p, "per_wave_commits", None) is None:
            continue
        pid += 1
        events += point_events(label_fn(p), pid, p.per_wave_commits,
                               p.per_wave_aborts, p.per_wave_us,
                               p.per_wave_causes, point_meta(p))
    return {"traceEvents": events, "displayTimeUnit": "ms",
            "otherData": {"source": "repro wave-level trace",
                          "time_axis": "simulated microseconds"}}


def validate_chrome_trace(trace: dict) -> list:
    """Minimal Chrome-trace schema check; returns a list of problem
    strings (empty = valid).  Checks the shape chrome://tracing actually
    requires: a traceEvents list of dicts, every event with a string
    ``ph``, X events with numeric ts/dur and pid/tid, M events with a
    name."""
    errs = []
    if not isinstance(trace, dict):
        return [f"trace must be a dict, got {type(trace).__name__}"]
    evs = trace.get("traceEvents")
    if not isinstance(evs, list):
        return ["traceEvents must be a list"]
    if not evs:
        errs.append("traceEvents is empty")
    for i, e in enumerate(evs):
        if not isinstance(e, dict):
            errs.append(f"event {i}: not a dict")
            continue
        ph = e.get("ph")
        if not isinstance(ph, str) or not ph:
            errs.append(f"event {i}: missing ph")
            continue
        if ph == PH_COMPLETE:
            for k in ("ts", "dur"):
                if not isinstance(e.get(k), (int, float)):
                    errs.append(f"event {i}: X event needs numeric {k}")
            for k in ("pid", "tid"):
                if not isinstance(e.get(k), int):
                    errs.append(f"event {i}: X event needs int {k}")
            if not e.get("name"):
                errs.append(f"event {i}: X event needs a name")
        elif ph == PH_METADATA:
            if not e.get("name"):
                errs.append(f"event {i}: M event needs a name")
            if not isinstance(e.get("args"), dict):
                errs.append(f"event {i}: M event needs args")
        elif ph == PH_COUNTER:
            if not isinstance(e.get("ts"), (int, float)):
                errs.append(f"event {i}: C event needs numeric ts")
            if not isinstance(e.get("args"), dict):
                errs.append(f"event {i}: C event needs args")
    return errs


def write_trace(path: str, trace: dict) -> str:
    """Validate then write ``trace`` as JSON; raises on schema errors so a
    bench run can never silently emit a file the viewer rejects."""
    errs = validate_chrome_trace(trace)
    if errs:
        raise ValueError("refusing to write an invalid Chrome trace: "
                         + "; ".join(errs[:5]))
    with open(path, "w") as f:
        json.dump(trace, f)
    return path
