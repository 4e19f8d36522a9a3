"""Perf dashboard of the port: benchmark JSON rows into one markdown
report (the twin of the JAX package's ``benchmarks/perf_dashboard.py``).

Sources: every ``BENCH_*.json`` in the working directory plus
``reports/*.json`` (the figure scripts' rows).  It reads the port's rows
and the JAX package's alike:

- mechanism rows (``launch/txn_bench.py`` and the figure scripts: a
  ``cc`` key), summarized per (workload, cc, granularity, backend, scan
  shape) at their peak-throughput lane count: abort rate and causes, the
  cost model's bytes and flops per transaction and roofline fraction
  (analysis/txn_cost.py), launches and touched rows per wave, and which
  ops ran as kernels (the port's ``cuda`` / ``torch`` / ``not_run``, the
  JAX package's ``pallas`` / ``xla``);
- distributed rows (``launch/txn_scaling.py``: a ``shards`` key), the
  latest row per (cc, shards, depth, backend).

Rows that carry the port's ``device_name`` or ``waves_per_s`` add a
device and a waves/s column; rows with only the JAX package's keys
render exactly as the JAX dashboard renders them.  Partial or malformed
rows are skipped with a warning line in the report.

    PYTHONPATH=src python -m repro_torch.benchmarks.perf_dashboard \
        [paths-or-globs ...] [--out reports/perf_dashboard.md]
"""
from __future__ import annotations

import argparse
import glob
import json
import os

DEFAULT_GLOBS = ("BENCH_*.json", "reports/*.json")


def _num(x) -> bool:
    """True for real JSON numbers (bool is an int in Python — excluded)."""
    return isinstance(x, (int, float)) and not isinstance(x, bool)


def _coerce(x):
    """Numeric value as float, or None.  Numeric STRINGS coerce too:
    hand-edited or CSV-converted bench files store "12.3", and comparing
    such strings lexically would rank "0.9" above "12.3" — every
    comparison in this module must go through here, never compare raw
    field values."""
    if _num(x):
        return float(x)
    if isinstance(x, str):
        try:
            return float(x)
        except ValueError:
            return None
    return None


def _fnum(r: dict, key: str, default=0):
    """Numeric field (coerced) or ``default`` — malformed values never
    crash a cell."""
    v = _coerce(r.get(key))
    return default if v is None else v


def _mech_problem(r) -> str | None:
    """Why a mechanism-shaped row can't be summarized (None = fine)."""
    if not isinstance(r, dict):
        return "not a JSON object"
    if _coerce(r.get("throughput")) is None:
        return "missing/non-numeric 'throughput'"
    return None


def _dist_problem(r) -> str | None:
    """Why a distributed-shaped row can't be summarized (None = fine)."""
    if not isinstance(r, dict):
        return "not a JSON object"
    if _coerce(r.get("shards")) is None:
        return "missing/non-numeric 'shards'"
    return None


def load_rows(patterns=DEFAULT_GLOBS) -> tuple[list, list]:
    """Expand globs, read every JSON list, split (mechanism, distributed)
    rows by shape (``cc`` vs ``shards`` key); rows of neither shape
    (unknown schema) are skipped.  Shape-matched rows are NOT validated
    here — render_markdown skips malformed ones with a report warning."""
    mech, dist = [], []
    for pat in patterns:
        for path in sorted(glob.glob(pat)):
            try:
                with open(path) as f:
                    rows = json.load(f)
            except (OSError, json.JSONDecodeError):
                continue
            if not isinstance(rows, list):
                continue
            for r in rows:
                if not isinstance(r, dict):
                    continue
                r = dict(r, _src=os.path.basename(path))
                # shards discriminates first: distributed rows also carry
                # a cc field since the MV wave went sharded
                if "shards" in r:
                    dist.append(r)
                elif "cc" in r:
                    mech.append(r)
    return mech, dist


def _ops_cell(kernel_ops: dict) -> str:
    """Compress a {op: engine} map: '4/4 pallas' or 'xla' (the JAX
    package's rows), '2/2 cuda' or 'torch' (the port's, with ', N not
    run' for the ops its folds leave uncalled), or a mixed listing (a
    partial fallback, worth seeing loudly)."""
    if not kernel_ops:
        return "—"
    ran = {op: e for op, e in kernel_ops.items() if e != "not_run"}
    idle = len(kernel_ops) - len(ran)
    tail = f", {idle} not run" if idle and ran else ""
    engines = set(ran.values())
    if engines in ({"pallas"}, {"cuda"}):
        return f"{len(ran)}/{len(ran)} {engines.pop()}{tail}"
    if engines in ({"xla"}, {"torch"}):
        return engines.pop() + tail
    return ", ".join(f"{op}:{eng}" for op, eng in sorted(kernel_ops.items()))


def _gran(g) -> str:
    return "fine" if g else "coarse"


def _ttc_cell(v) -> str:
    """Per-txn-class time-to-commit list -> 'a/b/c' cell ('—' when
    absent/malformed)."""
    if isinstance(v, (list, tuple)) and v:
        nums = [_coerce(x) for x in v]
        if all(n is not None for n in nums):
            return "/".join(f"{n:g}" for n in nums)
    n = _coerce(v)
    return f"{n:g}" if n is not None else "—"


def _src_of(r) -> str:
    return r.get("_src", "?") if isinstance(r, dict) else "?"


#: types.CAUSE_NAMES order, duplicated here so the dashboard imports
#: neither package's engine (it renders list-shaped cause rows from
#: txn_scaling too).
_CAUSE_ORDER = ("inc_cap", "capacity", "stale_snapshot", "lock_wound",
                "ww", "read_val", "phantom")


def _causes_cell(v) -> str:
    """Abort-cause breakdown cell: nonzero '<cause>:<n>' entries in code
    order.  Accepts the bench rows' name-keyed dict or txn_scaling's
    code-ordered list; '—' when absent/malformed, 'none' when all zero.
    Pre-scan rows (before the phantom cause existed) simply lack the
    trailing entry — both shapes tolerate that without warning."""
    if isinstance(v, dict):
        pairs = [(k, _coerce(v.get(k))) for k in _CAUSE_ORDER if k in v]
    elif isinstance(v, (list, tuple)):
        pairs = list(zip(_CAUSE_ORDER, (_coerce(x) for x in v)))
    else:
        return "—"
    if not pairs or any(n is None for _, n in pairs):
        return "—"
    nz = [f"{k}:{n:g}" for k, n in pairs if n]
    return " ".join(nz) if nz else "none"


def _scan_cell(r: dict) -> str:
    """Interval-read shape of the row: 'ext=N' (plus the workload's
    scan_frac x scan_len when the row carries them, e.g. scan_mix.py
    rows).  Pre-scan JSON rows have none of these fields and extent-1
    rows are pure point workloads — both render '—' (the default), never
    a warning."""
    ext = _coerce(r.get("max_extent"))
    if ext is None or ext <= 1:
        return "—"
    cell = f"ext={ext:g}"
    sf, sl = _coerce(r.get("scan_frac")), _coerce(r.get("scan_len"))
    if sf is not None and sl is not None:
        cell += f" ({sf:g}×{sl:g})"
    return cell


def _roofline_cell(r: dict) -> str:
    """'0.10% (memory)' — the mechanism's fraction of the modeled chip
    roofline and which roof binds (analysis/txn_cost.py)."""
    frac = _coerce(r.get("roofline_frac"))
    if frac is None:
        return "—"
    bound = r.get("roofline_bound", "?")
    return f"{100 * frac:.2f}% ({bound})"


def _per_txn_cell(r: dict, key: str) -> str:
    v = _coerce(r.get(key))
    return "—" if v is None else f"{v:g}"


def _dma_rows_cell(r: dict) -> str:
    """'1024 (/3 vs unfused)' — the fused probe chain's modeled touched-row
    DMA visits per wave next to the unfused-chain cut
    (analysis/txn_cost.py probe_chain); '—' outside the probe family."""
    rows = _coerce(r.get("dma_rows_per_wave"))
    if rows is None:
        return "—"
    unf = _coerce(r.get("dma_rows_per_wave_unfused"))
    if unf and rows:
        return f"{rows:g} (/{unf / rows:g} vs unfused)"
    return f"{rows:g}"


def _port_cols(rows: list) -> tuple[bool, bool]:
    """Whether any row carries the port's ``device_name`` /
    ``waves_per_s`` (the columns that only then appear)."""
    rows = [r for r in rows if isinstance(r, dict)]
    return (any("device_name" in r for r in rows),
            any("waves_per_s" in r for r in rows))


def _port_cells(r: dict, dev_col: bool, wps_col: bool) -> str:
    """The device and waves/s cells of a row, for the columns shown."""
    out = ""
    if dev_col:
        out += f"| {r.get('device_name', '—')} "
    if wps_col:
        v = _coerce(r.get("waves_per_s"))
        out += f"| {'—' if v is None else f'{v:.1f}'} "
    return out


def render_markdown(mech: list, dist: list) -> str:
    dev_col, wps_col = _port_cols(mech)
    port = dev_col or _port_cols(dist)[0]
    module = ("repro_torch.benchmarks.perf_dashboard" if port
              else "benchmarks.perf_dashboard")
    out = ["# Perf dashboard", "",
           "Aggregated from benchmark JSON rows (BENCH_*.json + "
           "reports/*.json); regenerate with "
           f"`PYTHONPATH=src python -m {module}`.", ""]

    # Partial/malformed rows (truncated bench files, killed runs) are
    # skipped and reported, never fatal.
    skipped: list[tuple[str, str]] = []
    mech_ok, dist_ok = [], []
    for r in mech:
        p = _mech_problem(r)
        if p:
            skipped.append((_src_of(r), f"mechanism row: {p}"))
        else:
            mech_ok.append(r)
    for r in dist:
        p = _dist_problem(r)
        if p:
            skipped.append((_src_of(r), f"distributed row: {p}"))
        else:
            dist_ok.append(r)

    if mech_ok:
        groups: dict = {}
        for r in mech_ok:
            # max_extent separates scan mixes from point mixes (they are
            # different workloads, not competing lane counts); pre-scan
            # rows default to the point shape, extent 1.
            key = (r.get("workload", "?"), r.get("cc", "?"),
                   r.get("granularity", 1), r.get("backend", "?"),
                   _fnum(r, "max_extent", 1))
            best = groups.get(key)
            # Coerced comparison: string throughputs ("0.9" vs "12.3")
            # must rank numerically, never lexically.
            if best is None or (_fnum(r, "throughput")
                                > _fnum(best, "throughput")):
                groups[key] = r
        out += ["## Mechanisms (peak-throughput point per "
                "workload × cc × granularity × backend × scan shape)", "",
                "B/txn and flop/txn are the analytic per-transaction "
                "roofline cost model (analysis/txn_cost.py) at the peak "
                "point's wave shape; roofline = fraction of the modeled "
                "chip's binding roof; abort causes sum exactly to the "
                "abort count (core/types.py ABORT_CAUSE taxonomy); "
                "launches/wave and DMA rows/wave are the fused probe "
                "chain's modeled launch count and touched-row visits, "
                "with the cut vs the unfused chain (probe-family "
                "mechanisms only).", ""]
        if port:
            out += ["The port's rows count its kernel launches a wave "
                    "(every backend call, the cost model's two "
                    "segment_count included) under launches/wave; their "
                    "waves/s is the point's synchronized wave loop on "
                    "its device.", ""]
        extra = ((" device |" if dev_col else "")
                 + (" waves/s |" if wps_col else ""))
        out += ["| workload | cc | granularity | backend | peak thpt "
                "(txn/us) | @lanes | abort rate | abort causes | scan "
                "| B/txn "
                "| flop/txn | roofline | launches/wave | DMA rows/wave "
                "| kernel ops |" + extra + " source |",
                "|---|---|---|---|---|---|---|---|---|---|---|---|---|"
                "---|---|---|" + "---|" * (dev_col + wps_col)]
        for key in sorted(groups, key=str):
            r = groups[key]
            out.append(
                f"| {key[0]} | {key[1]} | {_gran(key[2])} | {key[3]} "
                f"| {_fnum(r, 'throughput'):.3f} | {r.get('lanes', '?')} "
                f"| {100 * _fnum(r, 'abort_rate'):.2f}% "
                f"| {_causes_cell(r.get('abort_causes'))} "
                f"| {_scan_cell(r)} "
                f"| {_per_txn_cell(r, 'bytes_per_txn')} "
                f"| {_per_txn_cell(r, 'flops_per_txn')} "
                f"| {_roofline_cell(r)} "
                f"| {_per_txn_cell(r, 'launches_per_wave')} "
                f"| {_dma_rows_cell(r)} "
                f"| {_ops_cell(r.get('kernel_ops', {}))} "
                + _port_cells(r, dev_col, wps_col)
                + f"| {_src_of(r)} |")
        out.append("")

    open_rows = [r for r in mech_ok if r.get("open_loop")]
    if open_rows:
        groups = {}
        for r in open_rows:
            key = (r.get("workload", "?"), r.get("cc", "?"),
                   r.get("granularity", 1), r.get("backend", "?"),
                   _fnum(r, "max_extent", 1))
            best = groups.get(key)
            if best is None or (_fnum(r, "goodput")
                                > _fnum(best, "goodput")):
                groups[key] = r
        out += ["## Open-loop latency (peak-goodput point per "
                "workload × cc × granularity × backend)", "",
                "Goodput = unique committed txns per simulated us; "
                "time-to-commit percentiles are per txn class, in waves "
                "from first admission to commit (DESIGN.md section 11).",
                "",
                "| workload | cc | granularity | backend | goodput "
                "(txn/us) | p50 ttc (waves) | p99 ttc (waves) "
                "| inc drops | arrival drops | source |",
                "|---|---|---|---|---|---|---|---|---|---|"]
        for key in sorted(groups, key=str):
            r = groups[key]
            out.append(
                f"| {key[0]} | {key[1]} | {_gran(key[2])} | {key[3]} "
                f"| {_fnum(r, 'goodput'):.3f} "
                f"| {_ttc_cell(r.get('p50_ttc_waves'))} "
                f"| {_ttc_cell(r.get('p99_ttc_waves'))} "
                f"| {r.get('inc_drops', '?')} "
                f"| {r.get('arrival_drops', '?')} "
                f"| {_src_of(r)} |")
        out.append("")

    if dist_ok:
        # Dedupe: one row per CONFIG, last in file order wins (= the most
        # recent run's numbers).  The config key is everything that makes
        # a txn_scaling grid point distinct — mechanism, shard count,
        # pipeline depth, backend, plus the open-loop family's mode and
        # granularity; without mode/granularity in the key (and in the cc
        # cell below) the closed-loop row and both open-loop rows of one
        # (cc, shards, depth) rendered as three identical-looking stacked
        # rows.
        latest: dict = {}
        for r in dist_ok:
            key = (r.get("mode", ""), r.get("granularity"),
                   r.get("cc", "occ"), _fnum(r, "shards"),
                   _fnum(r, "pipeline_depth", 0), r.get("backend", "?"))
            latest[key] = r
        dist_rows = list(latest.values())
        ddev = _port_cols(dist_rows)[0]
        out += ["## Distributed engine (txn_scaling; shards=0 = local "
                "sweep() anchor)", "",
                "depth = software-pipeline depth of the scanned runner "
                "(1 = synchronous three-exchange wave, >= 2 = ONE fused "
                "all_to_all per wave); wire KiB/wave = modeled exchange "
                "payload per shard; verdict B/wave shows the bit-packed "
                "wire next to the retired 1-byte-per-op baseline; one row "
                "per config — cc × shards × depth × backend (× mode × "
                "granularity for the open-loop family, marked in the cc "
                "column) — latest run wins.", "",
                "| shards | cc | depth | waves/s | commits | ro commits "
                "| ro aborts | coll KiB/wave | wire KiB/wave | verdict "
                "B/wave (packed/legacy) | abort causes | backend "
                "| kernel ops |" + (" device |" if ddev else "")
                + " source |",
                "|---|---|---|---|---|---|---|---|---|---|---|---|---|"
                "---|" + ("---|" if ddev else "")]
        for r in sorted(dist_rows,
                        key=lambda r: (_src_of(r), r.get("cc", "occ"),
                                       r["shards"],
                                       _fnum(r, "pipeline_depth", 0))):
            depth = _coerce(r.get("pipeline_depth"))
            wire = _coerce(r.get("wire_bytes_per_wave"))
            vp = _coerce(r.get("verdict_bytes_per_wave"))
            vl = _coerce(r.get("verdict_bytes_per_wave_legacy"))
            cc_cell = r.get("cc", "occ")
            if r.get("mode") == "open_loop":
                cc_cell += f" open/{_gran(r.get('granularity', 1))}"
            out.append(
                f"| {r['shards']} | {cc_cell} "
                f"| {'—' if depth is None else f'{depth:g}'} "
                f"| {_fnum(r, 'waves_per_s'):.1f} "
                f"| {r.get('commits', '?')} "
                f"| {r.get('ro_commits', '?')} "
                f"| {r.get('ro_aborts', '?')} "
                f"| {_fnum(r, 'coll_bytes_per_wave') / 1024:.1f} "
                f"| {'—' if wire is None else f'{wire / 1024:.1f}'} "
                f"| {'—' if vp is None or vl is None else f'{vp:g} / {vl:g}'} "
                f"| {_causes_cell(r.get('abort_causes'))} "
                f"| {r.get('backend', '?')} "
                f"| {_ops_cell(r.get('kernel_ops', {}))} "
                + _port_cells(r, ddev, False) + f"| {_src_of(r)} |")
        out.append("")

    if skipped:
        out += [f"## Skipped rows ({len(skipped)})", "",
                "Malformed/partial rows found while aggregating — "
                "regenerate their source files:", ""]
        out += [f"- ⚠ `{src}`: {why}" for src, why in skipped]
        out.append("")

    if not mech_ok and not dist_ok and not skipped:
        out += ["No benchmark rows found — run `python -m "
                "repro_torch.launch.txn_bench --json BENCH_x.json` or any "
                "`repro_torch.benchmarks` figure script first.", ""]
    return "\n".join(out)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("patterns", nargs="*", default=list(DEFAULT_GLOBS),
                    help="JSON files or globs (default: BENCH_*.json "
                         "reports/*.json)")
    ap.add_argument("--out", default="reports/perf_dashboard.md")
    args = ap.parse_args(argv)
    mech, dist = load_rows(tuple(args.patterns))
    md = render_markdown(mech, dist)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        f.write(md)
    print(f"[saved] {args.out}  ({len(mech)} mechanism rows, "
          f"{len(dist)} distributed rows)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
