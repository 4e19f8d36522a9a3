"""The port's observability (ROADMAP A.10) against the JAX package.

On replayed JAX draws (tests/port_harness.py; TPC-C scale 0.01, 16 lanes,
20 waves; JAX ``run`` takes the same draws through ``ReplayedWorkload``,
so its scan compiles without the generator) the port's per-wave timeline
(``engine.Timeline``) equals JAX ``run``'s ``per_wave_*`` series
(integers exactly, simulated µs to rtol 1e-5), and with
``track_conflicts`` its conflict histogram equals the JAX final state's
bit for bit, ``hot_records`` included, ties in order: the closed step
under OCC and TicToc at both granularities, the open step under OCC and
MVCC.  Tracking changes no other state field and adds one
``commit_install``, ``segment_count`` and ``ts_install_max`` call a wave.
The cost model (``analysis/txn_cost.py``) keeps the JAX formulas op by op
and its call tables equal the wrappers' counters; the Chrome-trace
exporter (``analysis/trace.py``) and the dashboard
(``benchmarks/perf_dashboard.py``) give the JAX twins' output on the same
input; the CLIs write traces and cost columns; the engine's named ranges
appear in a CPU profile.
"""
import dataclasses
import json
import types

import numpy as np
import pytest
import torch

import benchmarks.perf_dashboard as jax_dash
from port_harness import (ReplayedWorkload, initial_store, jax_config,
                          jax_draws, jax_open_draws, port_open_replay,
                          port_replay)
from repro.analysis import peaks as jax_peaks
from repro.analysis import trace as jax_trace
from repro.analysis import txn_cost as jax_cost
from repro.core import types as jt
from repro.core.engine import run as jax_run
from repro.workloads import TPCCWorkload
from repro_torch import kernels as K
from repro_torch.analysis import peaks
from repro_torch.analysis import trace as port_trace
from repro_torch.analysis import txn_cost as port_cost
from repro_torch.benchmarks import perf_dashboard as port_dash
from repro_torch.benchmarks import run as port_run
from repro_torch.core import convert
from repro_torch.core import engine as pe
from repro_torch.core import types as t
from repro_torch.launch import txn_bench

LANES, WAVES, RATE = 16, 20, 12.0
WL = TPCCWorkload.make(n_warehouses=8, scale=0.01)
CLOSED = [(jt.CC_OCC, 0), (jt.CC_OCC, 1), (jt.CC_TICTOC, 0),
          (jt.CC_TICTOC, 1)]
OPEN = [(jt.CC_OCC, 1), (jt.CC_MVCC, 0)]
CASES = [(cc, g, False) for cc, g in CLOSED] + [(cc, g, True)
                                                for cc, g in OPEN]
IDS = [f"{jt.CC_NAMES[cc]}-{'fine' if g else 'coarse'}"
       f"{'-open' if o else ''}" for cc, g, o in CASES]
OPEN_KW = dict(arrival_rate=RATE, queue_cap=4 * LANES, max_incarnations=2)


@pytest.fixture(scope="module")
def draws():
    return {False: jax_draws(WL, LANES, WAVES),
            True: jax_open_draws(WL, LANES, WAVES, RATE)}


def _jcfg(cc, gran, open_loop, **kw):
    return jax_config(WL, cc, gran, LANES, **(OPEN_KW if open_loop else {}),
                      **kw)


def _replay(jcfg, draws, open_loop, track):
    """The port on the JAX draws: (final state, timeline arrays)."""
    cfg = dataclasses.replace(
        convert.config_from_fields(dataclasses.asdict(jcfg)),
        track_conflicts=track)
    tl = pe.Timeline(WAVES, torch.zeros((), dtype=torch.int64))
    go = port_open_replay if open_loop else port_replay
    state = go(cfg, initial_store(WL, jcfg), draws[open_loop],
               timeline=tl)
    return state, tl.arrays()


@pytest.fixture(scope="module")
def runs(draws):
    """{case: (JAX tracked run, port tracked (state, arrays), port
    untracked (state, arrays))}."""
    out = {}
    for cc, g, o in CASES:
        jcfg = _jcfg(cc, g, o, track_conflicts=True)
        ref = jax_run(jcfg, ReplayedWorkload(WL, draws[o]), n_waves=WAVES,
                      seed=0, keep_state=True)
        out[(cc, g, o)] = (ref, _replay(jcfg, draws, o, True),
                           _replay(jcfg, draws, o, False))
    return out


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_per_wave_series_match_jax_run(runs, case):
    ref, (_, got), _ = runs[case]
    for k in ("per_wave_commits", "per_wave_aborts", "per_wave_causes"):
        np.testing.assert_array_equal(got[k], np.asarray(getattr(ref, k)),
                                      err_msg=k)
    np.testing.assert_allclose(got["per_wave_us"],
                               np.asarray(ref.per_wave_us), rtol=1e-5)
    assert int(got["per_wave_commits"].sum()) == ref.commits
    assert got["per_wave_causes"].sum(axis=0).tolist() == ref.abort_causes


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_conflict_tables_match_jax(runs, case):
    ref, (state, _), _ = runs[case]
    got = convert.conflicts_to_numpy(state)
    for k in convert.CONFLICT_TABLES:
        np.testing.assert_array_equal(
            got[k], np.asarray(getattr(ref.final_state, k)), err_msg=k)
    assert got["conflict_hits"].sum() > 0
    hot = pe.hot_records(state)
    assert hot == ref.hot_records
    # Ties come out in the JAX order: equal totals, cells descending.
    assert any(a[2] == b[2] for a, b in zip(hot, hot[1:]))


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_tracking_changes_nothing_else(runs, case):
    _, (on, on_rows), (off, off_rows) = runs[case]
    assert off.conflict_hits.shape == (1, 1)
    for f in dataclasses.fields(t.EngineState):
        if f.name in ("conflict_hits", "conflict_peak"):
            continue
        a, b = getattr(on, f.name), getattr(off, f.name)
        for x, y in zip(_leaves(a), _leaves(b)):
            assert torch.equal(x, y), f.name
    for k in on_rows:
        np.testing.assert_array_equal(on_rows[k], off_rows[k], err_msg=k)


def _leaves(x):
    if isinstance(x, torch.Tensor):
        return [x]
    if dataclasses.is_dataclass(x):
        return [y for f in dataclasses.fields(x)
                for y in _leaves(getattr(x, f.name))]
    return [] if x is None else [torch.as_tensor(x)]


def test_conflict_tables_convert_both_ways():
    rng = np.random.default_rng(5)
    arrays = {k: rng.integers(0, 1 << 32, (7, 2), dtype=np.uint64)
              .astype(np.uint32) for k in convert.CONFLICT_TABLES}
    state = types.SimpleNamespace(**convert.conflicts_from_numpy(arrays,
                                                                 "cpu"))
    back = convert.conflicts_to_numpy(state)
    for k in convert.CONFLICT_TABLES:
        assert getattr(state, k).dtype == torch.int32
        np.testing.assert_array_equal(back[k], arrays[k])


@pytest.mark.parametrize("cc", ["occ", "tictoc", "mvcc", "autogran"])
def test_tracking_adds_three_calls_a_wave(cc):
    wl = txn_bench.make_workload("tpcc", scale=0.01)
    calls = []
    for track in (False, True):
        cfg = dataclasses.replace(txn_bench.make_config(wl, cc, 1, LANES),
                                  track_conflicts=track)
        before = K.call_counts()
        res = pe.run(cfg, wl, 3, device="cpu")
        calls.append({op: n - before[op]
                      for op, n in K.call_counts().items()})
        assert (res.hot_records is not None) == track
    extra = {op: calls[1][op] - calls[0][op] for op in calls[0]}
    want = {"commit_install": 3, "segment_count": 3, "ts_install_max": 3}
    assert {op: n for op, n in extra.items() if n} == want


def test_run_keeps_the_timeline_and_sweep_on_request():
    wl = txn_bench.make_workload("ycsb", n_keys=2000)
    cfg = txn_bench.make_config(wl, "occ", 1, 8)
    res = pe.run(cfg, wl, 4, seed=2, device="cpu")
    assert res.per_wave_commits.shape == (4,)
    assert int(res.per_wave_commits.sum()) == res.commits
    assert int(res.per_wave_aborts.sum()) == res.aborts
    pts = pe.sweep(cfg, wl, 4, ccs=[t.CC_OCC], grans=(1,),
                   lane_counts=(4, 8), seeds=(2,), per_wave=True,
                   device="cpu")
    # The bucket maximum is run's point exactly, timeline included.
    for k in ("per_wave_commits", "per_wave_aborts", "per_wave_causes",
              "per_wave_us"):
        np.testing.assert_array_equal(getattr(pts[1], k), getattr(res, k))
    for p in pts:
        assert int(p.per_wave_commits.sum()) == p.commits
        assert int(p.per_wave_aborts.sum()) == p.aborts
        assert p.per_wave_causes.sum(axis=0).tolist() == p.abort_causes
        np.testing.assert_allclose(p.per_wave_us.sum() / p.lanes,
                                   p.sim_time_us, rtol=1e-5)
    plain = pe.sweep(cfg, wl, 4, ccs=[t.CC_OCC], grans=(1,),
                     lane_counts=(8,), seeds=(2,), device="cpu")
    assert plain[0].per_wave_commits is None


def test_open_sweep_timeline_sums_to_the_point():
    wl = txn_bench.make_workload("ycsb", n_keys=2000)
    cfg = txn_bench.make_config(wl, "mvcc", 0, 8, arrival_rate=5.0)
    (p,) = pe.sweep(cfg, wl, 5, ccs=[t.CC_MVCC], grans=(0,),
                    lane_counts=(8,), per_wave=True, device="cpu")
    assert int(p.per_wave_commits.sum()) == p.commits
    assert p.per_wave_causes.sum(axis=0).tolist() == p.abort_causes
    np.testing.assert_allclose(p.per_wave_us.sum() / 8, p.sim_time_us,
                               rtol=1e-5)


# ----------------------------------------------------------------- traces
def _points(runs):
    """JAX-run arrays as sweep points of both packages' shape."""
    out = []
    for (cc, g, _), (ref, _, _) in runs.items():
        out.append(types.SimpleNamespace(
            cc=cc, granularity=g, lanes=LANES,
            **{k: np.asarray(getattr(ref, k)) for k in (
                "per_wave_commits", "per_wave_aborts", "per_wave_causes",
                "per_wave_us")}))
    out.append(types.SimpleNamespace(cc=0, granularity=0, lanes=8,
                                     per_wave_commits=None))
    return out


def test_traces_equal_jax(runs):
    pts = _points(runs)
    assert port_trace.sweep_trace(pts) == jax_trace.sweep_trace(pts)
    label = lambda p: f"x{p.cc}"  # noqa: E731
    assert (port_trace.sweep_trace(pts, label)
            == jax_trace.sweep_trace(pts, label))
    p = pts[0]
    args = ("lbl", 3, p.per_wave_commits, p.per_wave_aborts,
            p.per_wave_us, p.per_wave_causes)
    assert port_trace.point_events(*args) == jax_trace.point_events(*args)
    assert (port_trace.point_events(*args[:5])
            == jax_trace.point_events(*args[:5]))
    assert port_trace.validate_chrome_trace(
        port_trace.sweep_trace(pts)) == []


def test_trace_meta_stays_off_the_time_axis(runs):
    pt = _points(runs)[0]
    pt.wall_s, pt.device = 0.25, "cuda:0"
    tr = port_trace.sweep_trace([pt])
    meta = tr["traceEvents"][0]
    assert meta["args"] == {"name": "occ/coarse/T16", "wall_s": 0.25,
                            "device": "cuda:0"}
    plain = jax_trace.sweep_trace([pt])
    assert tr["traceEvents"][1:] == plain["traceEvents"][1:]


BROKEN = [
    [],
    {"traceEvents": "x"},
    {"traceEvents": []},
    {"traceEvents": [1, {"ph": ""}, {"name": "a"}]},
    {"traceEvents": [{"ph": "X", "ts": "0", "dur": None, "pid": 1.5,
                      "tid": "t"}]},
    {"traceEvents": [{"ph": "M", "args": []}, {"ph": "C", "ts": None}]},
    {"traceEvents": [{"ph": "X", "name": "w", "ts": 0, "dur": 1,
                      "pid": 1, "tid": 0}]},
]


@pytest.mark.parametrize("doc", BROKEN, ids=range(len(BROKEN)))
def test_validator_rejects_what_jax_rejects(doc):
    assert (port_trace.validate_chrome_trace(doc)
            == jax_trace.validate_chrome_trace(doc))


def test_write_trace_refuses_an_invalid_trace(tmp_path):
    with pytest.raises(ValueError, match="invalid Chrome trace"):
        port_trace.write_trace(str(tmp_path / "x.json"), {"traceEvents": []})


# ------------------------------------------------------------- cost model
SHAPES = [port_cost.WaveShape(lanes=T, slots=K, n_groups=G, granularity=g,
                              mv_depth=D, n_shards=ns, route_cap=cap,
                              max_extent=ext, bucket_size=B)
          for T, K, G, g, D, ns, cap, ext, B in (
              (16, 64, 2, 0, 0, 1, 0, 1, 8), (128, 64, 2, 1, 4, 1, 0, 1, 8),
              (8, 16, 1, 1, 0, 4, 64, 8, 8), (96, 16, 3, 0, 2, 2, 512, 33, 4),
              (1, 1, 2, 1, 0, 1, 0, 200, 8), (128, 16, 2, 0, 4, 8, 2048, 64,
                                              16))]


@pytest.mark.parametrize("s", SHAPES, ids=range(len(SHAPES)))
def test_op_costs_equal_jax(s):
    js = jax_cost.WaveShape(**dataclasses.asdict(s))
    got, ref = port_cost.op_costs(s), jax_cost.op_costs(js)
    assert got.keys() == ref.keys()
    for op in ref:
        assert dataclasses.astuple(got[op]) == dataclasses.astuple(ref[op])
    assert (s.ops, s.cells, s.scan_span) == (js.ops, js.cells, js.scan_span)
    for cc in port_cost.PROBE_CHAIN_LAUNCHES:
        for fused in (True, False):
            assert (port_cost.probe_chain(cc, s, fused)
                    == jax_cost.probe_chain(cc, js, fused))


def test_work_tables_are_the_jax_ops_plus_the_cost_model():
    assert port_cost.DIST_WAVE_WORK == jax_cost.DIST_WAVE_OPS
    for cc, ops in jax_cost.WAVE_OPS.items():
        work = dict(port_cost.WAVE_WORK[cc])
        work["segment_count"] -= 2
        assert {k: v for k, v in work.items() if v} == ops, cc
    assert port_cost.PROBE_CHAIN_LAUNCHES == jax_cost.PROBE_CHAIN_LAUNCHES
    assert peaks.HW_PEAKS == jax_peaks.HW_PEAKS
    assert peaks.DEFAULT_CHIP == "gpu_h100"
    # The rollup is JAX's formula over the work table.
    s = SHAPES[3]
    for cc in port_cost.WAVE_WORK:
        costs = jax_cost.op_costs(jax_cost.WaveShape(**dataclasses.asdict(s)))
        work = port_cost.WAVE_WORK[cc]
        b = sum(costs[op].bytes_per_call * k for op, k in work.items())
        f = sum(costs[op].flops_per_call * k for op, k in work.items())
        got = port_cost.txn_cost(cc, s)
        assert got["bytes_per_txn"] == b / s.lanes
        assert got["flops_per_txn"] == f / s.lanes
        r = peaks.ridge("gpu_h100")
        assert got["roofline_frac"] == min(1.0, f / b / r)
        assert got["chip"] == "gpu_h100"
    point = port_cost.wave_cost("occ", SHAPES[0])
    assert "iterate_validate" not in point["ops"]
    assert point["launches_per_wave"] == 3


@pytest.mark.parametrize("scan_len", [0, 16], ids=["points", "scans"])
def test_wave_ops_equal_the_counters(scan_len):
    wl = txn_bench.make_workload("tpcc", scale=0.01, scan_len=scan_len)
    for cc in txn_bench.CCS:
        cfg = txn_bench.make_config(wl, cc, 1, LANES)
        gen = torch.Generator()
        gen.manual_seed(0)
        state = t.engine_state_init(cfg, wl.init_store("cpu", cfg.mv_depth))
        step = pe.make_wave_step(cfg)
        state, _ = pe.draw_wave(cfg, wl, state, step, gen)
        before = K.call_counts()
        pe.draw_wave(cfg, wl, state, step, gen)
        calls = {op: n - before[op] for op, n in K.call_counts().items()
                 if n > before[op]}
        s = port_cost.WaveShape(lanes=LANES, slots=wl.slots,
                                max_extent=wl.max_extent)
        assert calls == port_cost.wave_calls(cc, s), cc


@pytest.fixture(scope="module")
def shards():
    from repro_torch.launch.mesh import close_shards, init_shards
    sh = init_shards("cpu")
    yield sh
    close_shards(sh)


@pytest.mark.parametrize("scans", [False, True], ids=["points", "scans"])
def test_dist_wave_ops_equal_the_counters(shards, scans):
    from repro_torch.core import distributed as D
    N, T, Kk = 96, 8, 4
    rng = np.random.default_rng(3)
    for cc in ("occ", "mvcc", "mvocc"):
        cfg = D.DistConfig(n_records=N, n_groups=2, lanes_per_shard=T,
                           slots=Kk, granularity=1, cc=cc,
                           mv_depth=0 if cc == "occ" else 4,
                           max_extent=8 if scans else 1)
        keys = torch.from_numpy(rng.integers(0, N, (T, Kk)).astype(np.int32))
        kinds = torch.from_numpy(rng.choice(
            [t.READ, t.WRITE], (T, Kk)).astype(np.int32))
        if scans:
            kinds = torch.where(kinds == t.READ, kinds | (4 << 2), kinds)
        groups = torch.zeros_like(keys)
        prio = torch.randperm(T).to(torch.int32)
        tables = D.init_tables(cfg, None, "cpu")
        wave = D.make_wave_fn(cfg)
        before = K.call_counts()
        wave(keys, groups, kinds, prio, tables, 0)
        calls = {op: n - before[op] for op, n in K.call_counts().items()
                 if n > before[op]}
        s = port_cost.WaveShape(lanes=T, slots=Kk, max_extent=cfg.max_extent)
        assert calls == port_cost.wave_calls(cc, s, distributed=True), cc


# --------------------------------------------------------- CLIs, dashboard
def test_txn_bench_writes_trace_and_cost_columns(tmp_path, monkeypatch):
    slots = txn_bench.make_workload("tpcc", scale=0.01).slots
    trace = tmp_path / "t.json"
    rows = txn_bench.main(["--workload", "tpcc", "--scale", "0.01", "--cc",
                           "occ", "mvcc", "--lanes", "8", "--waves", "3",
                           "--device", "cpu", "--trace", str(trace)])
    doc = json.loads(trace.read_text())
    assert port_trace.validate_chrome_trace(doc) == []
    names = [e for e in doc["traceEvents"] if e["name"] == "process_name"]
    assert [e["args"]["name"] for e in names] == [
        "occ/coarse/T8", "mvcc/coarse/T8", "occ/fine/T8", "mvcc/fine/T8"]
    assert all(e["args"]["device"] == "cpu" and e["args"]["wall_s"] > 0
               for e in names)
    waves = [e for e in doc["traceEvents"] if e["ph"] == "X"]
    assert len(waves) == 4 * 3
    for r in rows:
        s = port_cost.WaveShape(lanes=8, slots=slots,
                                granularity=r["granularity"],
                                mv_depth=4 if r["cc"] == "mvcc" else 0)
        cost = port_cost.txn_cost(r["cc"], s)
        assert r["bytes_per_txn"] == round(cost["bytes_per_txn"], 1)
        assert r["roofline_chip"] == "gpu_h100"
        assert r["launches_per_wave"] == (3 if r["cc"] == "occ" else 4)
        assert ("dma_rows_per_wave" in r) == (r["cc"] == "occ")
    env = tmp_path / "env.json"
    monkeypatch.setenv("REPRO_TRACE", str(env))
    txn_bench.main(["--workload", "ycsb", "--n-keys", "2000", "--cc", "occ",
                    "--granularity", "fine", "--lanes", "8", "--waves", "2",
                    "--device", "cpu"])
    assert port_trace.validate_chrome_trace(json.loads(env.read_text())) \
        == []


def _jax_shaped_rows():
    """Rows with only the JAX package's keys: mechanism rows (pallas and
    xla attribution, scans, open loop, string numbers, a malformed row)
    and txn_scaling rows."""
    mech = [
        {"workload": "tpcc", "cc": "occ", "granularity": 1, "lanes": 64,
         "throughput": 3.5, "abort_rate": 0.1, "backend": "pallas",
         "abort_causes": {"read_val": 4, "ww": 0}, "bytes_per_txn": 512.0,
         "flops_per_txn": 1e4, "roofline_frac": 0.01,
         "roofline_bound": "memory", "launches_per_wave": 1,
         "dma_rows_per_wave": 1024, "dma_rows_per_wave_unfused": 3072,
         "kernel_ops": {"wave_commit": "pallas", "segment_count": "pallas"},
         "max_extent": 1},
        {"workload": "tpcc", "cc": "occ", "granularity": 1, "lanes": 128,
         "throughput": "12.3", "abort_rate": 0.2, "backend": "pallas",
         "kernel_ops": {"wave_commit": "pallas"}},
        {"workload": "ycsb", "cc": "mvcc", "granularity": 0, "lanes": 16,
         "throughput": 0.9, "abort_rate": 0.0, "backend": "jnp",
         "kernel_ops": {"validate": "xla", "mv_install": "pallas"},
         "max_extent": 16, "scan_frac": 0.5, "scan_len": 16,
         "open_loop": True, "goodput": 0.8, "p50_ttc_waves": [1, 2],
         "p99_ttc_waves": [3, 4], "inc_drops": 0, "arrival_drops": 2},
        {"workload": "ycsb", "cc": "tictoc", "granularity": 0,
         "throughput": None},
    ]
    dist = [
        {"shards": 0, "cc": "occ", "commits": 10, "waves_per_s": 5.0,
         "coll_bytes_per_wave": 0, "abort_causes": [0, 0, 0, 0, 0, 3, 0],
         "backend": "jnp", "kernel_ops": {"route_pack": "xla"}},
        {"shards": 2, "cc": "mvcc", "pipeline_depth": 1, "commits": 9,
         "waves_per_s": 4.0, "coll_bytes_per_wave": 4096,
         "wire_bytes_per_wave": 2048, "verdict_bytes_per_wave": 64,
         "verdict_bytes_per_wave_legacy": 256, "backend": "pallas",
         "mode": "open_loop", "granularity": 0},
        {"shards": "x"},
    ]
    return mech, dist


def test_dashboard_renders_jax_rows_as_jax_does(tmp_path):
    mech, dist = _jax_shaped_rows()
    for m, d in ((mech, dist), (mech, []), ([], dist), (mech[:1], [])):
        assert (port_dash.render_markdown(m, d)
                == jax_dash.render_markdown(m, d))
    path = tmp_path / "BENCH_rows.json"
    path.write_text(json.dumps(mech + dist))
    pat = (str(tmp_path / "*.json"),)
    assert port_dash.load_rows(pat) == jax_dash.load_rows(pat)


def test_dashboard_adds_the_port_columns(tmp_path):
    rows = txn_bench.run_grid("ycsb", ["occ", "mvcc"], (1,), [8], 2,
                              n_keys=2000, device="cpu")
    md = port_dash.render_markdown(rows, [])
    assert "| kernel ops | device | waves/s | source |" in md
    assert "repro_torch.benchmarks.perf_dashboard" in md
    assert "| torch, 2 not run | cpu |" in md
    assert "gpu_h100" not in md and "(memory)" in md
    assert port_dash._ops_cell({"a": "cuda", "b": "cuda",
                                "c": "not_run"}) == "2/2 cuda, 1 not run"
    out = tmp_path / "dash.md"
    (tmp_path / "BENCH_x.json").write_text(json.dumps(rows))
    assert port_dash.main([str(tmp_path / "BENCH_*.json"), "--out",
                           str(out)]) == 0
    text = out.read_text()
    assert "| cpu | " in text and "| BENCH_x.json |" in text


def test_run_aggregates_the_five_entries(monkeypatch, capsys):
    from repro_torch.benchmarks import (abort_rates, auto_granularity,
                                        fig2_ycsb, fig3_tpcc, open_loop)
    seen = []

    def fake(name, rows):
        def main(argv):
            seen.append((name, argv))
            return rows
        return main
    r3 = [{"cc": "occ", "granularity": 1, "lanes": 128, "throughput": 3.0},
          {"cc": "tictoc", "granularity": 1, "lanes": 128,
           "throughput": 2.0}]
    for mod, rows in ((fig2_ycsb, []), (fig3_tpcc, r3), (abort_rates, []),
                      (auto_granularity, []),
                      (open_loop, [{"goodput": 1.5}, {"goodput": 2.25}])):
        monkeypatch.setattr(mod, "main", fake(mod.__name__, rows))
    assert port_run.main(["--device", "cpu", "--waves", "7", "--full"]) \
        == 0
    out = capsys.readouterr().out
    assert "fig3_tpcc" in out and "OCCfine/TicTocfine@128=1.50x" in out
    assert "peak goodput=2.25 txn/us" in out
    common = ["--waves", "7", "--device", "cpu"]
    assert [a for _, a in seen] == [common + ["--full"], common,
                                    common + ["--full"], common, common]


# ----------------------------------------------------------- named ranges
def _ranges(fn):
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
    return {e.name for e in prof.events() if e.name.startswith("repro:")}


@pytest.mark.parametrize("cc,fuse,scan_len,want", [
    ("occ", True, 0, {"validate", "cost", "wave_commit"}),
    ("occ", True, 16, {"validate", "cost", "wave_commit",
                       "iterate_validate"}),
    ("2pl", False, 0, {"validate", "cost", "claim", "install"}),
    ("autogran", True, 0, {"validate", "cost", "install"}),
    ("mvcc", True, 0, {"validate", "cost", "mv_install"}),
], ids=["occ", "occ-scans", "2pl-unfused", "autogran", "mvcc"])
def test_named_ranges_in_a_profile(cc, fuse, scan_len, want):
    wl = txn_bench.make_workload("tpcc", scale=0.01, scan_len=scan_len)
    cfg = txn_bench.make_config(wl, cc, 1, 8, fuse)
    got = _ranges(lambda: pe.run(cfg, wl, 1, device="cpu"))
    assert got == {"repro:" + n for n in want}
    from repro_torch.core.ranges import named_range
    assert type(named_range("x")).__name__ == "nullcontext"


def test_named_ranges_of_the_sharded_wave(shards):
    from repro_torch.core import distributed as D
    cfg = D.DistConfig(n_records=64, n_groups=2, lanes_per_shard=4, slots=2)
    wave = D.make_wave_fn(cfg)
    tables = D.init_tables(cfg, None, "cpu")
    keys = torch.arange(8, dtype=torch.int32).view(4, 2)
    args = (keys, torch.zeros_like(keys), torch.full_like(keys, t.WRITE),
            torch.arange(4, dtype=torch.int32), tables, 0)
    got = _ranges(lambda: wave(*args))
    assert got >= {"repro:route", "repro:claim", "repro:commit",
                   "repro:install"}
