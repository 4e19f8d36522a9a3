"""The port's open loop (core/admission.py, engine.make_open_wave_step,
workloads/arrivals.py) against the JAX package.

- ``enqueue``/``dequeue`` on random queues against JAX's: FIFO order,
  overflow counts and every ring entry bit-identical.
- The open-loop wave step replayed from the JAX scan's own draws
  (tests/port_harness.py ``jax_open_draws``: the four-way key split and
  ``poisson_offered``) against JAX ``run`` with ``arrival_rate > 0``: OCC
  and MVCC at both granularities, 8 lanes, a queue of 32, 10 waves; every
  counter, the time-to-commit histogram and the final queue exact,
  throughput within rtol 1e-5 (float32 lane times summed in another
  order).
- The open step padded as the sweep runner pads a point (4 live lanes of
  8) against JAX ``sweep``'s open-loop point, and the port's own
  ``sweep`` in the open loop.
- The conservation oracle of tests/test_open_loop.py on the port's own
  ``run(trace=True)``: every admitted transaction is committed exactly
  once, still queued, or dropped at the incarnation cap.
- ``max_incarnations=0`` drops every abort.
- ``txn_bench.make_config`` gives an open-loop run a queue of 4x the
  lanes and 8 incarnations unless told otherwise.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from port_harness import initial_store, jax_open_draws, port_open_replay
from repro.core import admission as jadm
from repro.core import types as jt
from repro.core.engine import run as jax_run
from repro.core.engine import sweep as jax_sweep
from repro.workloads import YCSBWorkload
from repro_torch.core import admission as padm
from repro_torch.core import convert
from repro_torch.core import engine as pe
from repro_torch.core import types as pt
from repro_torch.launch.txn_bench import make_config, make_workload
from repro_torch.workloads.arrivals import PoissonArrivals, poisson_offered
from test_open_loop import _replay_oracle

WL = YCSBWorkload.make(n_keys=64, theta=0.9)
LANES, CAP, WAVES, RATE = 8, 32, 10, 6.0
QUEUE_COLS = ("op_key", "op_group", "op_col", "op_kind", "op_val",
              "txn_type", "n_ops", "op_extent", "admit_wave",
              "incarnation", "txn_id", "head", "size")


def _jcfg(cc, gran, max_inc=2):
    return jt.EngineConfig(
        cc=cc, lanes=LANES, slots=WL.slots, n_records=WL.n_records,
        n_groups=WL.n_groups, n_cols=WL.n_cols, n_txn_types=WL.n_txn_types,
        granularity=gran, n_rings=WL.n_rings,
        mv_depth=3 if cc in jt.MV_CCS else 0, arrival_rate=RATE,
        queue_cap=CAP, max_incarnations=max_inc, lat_bins=16)


def _assert_queue(port_q, jax_q):
    for name in QUEUE_COLS:
        np.testing.assert_array_equal(
            getattr(port_q, name).cpu().numpy(),
            np.asarray(getattr(jax_q, name)), err_msg=name)


def _batch(rng, T, K):
    fields = dict(
        op_key=rng.integers(-1, 100, (T, K)).astype(np.int32),
        op_group=rng.integers(0, 2, (T, K)).astype(np.int32),
        op_col=rng.integers(0, 10, (T, K)).astype(np.int32),
        op_kind=rng.integers(0, 4, (T, K)).astype(np.int32),
        op_val=rng.standard_normal((T, K)).astype(np.float32),
        txn_type=rng.integers(0, 3, (T,)).astype(np.int32),
        n_ops=rng.integers(0, K + 1, (T,)).astype(np.int32),
        op_extent=rng.integers(1, 5, (T, K)).astype(np.int32))
    return (convert.batch_from_numpy(fields, "cpu"),
            jt.TxnBatch(**{k: jnp.asarray(v) for k, v in fields.items()}))


@pytest.mark.parametrize("seed", range(4))
def test_queue_matches_jax_on_random_traffic(seed):
    """Interleaved enqueues (arrival and retry metadata) and dequeues
    (full and live-prefix) that wrap the ring and overflow it."""
    rng = np.random.default_rng(seed)
    cap, T, K = 12, 8, 3
    pq, jq = padm.queue_init(cap, K, "cpu"), jadm.queue_init(cap, K)
    for step in range(16):
        if rng.random() < 0.6:
            pb, jb = _batch(rng, T, K)
            meta = [rng.integers(0, 50, T).astype(np.int32)
                    for _ in range(3)]
            mask = rng.random(T) < rng.random()
            pq, pa, po = padm.enqueue(
                pq, pb, *(torch.from_numpy(m) for m in meta),
                torch.from_numpy(mask))
            jq, ja, jo = jadm.enqueue(jq, jb, *(jnp.asarray(m)
                                                for m in meta),
                                      jnp.asarray(mask))
            assert (int(pa), int(po)) == (int(ja), int(jo)), step
        else:
            n_act = int(rng.integers(0, T + 1))
            pq, pbat, *pmeta = padm.dequeue(pq, T, n_act)
            jq, jbat, *jmeta = jadm.dequeue(jq, T, n_act)
            for f in dataclasses.fields(pt.TxnBatch):
                np.testing.assert_array_equal(
                    getattr(pbat, f.name).numpy(),
                    np.asarray(getattr(jbat, f.name)), err_msg=f.name)
            for a, b in zip(pmeta, jmeta):
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        _assert_queue(pq, jq)
        assert 0 <= int(pq.size) <= cap


def test_histogram_helpers_match_jax():
    rng = np.random.default_rng(1)
    ttc = rng.integers(0, 40, 32).astype(np.int32)
    commit = rng.random(32) < 0.6
    ttype = rng.integers(0, 3, 32).astype(np.int32)
    pol = padm.open_loop_init(4, 2, 3, 16, "cpu")
    jol = jadm.open_loop_init(4, 2, 3, 16)
    pol = padm.record_commits(pol, torch.from_numpy(ttype),
                              torch.from_numpy(ttc), torch.from_numpy(commit))
    jol = jadm.record_commits(jol, jnp.asarray(ttype), jnp.asarray(ttc),
                              jnp.asarray(commit))
    np.testing.assert_array_equal(pol.lat_hist.numpy(),
                                  np.asarray(jol.lat_hist))
    assert padm.ttc_percentiles(pol.lat_hist) == jadm.ttc_percentiles(
        jol.lat_hist)
    h = padm.record_ttc(torch.zeros(16, dtype=torch.int64),
                        torch.from_numpy(ttc), torch.from_numpy(commit))
    np.testing.assert_array_equal(h.numpy(), np.asarray(jadm.record_ttc(
        jnp.zeros(16, jnp.int32), jnp.asarray(ttc), jnp.asarray(commit))))


def test_arrival_streams():
    g = torch.Generator()
    g.manual_seed(0)
    draws = [int(poisson_offered(g, 6.0, 8)) for _ in range(400)]
    assert max(draws) <= 8 and 5.0 < np.mean(draws) < 6.5
    arr = PoissonArrivals(rate=3.0, seed=2)
    np.testing.assert_array_equal(arr.counts(20, 4), np.minimum(
        np.random.default_rng(2).poisson(3.0, 20), 4))
    assert arr.shard_counts(5, 4, 2).shape == (5, 4)


@pytest.mark.parametrize("gran", [0, 1], ids=["coarse", "fine"])
@pytest.mark.parametrize("cc", [jt.CC_OCC, jt.CC_MVCC], ids=["occ", "mvcc"])
def test_open_step_matches_jax_run(cc, gran):
    jcfg = _jcfg(cc, gran)
    ref = jax_run(jcfg, WL, n_waves=WAVES, seed=0, keep_state=True)
    cfg = convert.config_from_fields(dataclasses.asdict(jcfg))
    draws = jax_open_draws(WL, LANES, WAVES, RATE, seed=0)
    state = port_open_replay(cfg, initial_store(WL, jcfg), draws)
    res = pe.summarize(cfg, state, WAVES)
    for f in ("commits", "aborts", "ro_commits", "ro_aborts",
              "abort_causes", "commits_by_type", "ext_events", "offered",
              "admitted", "arrival_drops", "inc_drops", "reenq_drops",
              "queued_final", "p50_ttc", "p99_ttc"):
        assert getattr(res, f) == getattr(ref, f), f
    assert ref.commits > 0 and ref.aborts > 0 and ref.offered > 0
    np.testing.assert_array_equal(res.lat_hist, np.asarray(ref.lat_hist))
    _assert_queue(state.ol.queue, ref.final_state.ol.queue)
    assert int(state.ol.next_id) == int(ref.final_state.ol.next_id)
    np.testing.assert_allclose(res.goodput, ref.goodput, rtol=1e-5)
    np.testing.assert_allclose(state.lane_time.numpy(),
                               np.asarray(ref.final_state.lane_time),
                               rtol=1e-5)


@pytest.mark.parametrize("cc", [jt.CC_OCC, jt.CC_MVCC], ids=["occ", "mvcc"])
def test_padded_open_step_matches_jax_sweep(cc):
    jcfg = _jcfg(cc, 1)
    pts = jax_sweep(jcfg, WL, WAVES, ccs=[cc], grans=(1,),
                    lane_counts=(4, LANES), seeds=(0,))
    draws = jax_open_draws(WL, LANES, WAVES, RATE, seed=0)
    cfg = convert.config_from_fields(dataclasses.asdict(jcfg))
    for p in pts:
        active = None if p.lanes == LANES else torch.arange(LANES) < p.lanes
        state = port_open_replay(cfg, initial_store(WL, jcfg), draws,
                                 active=active)
        ol = state.ol
        got = (int(state.commits), int(state.aborts), int(ol.offered),
               int(ol.admitted), int(ol.arrival_drops), int(ol.inc_drops),
               int(ol.queue.size), [int(x) for x in state.abort_causes])
        assert got == (p.commits, p.aborts, p.offered, p.admitted,
                       p.arrival_drops, p.inc_drops, p.queued_final,
                       p.abort_causes), p.lanes
        assert padm.ttc_percentiles(ol.lat_hist) == [p.p50_ttc, p.p99_ttc]
        np.testing.assert_allclose(
            int(state.commits) / (float(state.lane_time.sum()) / p.lanes),
            p.goodput, rtol=1e-5)


def test_port_open_sweep_keeps_the_identities():
    wl = make_workload("ycsb", n_keys=64)
    base = make_config(wl, "mvcc", 0, LANES, mv_depth=3, arrival_rate=6.0,
                       queue_cap=CAP, max_incarnations=2)
    pts = pe.sweep(base, wl, 8, ccs=[pt.CC_OCC, pt.CC_MVCC],
                   lane_counts=(4, LANES), device="cpu")
    assert len(pts) == 8
    for p in pts:
        assert p.open_loop and p.reenq_drops == 0
        assert p.admitted == p.commits + p.queued_final + p.inc_drops
        assert p.offered == p.admitted + p.arrival_drops
        assert p.offered <= 8 * p.lanes


@pytest.mark.parametrize("gran", [0, 1], ids=["coarse", "fine"])
@pytest.mark.parametrize("cc", ["occ", "tictoc", "mvcc"])
def test_conservation_oracle_on_the_port(cc, gran):
    """The JAX package's oracle, on the port's own draws: the trace
    reconciles exactly with the run's counters."""
    wl = make_workload("ycsb", n_keys=64)
    cfg = dataclasses.replace(
        make_config(wl, cc, gran, LANES, mv_depth=3, arrival_rate=8.0,
                    queue_cap=CAP, max_incarnations=2), lat_bins=16)
    res = pe.run(cfg, wl, 25, seed=3, device="cpu", trace=True)
    committed, dropped = _replay_oracle(res, 2)
    assert res.commits == len(committed)
    assert res.inc_drops == len(dropped)
    assert res.admitted == res.commits + res.queued_final + res.inc_drops
    assert res.offered == res.admitted + res.arrival_drops
    assert res.reenq_drops == 0
    assert res.abort_causes[pt.CAUSE_INC_CAP] == res.inc_drops
    assert sum(res.abort_causes) == res.aborts
    assert res.commits > 0 and res.aborts > 0 and res.inc_drops > 0
    assert int(res.lat_hist.sum()) == res.commits


def test_zero_incarnations_drop_every_abort():
    wl = make_workload("ycsb", n_keys=64)
    cfg = make_config(wl, "occ", 0, LANES, arrival_rate=8.0, queue_cap=CAP,
                      max_incarnations=0)
    res = pe.run(cfg, wl, 15, seed=1, device="cpu", trace=True)
    assert res.aborts > 0 and res.inc_drops == res.aborts
    assert res.abort_causes[pt.CAUSE_INC_CAP] == res.aborts
    incarn, got = res.trace[1], res.trace[2]
    assert (incarn[got] == 0).all()
    assert res.admitted == res.commits + res.queued_final + res.inc_drops


@pytest.mark.parametrize("kw, want", [
    (dict(), (0, 0)),
    (dict(arrival_rate=8.0), (4 * LANES, 8)),
    (dict(arrival_rate=8.0, queue_cap=CAP, max_incarnations=0), (CAP, 0)),
])
def test_make_config_fills_the_open_loop_defaults(kw, want):
    cfg = make_config(make_workload("ycsb", n_keys=64), "occ", 0, LANES,
                      **kw)
    assert (cfg.queue_cap, cfg.max_incarnations) == want
