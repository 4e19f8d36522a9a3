"""The port's grid runner (core/engine.py ``sweep``) against the JAX sweep.

The JAX sweep pads every grid point to its lane bucket's widest lane
count and masks the padding lanes (``make_wave_step``'s ``active``); a
point below its bucket maximum runs on draws of the padded width.  Here
a small YCSB grid (2,000 keys; OCC, TicToc and MV-OCC x coarse and fine;
lane counts 8 and 16, one bucket, so 8 runs padded to 16; 6 waves) runs
through JAX ``sweep``, and each point is replayed through the port's
masked wave step from the JAX draws of 16 lanes (tests/port_harness.py).
Commits, aborts, read-only counts, rts extensions and abort causes must be
exact, throughput within rtol 1e-5 (float32 lane times summed in another
order).  The port's own ``sweep`` is held to its own ``run`` at a bucket
maximum, exactly, and to the JAX grid order.
"""
import dataclasses

import numpy as np
import pytest
import torch

from port_harness import initial_store, jax_config, jax_draws, port_replay
from repro.core import types as jt
from repro.core.engine import lane_buckets as jax_lane_buckets
from repro.core.engine import sweep as jax_sweep
from repro.workloads import YCSBWorkload
from repro_torch.core import convert
from repro_torch.core import engine as pe
from repro_torch.launch.txn_bench import make_config, make_workload

WL = YCSBWorkload.make(n_keys=2000)
CCS = (jt.CC_OCC, jt.CC_TICTOC, jt.CC_MVOCC)
LANES, WAVES = (8, 16), 6


@pytest.mark.parametrize("lanes,ratio", [
    ((16, 64, 128), 2.0), ((8, 16, 32, 64, 96, 128), 2.0), ((16, 128), 8.0),
    ((16, 64, 128), None), ((128, 16, 64), 2.0), ((64, 96, 128), 2.0),
    ((8, 8, 12, 40), 1.5), ((5,), None),
])
def test_lane_buckets_match_jax(lanes, ratio):
    assert pe.lane_buckets(lanes, ratio) == jax_lane_buckets(lanes, ratio)


@pytest.fixture(scope="module")
def jax_points():
    base = jax_config(WL, jt.CC_OCC, 0, max(LANES), mv_depth=4)
    pts = jax_sweep(base, WL, WAVES, ccs=list(CCS), grans=(0, 1),
                    lane_counts=LANES, seeds=(0,))
    return {(p.cc, p.granularity, p.lanes): p for p in pts}, \
        [(p.cc, p.granularity, p.lanes) for p in pts]


@pytest.fixture(scope="module")
def draws():
    return jax_draws(WL, max(LANES), WAVES, seed=0)


@pytest.mark.parametrize("T", LANES)
@pytest.mark.parametrize("gran", [0, 1], ids=["coarse", "fine"])
@pytest.mark.parametrize("cc", CCS, ids=["occ", "tictoc", "mvocc"])
def test_sweep_point_matches_jax(jax_points, draws, cc, gran, T):
    want = jax_points[0][(cc, gran, T)]
    T_pad = max(LANES)
    jcfg = jax_config(WL, cc, gran, T_pad, mv_depth=4)
    cfg = convert.config_from_fields(dataclasses.asdict(jcfg))
    active = None if T == T_pad else torch.arange(T_pad) < T
    state = port_replay(cfg, initial_store(WL, jcfg), draws, active=active)
    assert int(state.commits) == want.commits
    assert int(state.aborts) == want.aborts
    assert want.commits + want.aborts == T * WAVES
    assert (int(state.ro_commits), int(state.ro_aborts)) == (
        want.ro_commits, want.ro_aborts)
    assert int(state.ext_events) == want.ext_events
    assert [int(x) for x in state.abort_causes] == want.abort_causes
    sim_us = float(state.lane_time.sum()) / T
    np.testing.assert_allclose(int(state.commits) / sim_us, want.throughput,
                               rtol=1e-5)
    if active is not None:
        assert float(state.lane_time[T:].abs().sum()) == 0.0
        assert not bool(state.pending_live[T:].any())


def test_port_sweep_keeps_the_jax_grid_order(jax_points):
    wl = make_workload("ycsb", n_keys=2000)
    base = make_config(wl, "mvocc", 0, max(LANES))
    pts = pe.sweep(base, wl, 2, ccs=list(CCS), grans=(0, 1),
                   lane_counts=LANES, seeds=(0,), device="cpu")
    assert [(p.cc, p.granularity, p.lanes) for p in pts] == jax_points[1]
    for p in pts:
        assert p.commits + p.aborts == p.lanes * 2
        assert p.lanes_run == max(LANES) and p.wall_s > 0
        assert sum(p.abort_causes) == p.aborts
        assert p.kernel_calls["segment_count"] >= 2 * 2
        assert sum(p.kernel_launches.values()) == 0


@pytest.mark.parametrize("cc", ["occ", "tictoc", "mvcc"])
def test_port_sweep_matches_run_at_bucket_max(cc):
    wl = make_workload("ycsb", n_keys=2000)
    base = make_config(wl, cc, 0, 16)
    pts = pe.sweep(base, wl, 5, ccs=[base.cc], grans=(1,),
                   lane_counts=(4, 16), seeds=(3,), lane_bucket_ratio=None,
                   device="cpu")
    ref = pe.run(dataclasses.replace(base, granularity=1), wl, 5, seed=3,
                 device="cpu")
    p4, p16 = pts
    assert (p4.lanes, p4.lanes_run, p16.lanes) == (4, 16, 16)
    for f in ("commits", "aborts", "abort_causes", "throughput",
              "sim_time_us", "ext_events", "ro_commits", "ro_aborts"):
        assert getattr(p16, f) == getattr(ref, f), f
    assert p4.commits + p4.aborts == 4 * 5


def test_sweep_per_wave_waits_for_observability():
    """The per-wave timeline (ROADMAP A.10, ported): each point's rows
    sum to its totals, the padded point's too."""
    wl = make_workload("ycsb", n_keys=2000)
    pts = pe.sweep(make_config(wl, "occ", 0, 8), wl, 3, ccs=[0],
                   grans=(0,), lane_counts=(4, 8), per_wave=True,
                   device="cpu")
    for p in pts:
        assert p.per_wave_commits.shape == (3,)
        assert int(p.per_wave_commits.sum()) == p.commits
        assert int(p.per_wave_aborts.sum()) == p.aborts
        assert p.per_wave_causes.sum(axis=0).tolist() == p.abort_causes
        np.testing.assert_allclose(p.per_wave_us.sum() / p.lanes,
                                   p.sim_time_us, rtol=1e-5)
