"""Multi-version parity on YCSB: MVCC and MV-OCC in the port's wave engine
against the JAX engine, on the write-heavy mix with read-only clients of
benchmarks/abort_rates.py.

The JAX engine's own draws (YCSB with 2,000 keys, theta 0.9, 80% writes,
20% read-only transactions; 16 lanes, 20 waves) are replayed into the
port's wave step (tests/port_harness.py) and held against JAX ``run`` on
``backend="jnp"``: counters (``ro_commits``/``ro_aborts`` included),
abort causes, claim tables and the version ring (``mv_begin``,
``mv_head``) bit-identical, lane_time to rtol 1e-5.  Snapshot readers
never abort, where coarse OCC aborts them; snapshots aged past the ring's
depth abort as ``stale_snapshot``.
"""
import pytest

from port_harness import assert_engine_parity, jax_draws
from repro.core import types as jt
from repro.workloads import YCSBWorkload

LANES, WAVES, SEED = 16, 20, 4
WL = YCSBWorkload.make(n_keys=2000, theta=0.9, write_frac=0.8, ro_frac=0.2)


@pytest.fixture(scope="module")
def draws():
    return jax_draws(WL, LANES, WAVES, seed=SEED)


@pytest.mark.parametrize("cc,gran", [
    (jt.CC_MVCC, 0), (jt.CC_MVCC, 1), (jt.CC_MVOCC, 0), (jt.CC_MVOCC, 1),
], ids=["mvcc-coarse", "mvcc-fine", "mvocc-coarse", "mvocc-fine"])
def test_ycsb_mv_matches_jax(draws, cc, gran):
    state = assert_engine_parity(WL, cc, gran, LANES, draws, seed=SEED)
    assert int(state.ro_commits) > 0 and int(state.ro_aborts) == 0
    # Every written record advanced its ring head at least once.
    assert int((state.store.mv_head != 0).sum()) > 0


def test_ycsb_occ_aborts_read_only_lanes(draws):
    state = assert_engine_parity(WL, jt.CC_OCC, 0, LANES, draws, seed=SEED)
    assert int(state.ro_aborts) > 0


def test_ycsb_aged_snapshots_abort_stale(draws):
    """Snapshots 8 waves old outrun a ring of depth 4."""
    state = assert_engine_parity(WL, jt.CC_MVCC, 1, LANES, draws, seed=SEED,
                                 snapshot_age=8)
    assert int(state.abort_causes[jt.CAUSE_STALE_SNAPSHOT]) > 0
