"""Multi-version parity on TPC-C: MVCC and MV-OCC on the point mix (the
MV rows of benchmarks/abort_rates.py and fig3) against the JAX engine.

The JAX engine's own draws (scale 0.05, 16 lanes, 20 waves) are replayed
into the port's wave step (tests/port_harness.py) and held against JAX
``run`` on ``backend="jnp"``: counters, abort causes, claim tables and
the version ring bit-identical, lane_time to rtol 1e-5.  Payment's blind
ADDs go through the plain-write claim channel, on which ADD-ADD pairs
commute.
"""
import pytest

from port_harness import assert_engine_parity, jax_draws
from repro.core import types as jt
from repro.workloads import TPCCWorkload

LANES, WAVES, SEED = 16, 20, 5
WL = TPCCWorkload.make(n_warehouses=8, scale=0.05)


@pytest.fixture(scope="module")
def draws():
    return jax_draws(WL, LANES, WAVES, seed=SEED)


@pytest.mark.parametrize("cc,gran", [
    (jt.CC_MVCC, 0), (jt.CC_MVCC, 1), (jt.CC_MVOCC, 0), (jt.CC_MVOCC, 1),
], ids=["mvcc-coarse", "mvcc-fine", "mvocc-coarse", "mvocc-fine"])
def test_tpcc_mv_matches_jax(draws, cc, gran):
    state = assert_engine_parity(WL, cc, gran, LANES, draws, seed=SEED)
    assert int(state.ro_aborts) == 0
    assert int(state.abort_causes[jt.CAUSE_PHANTOM]) == 0
