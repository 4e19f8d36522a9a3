"""Scan parity on TPC-C: every mechanism of the port with TPC-C's scan
classes against the JAX engine.

With ``scan_len`` 16, Order-status reads its order lines as one interval
of MAX_ITEMS records and a Stock-level type scans 16 consecutive stock
rows.  The JAX engine's own draws (scale 0.05, 16 lanes, 20 waves) are
replayed into the port's wave step (tests/port_harness.py) and held
against JAX ``run(..., keep_state=True)`` on ``backend="jnp"``: counters,
abort causes, claim, version and ring tables bit-identical, heats to rtol
1e-6, lane_time to rtol 1e-5.  OCC, TicToc and 2PL here; the other
mechanisms and the routes in test_torch_scan_tpcc_mechanisms.py.
"""
import pytest

from port_harness import assert_engine_parity, jax_draws
from repro.core import types as jt
from repro.workloads import TPCCWorkload

LANES, WAVES, SEED = 16, 20, 2
WL = TPCCWorkload.make(n_warehouses=8, scale=0.05, scan_len=16)

CONFIGS = [(jt.CC_OCC, 0), (jt.CC_OCC, 1), (jt.CC_TICTOC, 0),
           (jt.CC_TICTOC, 1), (jt.CC_2PL, 0)]


@pytest.fixture(scope="module")
def draws():
    return jax_draws(WL, LANES, WAVES, seed=SEED)


@pytest.mark.parametrize("cc,gran", CONFIGS, ids=[
    f"{jt.CC_NAMES[cc]}-{'fine' if g else 'coarse'}" for cc, g in CONFIGS])
def test_tpcc_scans_match_jax(draws, cc, gran):
    state = assert_engine_parity(WL, cc, gran, LANES, draws, seed=SEED)
    assert int(state.commits_by_type[3]) > 0       # Stock-level ran
    if cc == jt.CC_MVCC:
        assert int(state.abort_causes[jt.CAUSE_PHANTOM]) == 0
