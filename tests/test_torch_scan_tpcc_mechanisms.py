"""Scan parity on TPC-C, second half: SwissTM, Adaptive, AutoGran, MVCC
and MV-OCC with TPC-C's scan classes against the JAX engine, and the
fused against the unfused route.

With ``scan_len`` 16, Order-status reads its order lines as one interval
of MAX_ITEMS records and a Stock-level type scans 16 consecutive stock
rows.  The JAX engine's own draws (scale 0.05, 16 lanes, 20 waves) are
replayed into the port's wave step (tests/port_harness.py) and held
against JAX ``run(..., keep_state=True)`` on ``backend="jnp"``: counters,
abort causes, claim, version and ring tables bit-identical, heats to rtol
1e-6, lane_time to rtol 1e-5.  The fused and unfused routes end in the
same state under scans.  OCC, TicToc and 2PL are in
test_torch_scan_tpcc.py.
"""
import pytest

from port_harness import assert_engine_parity, assert_routes_identical, \
    jax_draws
from repro.core import types as jt
from repro.workloads import TPCCWorkload

LANES, WAVES, SEED = 16, 20, 2
WL = TPCCWorkload.make(n_warehouses=8, scale=0.05, scan_len=16)

CONFIGS = [(jt.CC_SWISS, 1), (jt.CC_ADAPTIVE, 0), (jt.CC_AUTOGRAN, 0),
           (jt.CC_MVCC, 0), (jt.CC_MVOCC, 1)]


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


@pytest.mark.parametrize("cc", [jt.CC_TICTOC, jt.CC_ADAPTIVE],
                         ids=["tictoc", "adaptive"])
def test_tpcc_scans_fused_and_unfused_routes_identical(draws, cc):
    assert_routes_identical(WL, cc, draws)
