"""Slice-2 parity on TPC-C: 2PL, SwissTM, Adaptive and AutoGran in the
port's wave engine against the JAX engine.

The JAX engine's own draws are replayed into the port's wave step
(tests/port_harness.py) at TPC-C scale 0.01, 16 lanes and 20 waves,
against JAX ``run(..., keep_state=True)`` on ``backend="jnp"``: counters,
claim and version tables, mode bits and heat waves bit-identical, heats
to rtol 1e-6.  Records turn pessimistic (Adaptive) and get promoted to
fine timestamps (AutoGran), so both state machines run.  The unfused
route is held in test_torch_engine_routes_tpcc.py.
"""
import pytest

from port_harness import assert_engine_parity, jax_draws
from repro.core import types as jt
from repro.workloads import TPCCWorkload

LANES, WAVES, SEED = 16, 20, 0
WL = TPCCWorkload.make(n_warehouses=8, scale=0.01)


@pytest.fixture(scope="module")
def draws():
    return jax_draws(WL, LANES, WAVES, seed=SEED)


@pytest.mark.parametrize("cc,gran", [
    (jt.CC_2PL, 0), (jt.CC_2PL, 1), (jt.CC_SWISS, 0), (jt.CC_SWISS, 1),
    (jt.CC_ADAPTIVE, 0), (jt.CC_ADAPTIVE, 1),
], ids=["2pl-coarse", "2pl-fine", "swisstm-coarse", "swisstm-fine",
        "adaptive-coarse", "adaptive-fine"])
def test_tpcc_mechanism_matches_jax(draws, cc, gran):
    state = assert_engine_parity(WL, cc, gran, LANES, draws, seed=SEED)
    if cc == jt.CC_ADAPTIVE:
        assert int(state.store.pess_mode.sum()) > 0
        assert float(state.store.abort_heat.max()) > 0.0


def test_tpcc_autogran_matches_jax(draws):
    state = assert_engine_parity(WL, jt.CC_AUTOGRAN, 0, LANES, draws,
                                 seed=SEED)
    assert int(state.store.fine_mode.sum()) > 0
    assert float(state.store.false_heat.max()) > 0.0
