"""Scan parity on YCSB: every mechanism of the port with YCSB's scan class
against the JAX engine.

The JAX engine's own draws (YCSB with 2,000 keys, theta 0.9, 50% writes,
``scan_frac`` 0.3, ``scan_len`` 8; 16 lanes, 20 waves) are replayed into
the port's wave step (tests/port_harness.py) and held against JAX
``run(..., keep_state=True)`` on ``backend="jnp"``: counters, abort
causes (phantoms included), claim, version and ring tables bit-identical,
heats to rtol 1e-6, lane_time to rtol 1e-5.  Under scans the fused route
moves its bumps after the phantom pass, and still ends in the unfused
route's state bit for bit.
"""
import pytest

from port_harness import assert_engine_parity, assert_routes_identical, \
    jax_draws
from repro.core import types as jt
from repro.workloads import YCSBWorkload

LANES, WAVES, SEED = 16, 20, 1
WL = YCSBWorkload.make(n_keys=2000, theta=0.9, scan_frac=0.3, scan_len=8)


@pytest.fixture(scope="module")
def draws():
    return jax_draws(WL, LANES, WAVES, seed=SEED)


CONFIGS = [(cc, g) for cc in (jt.CC_OCC, jt.CC_TICTOC, jt.CC_2PL,
                               jt.CC_SWISS, jt.CC_ADAPTIVE, jt.CC_MVCC,
                               jt.CC_MVOCC) for g in (0, 1)]
CONFIGS.append((jt.CC_AUTOGRAN, 0))


@pytest.mark.parametrize("cc,gran", CONFIGS, ids=[
    f"{jt.CC_NAMES[cc]}-{'fine' if g else 'coarse'}" for cc, g in CONFIGS])
def test_ycsb_scans_match_jax(draws, cc, gran):
    state = assert_engine_parity(WL, cc, gran, LANES, draws, seed=SEED)
    phantoms = int(state.abort_causes[jt.CAUSE_PHANTOM])
    if cc == jt.CC_MVCC:
        assert phantoms == 0
    elif cc in (jt.CC_OCC, jt.CC_MVOCC) and gran == 0:
        assert phantoms > 0


@pytest.mark.parametrize("cc", [jt.CC_OCC, jt.CC_2PL],
                         ids=["occ", "2pl"])
def test_ycsb_scans_fused_and_unfused_routes_identical(draws, cc):
    assert_routes_identical(WL, cc, draws)
