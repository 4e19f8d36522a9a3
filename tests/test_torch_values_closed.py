"""Tracked values on the closed loop: the six single-version mechanisms
on small YCSB, replaying the JAX engine's draws
(tests/port_harness.py ``assert_values_parity``): the final ``values``
bit-identical to JAX ``run(..., track_values=True)``, the commits and
the tables too, and the untracked replay of the same draws ending in the
same counters and tables.  Each mechanism runs at the granularity that
tests/test_torch_values_open.py does not, so the two files cover every
mechanism at both granularities with one JAX compile a case.
"""
import pytest

from port_harness import assert_values_parity, jax_draws
from repro.core import types as jt
from repro.workloads import YCSBWorkload

LANES, WAVES, SEED = 8, 5, 1
WL = YCSBWorkload.make(n_keys=2000, theta=0.8, write_frac=0.5)
CASES = [(jt.CC_OCC, 0), (jt.CC_TICTOC, 1), (jt.CC_2PL, 0),
         (jt.CC_SWISS, 1), (jt.CC_ADAPTIVE, 0), (jt.CC_AUTOGRAN, 1)]


@pytest.fixture(scope="module")
def draws():
    return jax_draws(WL, LANES, WAVES, seed=SEED)


@pytest.mark.parametrize("cc,gran", CASES,
                         ids=[f"{jt.CC_NAMES[c]}-{'fine' if g else 'coarse'}"
                              for c, g in CASES])
def test_closed_values_match_jax(draws, cc, gran):
    state = assert_values_parity(WL, cc, gran, LANES, draws, seed=SEED)
    assert int(state.commits) > 0
    assert float(state.store.values.abs().sum()) > 0
