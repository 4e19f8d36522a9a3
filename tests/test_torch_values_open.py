"""Tracked values on the open loop, replaying the JAX engine's draws
(tests/port_harness.py ``jax_open_draws``, ``assert_values_parity``): the
open-loop step (arrivals, the admission queue, retries) for every
mechanism on small YCSB, one granularity each (the closed-loop file
takes the other); the final ``values`` (and
under MVCC/MV-OCC ``mv_vals``) bit-identical to JAX ``run(...,
track_values=True)``.
"""
import pytest

from port_harness import assert_values_parity, jax_open_draws
from repro.core import types as jt
from repro.workloads import YCSBWorkload

LANES, WAVES, SEED, RATE = 8, 6, 3, 6.0
WL = YCSBWorkload.make(n_keys=2000, theta=0.8, write_frac=0.5)
OPEN = dict(arrival_rate=RATE, queue_cap=32, max_incarnations=2,
            lat_bins=16)
OPEN_CASES = [(jt.CC_OCC, 1), (jt.CC_TICTOC, 0), (jt.CC_2PL, 1),
              (jt.CC_SWISS, 0), (jt.CC_ADAPTIVE, 1), (jt.CC_AUTOGRAN, 0),
              (jt.CC_MVCC, 1), (jt.CC_MVOCC, 0)]


@pytest.fixture(scope="module")
def open_draws():
    return jax_open_draws(WL, LANES, WAVES, RATE, seed=SEED)


@pytest.mark.parametrize("cc,gran", OPEN_CASES,
                         ids=[f"{jt.CC_NAMES[c]}-{'fine' if g else 'coarse'}"
                              for c, g in OPEN_CASES])
def test_open_values_match_jax(open_draws, cc, gran):
    state = assert_values_parity(WL, cc, gran, LANES, open_draws,
                                 seed=SEED, **OPEN)
    assert int(state.commits) > 0 and int(state.ol.admitted) > 0
