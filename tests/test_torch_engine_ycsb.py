"""Slice parity on YCSB: the port's wave engine equals the JAX engine.

The JAX engine's own draws are replayed outside it and fed into the
port's wave step (tests/port_harness.py); OCC and TicToc, coarse and fine,
at a small YCSB (4,000 keys, theta 0.9, 50% writes, 16 lanes, 20 waves)
against JAX ``run(..., keep_state=True)`` on ``backend="jnp"``.
"""
import pytest

from port_harness import assert_engine_parity, jax_draws
from repro.core import types as jt
from repro.workloads import YCSBWorkload

LANES, WAVES = 16, 20
WL = YCSBWorkload.make(n_keys=4000, theta=0.9)


@pytest.fixture(scope="module")
def draws():
    return jax_draws(WL, LANES, WAVES, seed=3)


@pytest.mark.parametrize("gran", [0, 1], ids=["coarse", "fine"])
@pytest.mark.parametrize("cc", [jt.CC_OCC, jt.CC_TICTOC],
                         ids=["occ", "tictoc"])
def test_ycsb_wave_engine_matches_jax(draws, cc, gran):
    assert_engine_parity(WL, cc, gran, LANES, draws, seed=3)
