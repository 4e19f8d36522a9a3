"""The probe family's unfused route on YCSB: claim_probe on each claim
table, the verdict compare in tensor ops, commit_install for the bumps.

One mechanism's unfused replay of the JAX draws (tests/port_harness.py;
YCSB with 2,000 keys, theta 0.9, 50% writes, 16 lanes, 20 waves) equals
JAX ``run`` with ``fuse_wave=False``.  In the port, the unfused route
ends in the same state as the fused ``wave_commit``, bit for bit, for all
five probe-family mechanisms.
"""
import pytest

from port_harness import assert_engine_parity, assert_routes_identical, \
    jax_draws
from repro.core import types as jt
from repro.workloads import YCSBWorkload

LANES, WAVES, SEED = 16, 20, 3
WL = YCSBWorkload.make(n_keys=2000, theta=0.9)


@pytest.fixture(scope="module")
def draws():
    return jax_draws(WL, LANES, WAVES, seed=SEED)


def test_ycsb_unfused_2pl_fine_matches_jax(draws):
    assert_engine_parity(WL, jt.CC_2PL, 1, LANES, draws, seed=SEED,
                         fuse_wave=False)


@pytest.mark.parametrize("cc", [jt.CC_OCC, jt.CC_TICTOC, jt.CC_2PL,
                                jt.CC_SWISS, jt.CC_ADAPTIVE],
                         ids=["occ", "tictoc", "2pl", "swisstm", "adaptive"])
def test_ycsb_fused_and_unfused_routes_identical(draws, cc):
    assert_routes_identical(WL, cc, draws)
