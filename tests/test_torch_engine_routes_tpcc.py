"""The probe family's unfused route on TPC-C: claim_probe on each claim
table, the verdict compare in tensor ops, commit_install for the bumps.

One mechanism's unfused replay of the JAX draws (tests/port_harness.py;
TPC-C scale 0.01, 16 lanes, 20 waves) equals JAX ``run`` with
``fuse_wave=False``.  In the port, the unfused route ends in the same
state as the fused ``wave_commit``, bit for bit, for all five
probe-family mechanisms.
"""
import pytest

from port_harness import assert_engine_parity, assert_routes_identical, \
    jax_draws
from repro.core import types as jt
from repro.workloads import TPCCWorkload

LANES, WAVES, SEED = 16, 20, 0
WL = TPCCWorkload.make(n_warehouses=8, scale=0.01)


@pytest.fixture(scope="module")
def draws():
    return jax_draws(WL, LANES, WAVES, seed=SEED)


def test_tpcc_unfused_adaptive_coarse_matches_jax(draws):
    assert_engine_parity(WL, jt.CC_ADAPTIVE, 0, LANES, draws, seed=SEED,
                         fuse_wave=False)


@pytest.mark.parametrize("cc", [jt.CC_OCC, jt.CC_TICTOC, jt.CC_2PL,
                                jt.CC_SWISS, jt.CC_ADAPTIVE],
                         ids=["occ", "tictoc", "2pl", "swisstm", "adaptive"])
def test_tpcc_fused_and_unfused_routes_identical(draws, cc):
    assert_routes_identical(WL, cc, draws)
