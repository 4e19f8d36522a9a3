"""The yardsticks of validate's two-channel form and route_pack's card
cases, held against the JAX oracles, and the multi-version waves' one
validate call.

``chip_smoke.py`` holds the CUDA ``validate`` (one launch a wave, reading
per op the claim rows its two checks name) and ``route_pack`` (a grid of
256-op tiles in one cooperative launch) against their plain versions
on ``chip_smoke.validate_pair_cases`` and ``chip_smoke.route_pack_cases``.
Here, on the CPU, the plain versions meet ``ref.occ_validate`` and
``ref.route_pack`` (JAX) bit for bit on exactly those cases, made with
numpy from a seed, and the cases are shown to reach each path of the new
kernels.  The one case left out here is the card's buffer of more than
2**31 words (8.6 GB).  An MVCC and an MV-OCC run, with and without scans,
call ``validate`` once a wave and stay equal to JAX ``backend="jnp"`` on
the JAX engine's draws.  The CUDA kernels run on the same cases in
tests/test_torch_cuda.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from port_harness import assert_engine_parity, jax_draws
from repro.core import types as jt
from repro.kernels import ref
from repro.workloads import TPCCWorkload, YCSBWorkload
from repro_torch import kernels as K
from repro_torch.kernels.occ_validate import validate_plain
from repro_torch.kernels.route_pack import (MAX_CHANNELS, MAX_DESTINATIONS,
                                            route_pack_plain)

PAIR_CASES = chip_smoke.validate_pair_cases()
ROUTE_CASES = chip_smoke.route_pack_cases()


def _t(x):
    return torch.from_numpy(
        (x.view(np.int32) if x.dtype == np.uint32 else x).copy())


def _ref_validate(c, table, check):
    return np.asarray(ref.occ_validate(
        jnp.asarray(table), jnp.asarray(c["keys"]), jnp.asarray(c["groups"]),
        jnp.asarray(c["myprio"]), jnp.asarray(check),
        jnp.uint32(0xFFFF - (c["wave"] & 0xFFFF)), c["fine"]))


@pytest.mark.parametrize("case", PAIR_CASES, ids=[c[0] for c in PAIR_CASES])
def test_validate_pair_plain_matches_ref_on_card_cases(case):
    _, c = case
    want_w = _ref_validate(c, c["claim_w"], c["check"])
    want_r = _ref_validate(c, c["claim_r"], c["check_r"])
    K.reset_launches()
    got = K.validate(*(_t(c[n]) for n in ("claim_w", "keys", "groups",
                                          "myprio", "check")),
                     c["wave"], c["fine"], claim_r=_t(c["claim_r"]),
                     check_r=_t(c["check_r"]))
    np.testing.assert_array_equal(got.numpy(), want_w | want_r)
    assert (K.validate.calls, K.validate.launches) == (1, 0)


def test_validate_pair_cases_reach_each_path():
    """Every mask mode, fine and coarse, G = 1 to 3, both claim-tag
    halves; the waves' masks disjoint, the overlapping ones with ops on
    both channels; keys -1 and past the end, groups G and G + 2, ties; a
    conflict on each channel alone, and on both."""
    combos = {(c["check"].any(), c["check_r"].any()) for _, c in PAIR_CASES}
    assert combos == {(True, True), (True, False), (False, True),
                      (False, False)}
    assert {(c["fine"], c["claim_w"].shape[1]) for _, c in PAIR_CASES} == {
        (f, G) for f in (True, False) for G in (1, 2, 3)}
    assert {(0xFFFF - (c["wave"] & 0xFFFF)) >> 15 for _, c in PAIR_CASES} \
        == {0, 1}
    only_w = only_r = both = 0
    for label, c in PAIR_CASES:
        N, G = c["claim_w"].shape
        if label.startswith("waves"):
            assert not (c["check"] & c["check_r"]).any()
        if label.startswith("overlap"):
            assert (c["check"] & c["check_r"]).any()
        assert (c["keys"] == -1).any() and (c["keys"] >= N).any()
        assert (c["groups"] == G).any() and (c["groups"] == G + 2).any()
        w = _ref_validate(c, c["claim_w"], c["check"])
        r = _ref_validate(c, c["claim_r"], c["check_r"])
        only_w += int((w & ~r).sum())
        only_r += int((r & ~w).sum())
        both += int((w & r).sum())
    assert only_w and only_r and both


@pytest.mark.parametrize("fine", [True, False], ids=["fine", "coarse"])
def test_validate_without_second_channel_is_the_one_channel_op(fine):
    _, c = PAIR_CASES[0]
    args = [_t(c[n]) for n in ("claim_w", "keys", "groups", "myprio",
                               "check")]
    one = K.validate(*args, c["wave"], fine)
    np.testing.assert_array_equal(
        one.numpy(), _ref_validate(dict(c, fine=fine), c["claim_w"],
                                   c["check"]))
    none = torch.zeros_like(args[4])
    pair = validate_plain(*args, c["wave"], fine, claim_r=_t(c["claim_r"]),
                          check_r=none)
    assert torch.equal(pair, one)
    with pytest.raises(ValueError, match="claim_r and check_r"):
        K.validate(*args, c["wave"], fine, claim_r=_t(c["claim_r"]))


@pytest.mark.parametrize("case", ROUTE_CASES, ids=[c[0] for c in ROUTE_CASES])
def test_route_pack_plain_matches_ref_on_card_cases(case):
    _, c = case
    want = ref.route_pack(jnp.asarray(c["owner"]), jnp.asarray(c["vals"]),
                          c["n_dest"], c["cap"], c["fills"])
    K.reset_launches()
    got = K.route_pack(torch.from_numpy(c["owner"]),
                       torch.from_numpy(c["vals"]), c["n_dest"], c["cap"],
                       c["fills"])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert (K.route_pack.calls, K.route_pack.launches) == (1, 0)


def test_route_pack_cases_reach_each_path():
    """The sharded waves' sizes (4,096 to 32,768 ops) and a wave of more
    tiles than an H100 keeps resident blocks; M off the tile, one op,
    none; n_dest 1, 3, 8 and MAX_DESTINATIONS; cap 0, 16 and
    DistConfig's; W 1 and MAX_CHANNELS; skewed waves that drop, waves that
    drop nothing; dropped ops keep their rank; only the huge case is left
    to the card."""
    tile = 256
    resident = chip_smoke.H100_SMS * chip_smoke.SM_THREADS // tile
    Ms = [c["owner"].size for _, c in ROUTE_CASES]
    assert {4096, 8192, 16384, 32768} <= set(Ms)
    assert max(Ms) > resident * tile
    assert {0, 1} <= set(Ms) and any(m % tile for m in Ms if m > tile)
    assert {1, 3, 8, MAX_DESTINATIONS} == {c["n_dest"]
                                              for _, c in ROUTE_CASES}
    caps = {c["cap"] for _, c in ROUTE_CASES}
    assert {0, 16} <= caps and any(
        c["cap"] == chip_smoke._dist_cap(c["owner"].size, 1, c["n_dest"],
                                         False)
        for _, c in ROUTE_CASES)
    assert {1, MAX_CHANNELS} <= {c["vals"].shape[0]
                                    for _, c in ROUTE_CASES}
    drops = []
    for _, c in ROUTE_CASES:
        owner, n_dest, cap = c["owner"], c["n_dest"], c["cap"]
        live = (owner >= 0) & (owner < n_dest)
        assert ((owner == -1) | (owner >= n_dest)).any() or owner.size < 10
        buf, pos, took = route_pack_plain(
            torch.from_numpy(owner), torch.from_numpy(c["vals"]), n_dest,
            cap, c["fills"])
        dropped = live & ~took.numpy()
        drops.append(int(dropped.sum()))
        if dropped.any():
            assert (pos.numpy()[dropped] >= cap).all()
    assert min(drops) == 0 and max(drops) > 0
    huge = chip_smoke.route_pack_cases(huge=True)
    assert len(huge) == len(ROUTE_CASES) + 1
    _, big = huge[-1]
    assert big["vals"].shape[0] * big["n_dest"] * big["cap"] > 2 ** 31


YCSB = YCSBWorkload.make(n_keys=2000, theta=0.9, write_frac=0.8,
                         ro_frac=0.2)
TPCC_SCANS = TPCCWorkload.make(n_warehouses=8, scale=0.05, scan_len=16)
LANES, WAVES, SEED = 16, 12, 6


@pytest.mark.parametrize("wl,cc,gran", [
    (YCSB, jt.CC_MVCC, 1), (YCSB, jt.CC_MVOCC, 0),
    (TPCC_SCANS, jt.CC_MVOCC, 1)],
    ids=["ycsb-mvcc-fine", "ycsb-mvocc-coarse", "tpcc-scans-mvocc-fine"])
def test_mv_waves_validate_once_and_match_jax(wl, cc, gran):
    """The write-write check on both claim channels and MV-OCC's
    update-transaction read check are one validate call a wave; counters,
    causes, tables and the ring stay equal to JAX's."""
    draws = jax_draws(wl, LANES, WAVES, seed=SEED)
    K.reset_launches()
    state = assert_engine_parity(wl, cc, gran, LANES, draws, seed=SEED)
    assert K.validate.calls == WAVES
    assert K.validate.launches == 0
    assert int(state.ro_aborts) == 0
    if cc == jt.CC_MVOCC:
        assert int(state.abort_causes[jt.CAUSE_READ_VAL]) > 0
    assert int(state.abort_causes[jt.CAUSE_WW]) > 0
