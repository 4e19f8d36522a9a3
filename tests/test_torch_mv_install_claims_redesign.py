"""The multi-version wave's claim installs and check as one ``validate``
call, and ``mv_install``'s corners, held against the JAX package.

``chip_smoke.py`` holds the CUDA ``validate`` with installs (one
cooperative launch: both claim installs, a grid barrier, the two-channel
check) and ``mv_install`` (one cooperative launch: copy forward, a grid
barrier, stamp) against their plain versions on
``chip_smoke.validate_install_cases`` and ``chip_smoke.mv_install_cases``.
Here, on the CPU, the plain versions meet the JAX oracles bit for bit on
exactly those cases, made with numpy from a seed: ``ref.claim_scatter``
into each table, then ``ref.occ_validate`` per channel; ``ref.mv_install``.
The cases are shown to reach each path of the new kernels.  MVCC and
MV-OCC runs, coarse and fine, on TPC-C with scans (ADDs on the reader
channel) and on YCSB with read-only lanes stay equal to JAX
``backend="jnp"`` with one ``validate`` and one ``mv_install`` call a wave
and no ``claim_scatter`` call; ``kernel_coverage`` reports
``claim_scatter`` as "not_run" for them, and for AutoGran, whose write
claims ride its ``validate_dual`` call.  The
CUDA kernels run on the same cases in tests/test_torch_cuda.py.
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
from repro_torch.core.backend import kernel_coverage
from repro_torch.core import types as pt
from repro_torch.kernels.occ_validate import validate_plain
from repro_torch.launch import txn_bench

INSTALL_CASES = chip_smoke.validate_install_cases()
MV_CASES = chip_smoke.mv_install_cases()


def _t(x):
    return torch.from_numpy(
        (x.view(np.int32) if x.dtype == np.uint32 else x).copy())


def _ref_install_validate(c):
    """JAX's sequence: claim_scatter into claim_w and claim_r, then one
    occ_validate per channel, OR-ed."""
    keys, groups = jnp.asarray(c["keys"]), jnp.asarray(c["groups"])
    prio = jnp.asarray(np.broadcast_to(c["prio"][:, None], c["keys"].shape)
                       .astype(np.uint32))
    wave = jnp.int32(c["wave"])
    cw = ref.claim_scatter(jnp.asarray(c["claim_w"]), keys, groups, prio,
                           jnp.asarray(c["install_w"]), wave)
    cr = ref.claim_scatter(jnp.asarray(c["claim_r"]), keys, groups, prio,
                           jnp.asarray(c["install_r"]), wave)
    ivw = jnp.uint32(0xFFFF - (c["wave"] & 0xFFFF))

    def check(table, mask):
        return np.asarray(ref.occ_validate(table, keys, groups, prio,
                                           jnp.asarray(mask), ivw,
                                           c["fine"]))
    return (check(cw, c["check"]), check(cr, c["check_r"]),
            np.asarray(cw), np.asarray(cr))


@pytest.mark.parametrize("case", INSTALL_CASES,
                         ids=[c[0] for c in INSTALL_CASES])
def test_validate_install_plain_matches_ref_on_card_cases(case):
    _, c = case
    want_w, want_r, want_cw, want_cr = _ref_install_validate(c)
    cw, cr = _t(c["claim_w"]), _t(c["claim_r"])
    K.reset_launches()
    got = K.validate(cw, _t(c["keys"]), _t(c["groups"]), _t(c["prio"]),
                     _t(c["check"]), c["wave"], c["fine"], claim_r=cr,
                     check_r=_t(c["check_r"]),
                     install_w=_t(c["install_w"]),
                     install_r=_t(c["install_r"]))
    np.testing.assert_array_equal(got.numpy(), want_w | want_r)
    np.testing.assert_array_equal(cw.numpy().view(np.uint32), want_cw)
    np.testing.assert_array_equal(cr.numpy().view(np.uint32), want_cr)
    assert (K.validate.calls, K.validate.launches) == (1, 0)
    assert K.claim_scatter.calls == 0


def test_validate_install_cases_reach_each_path():
    """Every install mode, fine and coarse, G = 1 to 3, both claim-tag
    halves; ops with both, one or neither install and check; cells that
    several ops install into in both tables; keys -1 and past the end,
    groups G and G + 2; a conflict on each channel alone; and a wave of
    more ops than an H100 keeps co-resident threads."""
    assert {c["fine"] for _, c in INSTALL_CASES} == {True, False}
    assert {c["claim_w"].shape[1] for _, c in INSTALL_CASES} == {1, 2, 3}
    assert {(0xFFFF - (c["wave"] & 0xFFFF)) >> 15
            for _, c in INSTALL_CASES} == {0, 1}
    flags = set()
    only_w = only_r = dup_w = dup_r = 0
    for label, c in INSTALL_CASES:
        N, G = c["claim_w"].shape
        m = np.stack([c[k] for k in ("install_w", "install_r", "check",
                                     "check_r")], -1).reshape(-1, 4)
        flags |= {tuple(r) for r in m.tolist()}
        assert (c["keys"] == -1).any() and (c["keys"] >= N).any()
        assert (c["groups"] == G).any() and (c["groups"] == G + 2).any()
        for mask, count in (("install_w", "w"), ("install_r", "r")):
            ok = c[mask] & (c["keys"] >= 0) & (c["keys"] < N) \
                & (c["groups"] < G)
            cells = c["keys"][ok].astype(np.int64) * G + c["groups"][ok]
            dup = int((np.unique(cells, return_counts=True)[1] > 1).sum())
            if count == "w":
                dup_w += dup
            else:
                dup_r += dup
        w, r, _, _ = _ref_install_validate(c)
        only_w += int((w & ~r).sum())
        only_r += int((r & ~w).sum())
    assert {(True, True), (True, False), (False, True), (False, False)} <= {
        (f[0] or f[1], f[2] or f[3]) for f in flags}
    assert (True, True, True, True) in flags and (False,) * 4 in flags
    assert dup_w and dup_r and only_w and only_r
    assert max(c["keys"].size for _, c in INSTALL_CASES) > \
        chip_smoke.H100_SMS * chip_smoke.SM_THREADS


def test_validate_install_arguments_come_together():
    _, c = INSTALL_CASES[0]
    args = [_t(c[n]) for n in ("claim_w", "keys", "groups", "prio",
                               "check")]
    pair = dict(claim_r=_t(c["claim_r"]), check_r=_t(c["check_r"]))
    with pytest.raises(ValueError, match="install_w and install_r"):
        K.validate(*args, c["wave"], c["fine"], **pair,
                   install_w=_t(c["install_w"]))
    with pytest.raises(ValueError, match="install_w and install_r"):
        K.validate(*args, c["wave"], c["fine"],
                   install_w=_t(c["install_w"]),
                   install_r=_t(c["install_r"]))
    flat = [a.reshape(-1) for a in args[1:3]]
    with pytest.raises(ValueError, match=r"\[T, K\]"):
        K.validate(args[0], *flat, args[3], args[4].reshape(-1), c["wave"],
                   c["fine"], claim_r=pair["claim_r"],
                   check_r=pair["check_r"].reshape(-1),
                   install_w=_t(c["install_w"]).reshape(-1),
                   install_r=_t(c["install_r"]).reshape(-1))


def test_validate_without_installs_is_the_two_channel_check():
    """Empty install masks leave both tables as they were and give the
    check-only call's verdicts on the expanded priority."""
    _, c = INSTALL_CASES[0]
    cw, cr = _t(c["claim_w"]), _t(c["claim_r"])
    keys, groups, prio = _t(c["keys"]), _t(c["groups"]), _t(c["prio"])
    none = torch.zeros_like(keys, dtype=torch.bool)
    got = validate_plain(cw, keys, groups, prio, _t(c["check"]), c["wave"],
                         c["fine"], claim_r=cr, check_r=_t(c["check_r"]),
                         install_w=none, install_r=none)
    want = validate_plain(cw, keys, groups,
                          prio[:, None].expand(keys.shape).contiguous(),
                          _t(c["check"]), c["wave"], c["fine"], claim_r=cr,
                          check_r=_t(c["check_r"]))
    assert torch.equal(got, want)
    assert torch.equal(cw, _t(c["claim_w"])) and torch.equal(
        cr, _t(c["claim_r"]))


def _ref_mv_install(c):
    """ref.mv_install, with a negative head (which no wave makes) given to
    JAX as 2D - 1: JAX wraps a negative index, the port reads any head
    outside [0, D) as a zero row, and 2D - 1 is outside with the same new
    slot.  A record no op installs into keeps its head."""
    D = c["begin"].shape[1]
    neg = c["head"] < 0
    head = np.where(neg, 2 * D - 1, c["head"]).astype(np.int32)
    b, h = ref.mv_install(jnp.asarray(c["begin"]), jnp.asarray(head),
                          jnp.asarray(c["keys"]), jnp.asarray(c["groups"]),
                          jnp.asarray(c["do"]), jnp.uint32(c["ts"]))
    h = np.asarray(h)
    return np.asarray(b), np.where(neg & (h == 2 * D - 1), c["head"], h)


@pytest.mark.parametrize("case", MV_CASES, ids=[c[0] for c in MV_CASES])
def test_mv_install_plain_matches_ref_on_card_cases(case):
    _, c = case
    want_b, want_h = _ref_mv_install(c)
    begin, head = _t(c["begin"]), _t(c["head"])
    K.reset_launches()
    K.mv_install(begin, head, _t(c["keys"]), _t(c["groups"]), _t(c["do"]),
                 c["ts"])
    np.testing.assert_array_equal(begin.numpy().view(np.uint32), want_b)
    np.testing.assert_array_equal(head.numpy(), want_h)
    assert (K.mv_install.calls, K.mv_install.launches) == (1, 0)


def test_mv_install_cases_reach_each_corner():
    """D = 4 and 1, G = 1 to 3; duplicate writers of one record in one
    group and in different groups; keys and groups out of range; heads at
    D - 1, D, D + 3 and -1 that an op installs into; empty and full masks;
    every op on one record; stamps on both sides of 2**31; a wave of more
    ops than an H100 keeps co-resident threads."""
    assert {(c["begin"].shape[1], c["begin"].shape[2])
            for _, c in MV_CASES} >= {(D, G) for D in (4, 1)
                                      for G in (1, 2, 3)}
    assert {c["ts"] >> 31 for _, c in MV_CASES} == {0, 1}
    assert any(not c["do"].any() for _, c in MV_CASES)
    assert any(c["do"].all() for _, c in MV_CASES)
    assert any(len(np.unique(c["keys"])) == 1 for _, c in MV_CASES)
    same_g = diff_g = 0
    heads = set()
    for _, c in MV_CASES:
        N, D, G = c["begin"].shape
        ok = c["do"] & (c["keys"] >= 0) & (c["keys"] < N)
        if len(np.unique(c["keys"])) > 1:       # all but the one-record case
            assert ((c["keys"] == -1) | (c["keys"] >= N)).any()
        k, g = c["keys"][ok], c["groups"][ok]
        if not ok.any():
            continue
        assert (c["groups"][ok] >= G).any() or ok.sum() < 10
        cells = k.astype(np.int64) * (G + 3) + g
        same_g += int((np.unique(cells, return_counts=True)[1] > 1).sum())
        for r in np.unique(k):
            diff_g += len(np.unique(g[k == r])) > 1
        h = c["head"][np.unique(k)]
        heads |= {int(x) - D for x in h if x >= D} | {-1 for x in h if x < 0}
        heads |= {"wrap" for x in h if x == D - 1}
    assert same_g and diff_g
    assert {0, 3, -1, "wrap"} <= heads
    assert max(c["keys"].size for _, c in MV_CASES) > \
        chip_smoke.H100_SMS * chip_smoke.SM_THREADS


YCSB = YCSBWorkload.make(n_keys=2000, theta=0.9, write_frac=0.8,
                         ro_frac=0.2)
TPCC_SCANS = TPCCWorkload.make(n_warehouses=8, scale=0.05, scan_len=16)
LANES, WAVES, SEED = 16, 10, 8


@pytest.mark.parametrize("wl,cc,gran", [
    (YCSB, jt.CC_MVCC, 0), (YCSB, jt.CC_MVOCC, 1),
    (TPCC_SCANS, jt.CC_MVCC, 1), (TPCC_SCANS, jt.CC_MVOCC, 0)],
    ids=["ycsb-mvcc-coarse", "ycsb-mvocc-fine", "tpcc-scans-mvcc-fine",
         "tpcc-scans-mvocc-coarse"])
def test_mv_waves_install_in_validate_and_match_jax(wl, cc, gran):
    """Both claim installs and the check are one validate call a wave,
    the ring install one mv_install call, and claim_scatter is never
    called; counters, causes, claim tables and the ring stay equal to
    JAX's."""
    draws = jax_draws(wl, LANES, WAVES, seed=SEED)
    K.reset_launches()
    state = assert_engine_parity(wl, cc, gran, LANES, draws, seed=SEED)
    assert K.validate.calls == WAVES and K.mv_install.calls == WAVES
    assert K.claim_scatter.calls == 0
    assert sum(K.launch_counts().values()) == 0
    assert int(state.ro_aborts) == 0
    assert int(state.abort_causes[jt.CAUSE_WW]) > 0


def test_kernel_coverage_reports_claim_scatter_not_run_on_mv_runs():
    rows = txn_bench.run_grid("tpcc", ["mvcc", "mvocc", "autogran"], (0, 1),
                              [8], 2, scale=0.01, device="cpu")
    for r in rows:
        ops = r["kernel_ops"]
        # AutoGran's write claims ride its validate_dual call.
        assert ops["claim_scatter"] == "not_run", (r["cc"], ops)
        assert ops[("validate_dual" if r["cc"] == "autogran"
                    else "validate")] == "torch"
    calls = {"validate": 4, "mv_gather": 4, "mv_install": 4,
             "segment_count": 8}
    assert kernel_coverage(pt.CC_MVCC, {}, calls)["claim_scatter"] == \
        "not_run"
    assert kernel_coverage(pt.CC_MVOCC, calls, calls)["validate"] == "cuda"
