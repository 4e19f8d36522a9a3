"""A scan wave's version bumps inside its phantom pass (``iterate_validate``'s
bump form) and AutoGran's write-claim install inside its dual check
(``validate_dual``'s install form), held against the JAX package.

``chip_smoke.py`` holds the CUDA bump form (one plain launch in blocks of
whole lanes) and install form (one cooperative launch: the install, a grid
barrier, both verdicts) against their plain versions on
``chip_smoke.bump_fold_cases`` and ``chip_smoke.dual_install_cases``.
Here, on the CPU, each plain version meets the chain it replaces, written
with the port's plain ops, and the JAX chain, bit for bit on exactly those
cases, made with numpy from a seed: ``ref.iterate_validate``, the OR with
the point conflicts and ``ref.occ_commit`` on the committed lanes' writes;
``ref.claim_scatter`` on the expanded lane priority, then
``ref.occ_validate_dual``.  The cases are shown to reach each path of the
new kernels, and the new forms refuse mixed arguments.  OCC, 2PL, SwissTM,
Adaptive and AutoGran with scans, and AutoGran on the point mix, stay
equal to JAX ``backend="jnp"`` (wts, claim tables, fine_mode, heats and
causes), with one ``iterate_validate`` and no ``commit_install`` call a
fused scan wave, one ``validate_dual`` and no ``claim_scatter`` call an
AutoGran wave, and ``commit_install`` still on the unfused route.  The
CUDA kernels run on the same cases in tests/test_torch_cuda.py.
"""
import functools

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
from repro_torch.kernels.claim_scatter import claim_scatter_plain
from repro_torch.kernels.iterate_validate import iterate_validate_plain
from repro_torch.kernels.occ_commit import commit_install_plain
from repro_torch.kernels.occ_validate import validate_dual_plain
from repro_torch.launch import txn_bench

BUMP_CASES = chip_smoke.bump_fold_cases()
DUAL_CASES = chip_smoke.dual_install_cases()
H100_THREADS = chip_smoke.H100_SMS * chip_smoke.SM_THREADS


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(
        x.view(np.int32) if x.dtype == np.uint32 else x).copy())


def _u32(t):
    return t.numpy().view(np.uint32)


def _ivw(wave):
    return jnp.uint32(0xFFFF - (wave & 0xFFFF))


_SCAN = ("table", "keys", "extents", "groups", "myprio", "check")


@functools.lru_cache(maxsize=None)
def _ref_bump(i):
    """JAX's scan-wave chain on BUMP_CASES[i]: ref.iterate_validate, the OR
    with the point conflicts, ref.occ_commit on the committed lanes'
    writes.  Returns (conflict, wts, phantom)."""
    _, c = BUMP_CASES[i]
    phantom = ref.iterate_validate(
        *(jnp.asarray(c[n]) for n in _SCAN), _ivw(c["wave"]), c["fine"],
        c["bucket_size"], c["ext_cap"])
    conflict = phantom | jnp.asarray(c["point"])
    do = jnp.asarray(c["do"]) & ~conflict.any(axis=1)[:, None]
    wts = ref.occ_commit(jnp.asarray(c["wts"]), jnp.asarray(c["keys"]),
                         jnp.asarray(c["groups"]), do)
    return np.asarray(conflict), np.asarray(wts), np.asarray(phantom)


@pytest.mark.parametrize("i", range(len(BUMP_CASES)),
                         ids=[c[0] for c in BUMP_CASES])
def test_bump_form_plain_matches_chain_and_ref_on_card_cases(i):
    _, c = BUMP_CASES[i]
    want, want_wts, _ = _ref_bump(i)
    args = [_t(c[n]) for n in _SCAN] + [c["wave"], c["fine"],
                                        c["bucket_size"], c["ext_cap"]]
    point, do = _t(c["point"]), _t(c["do"])
    K.reset_launches()
    wts = _t(c["wts"])
    got = K.iterate_validate(*args, point=point, wts=wts, do=do)
    assert (K.iterate_validate.calls, K.iterate_validate.launches) == (1, 0)
    # The chain the form replaces, in the port's plain ops.
    chain = iterate_validate_plain(*args) | point
    chain_wts = _t(c["wts"])
    commit_install_plain(chain_wts, args[1], args[3],
                         do & ~chain.any(dim=1)[:, None])
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(chain.numpy(), want)
    np.testing.assert_array_equal(_u32(wts), want_wts)
    np.testing.assert_array_equal(_u32(chain_wts), want_wts)


def test_bump_fold_cases_reach_each_path():
    """Lanes of one op (a partial second block of 256 lanes), 16, 64 and
    160 (one lane a block) ops, 1,024 and 1,030 (strided over 256 threads,
    a ragged last stride); G = 1 to 3, fine and coarse, both tag halves;
    every lane role reached (a point conflict only, a phantom only,
    neither, both); committed writes bump, duplicate cells bump twice and
    words at 0xFFFFFFFF wrap; a case with every write masked bumps
    nothing; a wave past an H100's resident threads."""
    Ks = {c["keys"].shape[1] for _, c in BUMP_CASES}
    assert {1, 16, 64, 160, 1024, 1030} <= Ks
    assert {c["table"].shape[1] for _, c in BUMP_CASES} == {1, 2, 3}
    assert {c["fine"] for _, c in BUMP_CASES} == {True, False}
    assert {c["wave"] for _, c in BUMP_CASES} == {9, chip_smoke.HIGH_WAVE}
    assert max(c["keys"].size for _, c in BUMP_CASES) > H100_THREADS
    seen = dict.fromkeys(chip_smoke.BUMP_ROLES, 0)
    twice = wrapped = odd = 0
    for i, (_, c) in enumerate(BUMP_CASES):
        conflict, wts, phantom = _ref_bump(i)
        for r, n in chip_smoke.bump_fold_outcomes(c["point"], phantom,
                                                  c["roles"]).items():
            seen[r] += n
        N = c["table"].shape[0]
        keys, groups = c["keys"], c["groups"]
        if not c["do"].any():
            np.testing.assert_array_equal(wts, c["wts"])
        bumped = c["do"] & ~conflict.any(axis=1)[:, None] & (keys >= 0) & (
            keys < N) & (groups < c["table"].shape[1])
        cells = keys[bumped].astype(np.int64) * 8 + groups[bumped]
        twice += int((np.unique(cells, return_counts=True)[1] > 1).sum())
        wrapped += int((wts < c["wts"]).sum())
        odd += int((keys == -1).any()) + int((keys >= N).any()) + int(
            (groups >= c["table"].shape[1]).any()) + int(
            (c["extents"] < 1).any())
    # Keys -1 and past the end, groups past G and extents below 1 in
    # nearly every case.
    assert odd >= 4 * len(BUMP_CASES) - 4
    assert min(seen.values()) > 0, seen
    assert twice > 0 and wrapped > 0
    assert any(not c["do"].any() for _, c in BUMP_CASES)


@functools.lru_cache(maxsize=None)
def _ref_dual(i):
    """JAX AutoGran's claims and check on DUAL_CASES[i]: ref.claim_scatter
    with the lane priority per op, then ref.occ_validate_dual.  Returns
    (fine, coarse, claim_w)."""
    _, c = DUAL_CASES[i]
    keys, groups = jnp.asarray(c["keys"]), jnp.asarray(c["groups"])
    myp = jnp.broadcast_to(jnp.asarray(c["prio"])[:, None], keys.shape)
    cw = ref.claim_scatter(jnp.asarray(c["claim_w"]), keys, groups,
                           myp.astype(jnp.uint32), jnp.asarray(c["install"]),
                           jnp.uint32(c["wave"]))
    fine, coarse = ref.occ_validate_dual(cw, keys, groups,
                                         myp.astype(jnp.uint32),
                                         jnp.asarray(c["check"]),
                                         _ivw(c["wave"]))
    return np.asarray(fine), np.asarray(coarse), np.asarray(cw)


@pytest.mark.parametrize("i", range(len(DUAL_CASES)),
                         ids=[c[0] for c in DUAL_CASES])
def test_dual_install_form_plain_matches_chain_and_ref_on_card_cases(i):
    _, c = DUAL_CASES[i]
    want_f, want_c, want_cw = _ref_dual(i)
    keys, groups, prio = _t(c["keys"]), _t(c["groups"]), _t(c["prio"])
    check, install = _t(c["check"]), _t(c["install"])
    K.reset_launches()
    cw = _t(c["claim_w"])
    fine, coarse = K.validate_dual(cw, keys, groups, prio, check, c["wave"],
                                   install=install)
    assert (K.validate_dual.calls, K.validate_dual.launches) == (1, 0)
    assert K.claim_scatter.calls == 0
    # The chain the form replaces: two [T, K] priority copies,
    # claim_scatter, validate_dual.
    chain_cw = _t(c["claim_w"])
    claim_scatter_plain(chain_cw, keys, groups,
                        prio[:, None].expand(keys.shape).contiguous(),
                        c["wave"], install)
    chain = validate_dual_plain(chain_cw, keys, groups,
                                prio[:, None].expand(keys.shape).contiguous(),
                                check, c["wave"])
    for got, want in ((fine, want_f), (coarse, want_c), (chain[0], want_f),
                      (chain[1], want_c)):
        np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(_u32(cw), want_cw)
    np.testing.assert_array_equal(_u32(chain_cw), want_cw)


def test_dual_install_cases_reach_each_path():
    """AutoGran's masks, ops that install and check, installs alone,
    checks alone, nothing; G = 1 to 3, both tag halves; K = 1, 40 (off the
    256-thread block) and 1,030; conflicts that only this wave's installs
    give (the barrier matters), coarse conflicts the fine side does not
    see; a wave past an H100's resident threads (the grid strides)."""
    assert {c[0].split()[0] for c in DUAL_CASES} == set(chip_smoke.DUAL_MODES)
    assert {c["claim_w"].shape[1] for _, c in DUAL_CASES} == {1, 2, 3}
    assert {c["keys"].shape[1] for _, c in DUAL_CASES} >= {1, 40, 1030}
    assert {c["wave"] for _, c in DUAL_CASES} == {9, chip_smoke.HIGH_WAVE}
    assert max(c["keys"].size for _, c in DUAL_CASES) > H100_THREADS
    fresh = coarse_only = 0
    for i, (_, c) in enumerate(DUAL_CASES):
        fine, coarse, cw = _ref_dual(i)
        keys = jnp.asarray(c["keys"])
        myp = jnp.broadcast_to(jnp.asarray(c["prio"])[:, None], keys.shape)
        _, before = ref.occ_validate_dual(
            jnp.asarray(c["claim_w"]), keys, jnp.asarray(c["groups"]),
            myp.astype(jnp.uint32), jnp.asarray(c["check"]), _ivw(c["wave"]))
        fresh += int((coarse & ~np.asarray(before)).sum())
        coarse_only += int((coarse & ~fine).sum())
        if not c["install"].any():
            np.testing.assert_array_equal(cw, c["claim_w"])
    assert fresh > 0 and coarse_only > 0


def _bump_call(given):
    """An iterate_validate call with the keywords of ``given`` (point,
    wts, do, words) and keys flat where ``flat`` is given."""
    _, c = BUMP_CASES[1]
    table = _t(c["wts"])
    args = [_t(c[n]) for n in _SCAN]
    if "flat" in given:
        args[1:] = [a.reshape(-1) for a in args[1:]]
    kw = {"point": _t(c["point"]), "wts": table, "do": _t(c["do"]),
          "words": torch.zeros((c["keys"].shape[0], 1), dtype=torch.int32)}
    kw = {k: v for k, v in kw.items() if k in given}
    return (lambda: K.iterate_validate(*args, c["wave"], c["fine"],
                                       c["bucket_size"], c["ext_cap"], **kw),
            table, c["wts"].copy())


def _dual_call(given):
    """A validate_dual call: ``install`` where given, the lane priority
    int32[T] (``lane``) or a priority per op."""
    _, c = DUAL_CASES[0]
    table = _t(c["claim_w"])
    keys = _t(c["keys"])
    prio = _t(c["prio"]) if "lane" in given else \
        _t(c["prio"])[:, None].expand(keys.shape).contiguous()
    if "flat" in given:
        keys, prio = keys.reshape(-1), prio.reshape(-1)
    kw = {"install": _t(c["install"]).reshape(keys.shape)} \
        if "install" in given else {}
    return (lambda: K.validate_dual(table, keys, _t(c["groups"]).reshape(
        keys.shape), prio, _t(c["check"]).reshape(keys.shape), c["wave"],
        **kw), table, c["claim_w"].copy())


BAD_FOLD_ARGS = {
    "iterate_validate-point-alone": (_bump_call, ("point",),
                                     "come together"),
    "iterate_validate-point-and-wts": (_bump_call, ("point", "wts"),
                                       "come together"),
    "iterate_validate-wts-and-do": (_bump_call, ("wts", "do"),
                                    "come together"),
    "iterate_validate-bump-and-words": (_bump_call,
                                        ("point", "wts", "do", "words"),
                                        "no words"),
    "iterate_validate-bump-flat-keys": (_bump_call,
                                        ("point", "wts", "do", "flat"),
                                        r"\[T, K\]"),
    "validate_dual-install-per-op-prio": (_dual_call, ("install",),
                                          "lane priority"),
    "validate_dual-lane-prio-no-install": (_dual_call, ("lane",),
                                           "lane priority"),
    "validate_dual-install-flat-keys": (_dual_call,
                                        ("install", "lane", "flat"),
                                        "lane priority"),
}


@pytest.mark.parametrize("bad", BAD_FOLD_ARGS.values(),
                         ids=list(BAD_FOLD_ARGS))
def test_folded_forms_refuse_mixed_arguments(bad):
    """A mixed call raises ValueError before it touches a table."""
    make, given, msg = bad
    call, table, before = make(given)
    with pytest.raises(ValueError, match=msg):
        call()
    np.testing.assert_array_equal(_u32(table), before)


TPCC_SCANS = TPCCWorkload.make(n_warehouses=8, scale=0.01, scan_len=16)
YCSB_E = YCSBWorkload.make(n_keys=2000, theta=0.9, scan_frac=0.5,
                           scan_len=8)
TPCC = TPCCWorkload.make(n_warehouses=8, scale=0.01)
LANES, WAVES, SEED = 16, 5, 29


@pytest.mark.parametrize("wl,cc,gran", [
    (TPCC_SCANS, jt.CC_OCC, 0), (YCSB_E, jt.CC_2PL, 1),
    (TPCC_SCANS, jt.CC_SWISS, 1), (YCSB_E, jt.CC_ADAPTIVE, 0)],
    ids=["tpcc-scans-occ-coarse", "ycsb-e-2pl-fine",
         "tpcc-scans-swisstm-fine", "ycsb-e-adaptive-coarse"])
def test_fused_scan_waves_bump_in_iterate_validate_and_match_jax(wl, cc,
                                                                 gran):
    """wts, claim tables, counters and causes stay JAX's with one
    iterate_validate call and no commit_install call a wave."""
    draws = jax_draws(wl, LANES, WAVES, seed=SEED)
    K.reset_launches()
    state = assert_engine_parity(wl, cc, gran, LANES, draws, seed=SEED)
    assert K.iterate_validate.calls == WAVES
    assert K.commit_install.calls == 0
    assert sum(K.launch_counts().values()) == 0
    assert int(state.commits) > 0
    assert int(state.abort_causes[jt.CAUSE_PHANTOM]) > 0


@pytest.mark.parametrize("wl,scans", [(TPCC_SCANS, True), (YCSB_E, True),
                                      (TPCC, False)],
                         ids=["tpcc-scans", "ycsb-e", "tpcc-point"])
def test_autogran_installs_in_validate_dual_and_matches_jax(wl, scans):
    """wts, the claim table, fine_mode, the heats and the causes stay
    JAX's with one validate_dual call and no claim_scatter call a wave;
    with scans the bumps ride the wave's one iterate_validate call, on
    the point mix one commit_install call a wave."""
    draws = jax_draws(wl, LANES, WAVES, seed=SEED)
    K.reset_launches()
    state = assert_engine_parity(wl, jt.CC_AUTOGRAN, 0, LANES, draws,
                                 seed=SEED)
    calls = K.call_counts()
    assert calls["validate_dual"] == WAVES and calls["claim_scatter"] == 0
    assert calls["iterate_validate"] == (WAVES if scans else 0)
    assert calls["commit_install"] == (0 if scans else WAVES)
    assert sum(K.launch_counts().values()) == 0
    assert int(state.commits) > 0 and int(state.aborts) > 0
    assert float(state.store.false_heat.sum()) > 0


def test_unfused_scan_route_still_bumps_through_commit_install():
    """The unfused route stays the term-by-term chain: one claim_probe,
    one iterate_validate and one commit_install call a wave, equal to
    JAX."""
    draws = jax_draws(TPCC_SCANS, LANES, WAVES, seed=SEED)
    K.reset_launches()
    assert_engine_parity(TPCC_SCANS, jt.CC_OCC, 1, LANES, draws, seed=SEED,
                         fuse_wave=False)
    calls = K.call_counts()
    assert calls["claim_probe"] == calls["iterate_validate"] == WAVES
    assert calls["commit_install"] == WAVES and calls["wave_commit"] == 0


def test_kernel_coverage_reports_the_folded_ops_not_run():
    """With scans the fused bumpers and AutoGran report commit_install
    "not_run"; AutoGran reports claim_scatter "not_run" on either mix."""
    rows = txn_bench.run_grid("tpcc", ["occ", "autogran"], (0,), [8], 2,
                              scale=0.01, scan_len=16, device="cpu")
    rows += txn_bench.run_grid("tpcc", ["autogran"], (0,), [8], 2,
                               scale=0.01, device="cpu")
    for r, scans in zip(rows, (True, True, False)):
        ops = r["kernel_ops"]
        assert ops["commit_install"] == ("not_run" if scans else "torch")
        assert ops["iterate_validate"] == ("torch" if scans else "not_run")
        if r["cc"] == "autogran":
            assert ops["claim_scatter"] == "not_run"
            assert ops["validate_dual"] == "torch"
