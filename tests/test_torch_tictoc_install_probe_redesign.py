"""TicToc's three timestamp installs as one ``ts_install_max`` call, and
``claim_probe`` on one or two claim tables as one call, held against the
JAX package.

``chip_smoke.py`` holds the CUDA ``ts_install_max`` (TicToc's three
installs in one plain launch, the stamps computed in the kernel) and
``claim_probe`` (one cooperative launch: the installs into one or both
tables, a grid barrier, the probes) against their plain versions on
``chip_smoke.ts_install_cases`` and ``chip_smoke.claim_probe_cases``.
Here, on the CPU, the plain route of each call form meets the JAX oracles
bit for bit on exactly those cases, made with numpy from a seed:
``ref.ts_install_max`` three times in the JAX TicToc order (the stamps as
JAX computes them), ``ref.claim_probe_fused`` once per table.  The cases
are shown to reach each path of the new kernels.  TicToc runs (TPC-C and
YCSB, coarse and fine, with and without scans) stay equal to JAX
``backend="jnp"`` with one ``ts_install_max`` call a wave; unfused 2PL and
Adaptive runs, and a one-rank gloo sharded MVCC and MV-OCC run, stay
equal to JAX with one ``claim_probe`` call a wave.  The CUDA kernels run
on the same cases in tests/test_torch_cuda.py.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from port_harness import assert_engine_parity, jax_draws
from repro.core import distributed as JD
from repro.core import types as jt
from repro.kernels import ref
from repro.workloads import TPCCWorkload, YCSBWorkload
from repro_torch import kernels as K
from repro_torch.core import convert
from repro_torch.core.claimword import NO_PRIO
from repro_torch.launch.mesh import close_shards, init_shards
from test_torch_dist_single import draws as dist_draws
from test_torch_dist_single import jax_run as dist_jax_run
from test_torch_dist_single import port_run as dist_port_run

TS_CASES = chip_smoke.ts_install_cases()
PROBE_CASES = chip_smoke.claim_probe_cases()
H100_THREADS = chip_smoke.H100_SMS * chip_smoke.SM_THREADS


def _t(x):
    if x is None:
        return None
    return torch.from_numpy(
        (x.view(np.int32) if x.dtype == np.uint32 else x).copy())


def _jax_stamps(c):
    """The install values as JAX TicToc makes them: commit_ts + 2 *
    (max(n_wcell, 1) - 1) in uint32."""
    cts = jnp.broadcast_to(jnp.asarray(c["commit_ts"].astype(np.uint32))
                           [:, None], c["keys"].shape)
    return cts + 2 * (jnp.maximum(jnp.asarray(c["n_chain"]), 1.0)
                      .astype(jnp.uint32) - 1)


def _ref_installs(c):
    """JAX TicToc's order: wts at mask, rts at mask, rts at ext."""
    keys, groups = jnp.asarray(c["keys"]), jnp.asarray(c["groups"])
    vals, mask = _jax_stamps(c), jnp.asarray(c["mask"])
    wts = ref.ts_install_max(jnp.asarray(c["wts"]), keys, groups, vals, mask,
                             False)
    rts = ref.ts_install_max(jnp.asarray(c["rts"]), keys, groups, vals, mask,
                             False)
    rts = ref.ts_install_max(rts, keys, groups, vals, jnp.asarray(c["ext"]),
                             c["ext_whole_row"])
    return np.asarray(wts), np.asarray(rts)


@pytest.mark.parametrize("case", TS_CASES, ids=[c[0] for c in TS_CASES])
def test_ts_install_forms_plain_match_ref_on_card_cases(case):
    _, c = case
    want_w, want_r = _ref_installs(c)
    wts, rts = _t(c["wts"]), _t(c["rts"])
    K.reset_launches()
    out = K.ts_install_max(wts, _t(c["keys"]), _t(c["groups"]), None,
                           _t(c["mask"]), rts=rts, ext=_t(c["ext"]),
                           ext_whole_row=c["ext_whole_row"],
                           commit_ts=_t(c["commit_ts"]),
                           n_chain=_t(c["n_chain"]))
    assert out is wts
    np.testing.assert_array_equal(wts.numpy().view(np.uint32), want_w)
    np.testing.assert_array_equal(rts.numpy().view(np.uint32), want_r)
    assert (K.ts_install_max.calls, K.ts_install_max.launches) == (1, 0)


def test_ts_install_cases_reach_each_path():
    """Masks empty and full, fine and coarse extensions, G = 1 to 3;
    keys -1 and past the end, groups G and G + 2; cells several ops
    install into, and cells both masks install into; table words and
    stamps on both sides of 2**31; stamps that wrap past 2**32; and a
    wave of more ops than an H100 keeps co-resident threads."""
    assert {c["wts"].shape[1] for _, c in TS_CASES} == {1, 2, 3}
    assert {c["ext_whole_row"] for _, c in TS_CASES} == {True, False}
    assert any(not c["mask"].any() for _, c in TS_CASES)
    assert any(c["mask"].all() and c["ext"].all() for _, c in TS_CASES)
    dup = both = wraps = 0
    halves = set()
    for _, c in TS_CASES:
        N, G = c["wts"].shape
        assert (c["keys"] == -1).any() and (c["keys"] >= N).any()
        assert (c["groups"] == G).any() and (c["groups"] == G + 2).any()
        ok = (c["keys"] >= 0) & (c["keys"] < N) & (c["groups"] < G)
        cells = c["keys"].astype(np.int64) * G + c["groups"]
        m = c["mask"] & ok
        dup += int((np.unique(cells[m], return_counts=True)[1] > 1).sum())
        both += len(np.intersect1d(cells[m], cells[c["ext"] & ok]))
        vals = np.asarray(_jax_stamps(c)).astype(np.int64)
        halves |= set((vals >> 31).ravel().tolist())
        halves |= {f"table{h}" for h in (c["wts"] >> 31).ravel().tolist()}
        raw = c["commit_ts"][:, None] + 2 * (
            np.maximum(c["n_chain"], 1).astype(np.int64) - 1)
        wraps += int((raw >= 1 << 32).sum())
    assert dup and both and wraps
    assert halves == {0, 1, "table0", "table1"}
    assert max(c["keys"].size for _, c in TS_CASES) > H100_THREADS


#: ts_install_max argument sets it refuses, as (the keywords given, vals
#: given, whole_row, keys flattened, the error): the three-install form's
#: tensors apart, given values or whole_row with them, the one-table form
#: without values, and keys that are not [T, K].
THREE = ("rts", "ext", "commit_ts", "n_chain")
BAD_TS_ARGS = {
    "ext-alone": (("ext",), False, False, False, "come together"),
    "rts-alone": (("rts",), False, False, False, "come together"),
    "no-stamps": (("rts", "ext"), False, False, False, "come together"),
    "no-chain": (THREE[:3], False, False, False, "come together"),
    "stamps-alone": (THREE[2:], True, False, False, "come together"),
    "vals": (THREE, True, False, False, "no vals and no whole_row"),
    "whole-row": (THREE, False, True, False, "no vals and no whole_row"),
    "no-vals": ((), False, False, False, "takes vals"),
    "flat-keys": (THREE, False, False, True, r"\[T, K\]"),
}


@pytest.mark.parametrize("bad", BAD_TS_ARGS.values(), ids=list(BAD_TS_ARGS))
def test_ts_install_refuses_mixed_forms(bad):
    given, vals, whole_row, flat, msg = bad
    _, c = TS_CASES[0]
    x = {n: _t(c[n]) for n in ("keys", "groups", "mask") + THREE}
    if flat:
        for n in ("keys", "groups", "mask", "ext", "n_chain"):
            x[n] = x[n].reshape(-1)
    v = _t(np.asarray(_jax_stamps(c))) if vals else None
    wts = _t(c["wts"])
    with pytest.raises(ValueError, match=msg):
        K.ts_install_max(wts, x["keys"], x["groups"], v, x["mask"],
                         whole_row, **{n: x[n] for n in given})
    np.testing.assert_array_equal(wts.numpy().view(np.uint32), c["wts"])


def test_chained_stamps_are_tictocs():
    """chain_stamps is the arithmetic TicToc's wave did before the fold:
    int64 sums masked to their low 32 bits."""
    from repro_torch.kernels.ts_install import chain_stamps
    _, c = TS_CASES[0]
    got = chain_stamps(_t(c["commit_ts"]), _t(c["n_chain"]))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  np.asarray(_jax_stamps(c)))


def _ref_probe(c, table, mask):
    """ref.claim_probe_fused on one table.  An out-of-range group probes
    the oracle's take_along_axis fill (0xFFFFFFFF) on the fine side, where
    the port answers NO_PRIO (ROADMAP C.2): both mean no claimant."""
    t, p = ref.claim_probe_fused(
        jnp.asarray(table), jnp.asarray(c["keys"]), jnp.asarray(c["groups"]),
        jnp.asarray(c["prio"].astype(np.uint32)), jnp.asarray(mask),
        jnp.uint32(c["wave"]), c["fine"])
    p = np.asarray(p)
    fill = p == 0xFFFFFFFF
    assert not (fill & (c["groups"] < table.shape[1])).any()
    return np.asarray(t), np.where(fill, NO_PRIO, p)


@pytest.mark.parametrize("case", PROBE_CASES,
                         ids=[c[0] for c in PROBE_CASES])
def test_claim_probe_forms_plain_match_ref_on_card_cases(case):
    _, c = case
    two = c["claim_r"] is not None
    cw, cr = _t(c["claim_w"]), _t(c["claim_r"])
    K.reset_launches()
    got = K.claim_probe(cw, _t(c["keys"]), _t(c["groups"]), _t(c["prio"]),
                        c["wave"], _t(c["mask"]), c["fine"], claim_r=cr,
                        mask_r=_t(c["mask_r"]))
    want_w, want_pw = _ref_probe(c, c["claim_w"], c["mask"])
    if two:
        got_w, got_r = got
        want_r, want_pr = _ref_probe(c, c["claim_r"], c["mask_r"])
        np.testing.assert_array_equal(got_r.numpy(), want_pr)
        np.testing.assert_array_equal(cr.numpy().view(np.uint32), want_r)
    else:
        got_w = got
    assert got_w.dtype == torch.int32
    np.testing.assert_array_equal(got_w.numpy(), want_pw)
    np.testing.assert_array_equal(cw.numpy().view(np.uint32), want_w)
    assert (K.claim_probe.calls, K.claim_probe.launches) == (1, 0)


def test_claim_probe_cases_reach_each_path():
    """One and two tables, fine and coarse, G = 1 to 3, both claim-tag
    halves, masks empty and full; ops with both, one or neither mask;
    cells several ops install into in both tables; keys -1 and past the
    end, groups G and G + 2; an op that sees its own lane's claim and one
    that sees a stronger lane's; and a two-table wave of more ops than an
    H100 keeps co-resident threads."""
    assert {c["claim_r"] is not None for _, c in PROBE_CASES} == {True,
                                                                  False}
    assert {c["fine"] for _, c in PROBE_CASES} == {True, False}
    assert {c["claim_w"].shape[1] for _, c in PROBE_CASES} == {1, 2, 3}
    assert {(0xFFFF - (c["wave"] & 0xFFFF)) >> 15
            for _, c in PROBE_CASES} == {0, 1}
    assert any(not c["mask"].any() for _, c in PROBE_CASES)
    assert any(c["mask"].all() for _, c in PROBE_CASES)
    flags = set()
    dup_w = dup_r = own = stronger = 0
    for _, c in PROBE_CASES:
        N, G = c["claim_w"].shape
        assert (c["keys"] == -1).any() and (c["keys"] >= N).any()
        assert (c["groups"] == G).any() and (c["groups"] == G + 2).any()
        ok = (c["keys"] >= 0) & (c["keys"] < N) & (c["groups"] < G)
        cells = c["keys"].astype(np.int64) * G + c["groups"]
        for mask, count in ((c["mask"], "w"), (c["mask_r"], "r")):
            if mask is None:
                continue
            dup = int((np.unique(cells[mask & ok],
                                 return_counts=True)[1] > 1).sum())
            if count == "w":
                dup_w += dup
            else:
                dup_r += dup
        if c["mask_r"] is not None:
            flags |= set(zip(c["mask"].ravel().tolist(),
                             c["mask_r"].ravel().tolist()))
        _, p = _ref_probe(c, c["claim_w"], c["mask"])
        own += int((p == c["prio"]).sum())
        stronger += int((p < c["prio"]).sum())
    assert flags == {(True, True), (True, False), (False, True),
                     (False, False)}
    assert dup_w and dup_r and own and stronger
    assert max(c["keys"].size for _, c in PROBE_CASES
               if c["claim_r"] is not None) > H100_THREADS


def test_claim_probe_second_table_comes_with_its_mask():
    _, c = PROBE_CASES[0]
    args = [_t(c[n]) for n in ("claim_w", "keys", "groups", "prio")]
    with pytest.raises(ValueError, match="claim_r and mask_r"):
        K.claim_probe(*args, c["wave"], _t(c["mask"]), c["fine"],
                      claim_r=_t(c["claim_w"]))


YCSB = YCSBWorkload.make(n_keys=2000, theta=0.9)
YCSB_E = YCSBWorkload.make(n_keys=2000, theta=0.9, scan_frac=0.5,
                           scan_len=8)
TPCC = TPCCWorkload.make(n_warehouses=8, scale=0.05)
TPCC_SCANS = TPCCWorkload.make(n_warehouses=8, scale=0.05, scan_len=16)
LANES, WAVES, SEED = 16, 8, 12


@pytest.mark.parametrize("wl,gran", [(YCSB, 0), (YCSB_E, 1), (TPCC, 1),
                                     (TPCC_SCANS, 0)],
                         ids=["ycsb-coarse", "ycsb-scans-fine", "tpcc-fine",
                              "tpcc-scans-coarse"])
def test_tictoc_installs_once_a_wave_and_matches_jax(wl, gran):
    """wts, rts, counters and causes stay JAX's with one ts_install_max
    call a wave (JAX makes three)."""
    draws = jax_draws(wl, LANES, WAVES, seed=SEED)
    K.reset_launches()
    state = assert_engine_parity(wl, jt.CC_TICTOC, gran, LANES, draws,
                                 seed=SEED)
    assert K.ts_install_max.calls == WAVES
    assert sum(K.launch_counts().values()) == 0
    assert int(state.ext_events) > 0


@pytest.mark.parametrize("wl,cc,gran", [(TPCC, jt.CC_2PL, 0),
                                        (YCSB, jt.CC_ADAPTIVE, 1)],
                         ids=["tpcc-2pl-coarse", "ycsb-adaptive-fine"])
def test_dual_unfused_waves_probe_once_a_wave_and_match_jax(wl, cc, gran):
    """The unfused route's dual waves install and probe both claim tables
    in one claim_probe call (JAX calls claim_probe once a table); state,
    claim tables included, stays JAX's."""
    draws = jax_draws(wl, LANES, WAVES, seed=SEED)
    K.reset_launches()
    assert_engine_parity(wl, cc, gran, LANES, draws, seed=SEED,
                         fuse_wave=False)
    assert K.claim_probe.calls == WAVES and K.wave_commit.calls == 0


@pytest.fixture(scope="module")
def shards():
    sh = init_shards("cpu")
    yield sh
    close_shards(sh)


@pytest.mark.parametrize("cc,gran", [("mvcc", 1), ("mvocc", 0)])
def test_sharded_mv_wave_probes_once_a_wave_and_matches_jax(shards, cc,
                                                            gran):
    """One rank (gloo) against JAX make_wave_fn on a (1,) mesh: commit
    masks, stats and tables bit-identical, both claim channels installed
    and probed by one claim_probe call a wave."""
    jcfg = JD.DistConfig(n_records=96, n_groups=2, lanes_per_shard=12,
                         slots=6, granularity=gran, backend="jnp", cc=cc,
                         mv_depth=3)
    cfg = convert.dist_config_from_fields(dataclasses.asdict(jcfg))
    ds = dist_draws(sum(map(ord, cc)) + 7 * gran)
    want, want_tables = dist_jax_run(jcfg, jax.make_mesh((1,), ("data",)),
                                     ds)
    K.reset_launches()
    got, tables = dist_port_run(cfg, ds)
    assert K.claim_probe.calls == len(ds)
    for w, ((jc, js), (pc, ps)) in enumerate(zip(want, got)):
        np.testing.assert_array_equal(pc, jc, err_msg=f"commit, wave {w}")
        np.testing.assert_array_equal(ps, js, err_msg=f"stats, wave {w}")
    for i, (a, b) in enumerate(zip(convert.dist_tables_to_numpy(cfg, tables),
                                   want_tables)):
        np.testing.assert_array_equal(a, b, err_msg=f"table {i}")
