"""TicToc's two timestamp reads and its commit_ts as one ``ts_gather``
call, and the multi-version waves' snapshot read (``mv_gather``'s select)
inside their ``validate`` and ``claim_probe`` calls, held against the JAX
package.

``chip_smoke.py`` holds the CUDA ``ts_gather`` TicToc form (one plain
launch a wave: both tables to commit_ts and ext_need) and the ring forms
of ``validate`` and the two-table ``claim_probe`` (the ring read inside
their cooperative launch; ``claim_probe`` takes the ring in its verdict
form only, the sharded owner's claim step) against their plain versions on
``chip_smoke.ts_gather_cases`` and ``chip_smoke.ring_fold_cases``.  Here,
on the CPU, the plain route of each form meets the JAX oracles bit for bit
on exactly those cases, made with numpy from a seed: ``ref.ts_gather``
twice and TicToc's uint32 arithmetic (src/repro/core/cc/tictoc.py);
``ref.claim_scatter`` into each table, ``ref.occ_validate`` per channel
and ``ref.mv_gather``; ``ref.claim_probe_fused`` per table,
``ref.mv_gather``, the owner's verdict bits and ``ref.verdict_pack``.
The cases are shown to reach each path of the new kernels, and the
folded forms refuse mixed arguments.  TicToc runs (TPC-C
and YCSB, coarse and fine, with and without scans) stay equal to JAX
``backend="jnp"`` with one ``ts_gather`` call a wave; local MVCC and
MV-OCC runs with one ``validate`` call and no ``mv_gather`` call a wave;
a one-rank gloo sharded MVCC and MV-OCC run with one ``claim_probe`` call
and no ``mv_gather`` call a wave.  The CUDA kernels run on the same cases
in tests/test_torch_cuda.py.
"""
import dataclasses
import functools

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

OBSERVE_CASES = chip_smoke.ts_gather_cases()
RING_CASES = chip_smoke.ring_fold_cases()
H100_THREADS = chip_smoke.H100_SMS * chip_smoke.SM_THREADS


def _t(x):
    return torch.from_numpy(
        (x.view(np.int32) if x.dtype == np.uint32 else x).copy())


@functools.lru_cache(maxsize=None)
def _ref_observe(i):
    """JAX TicToc's observation of OBSERVE_CASES[i]: ref.ts_gather of wts
    and of rts, then commit_ts and ext_need in uint32."""
    _, c = OBSERVE_CASES[i]
    keys, groups = jnp.asarray(c["keys"]), jnp.asarray(c["groups"])
    wts_op = ref.ts_gather(jnp.asarray(c["wts"]), keys, groups, c["fine"])
    rts_op = ref.ts_gather(jnp.asarray(c["rts"]), keys, groups, c["fine"])
    rd, wr = jnp.asarray(c["rd"]), jnp.asarray(c["wr"])
    ts_term = jnp.where(wr, rts_op + 1, jnp.where(rd, wts_op, 0))
    commit_ts = ts_term.max(axis=1)
    ext_need = rd & (commit_ts[:, None] > rts_op) & ~(
        jnp.asarray(c["extent"]) > 1)
    return (np.asarray(commit_ts).astype(np.int64), np.asarray(ext_need),
            np.asarray(rts_op))


@pytest.mark.parametrize("i", range(len(OBSERVE_CASES)),
                         ids=[c[0] for c in OBSERVE_CASES])
def test_ts_gather_tictoc_form_plain_matches_ref_on_card_cases(i):
    _, c = OBSERVE_CASES[i]
    want_ts, want_ext, _ = _ref_observe(i)
    K.reset_launches()
    commit_ts, ext_need = K.ts_gather(
        _t(c["wts"]), _t(c["keys"]), _t(c["groups"]), c["fine"],
        rts=_t(c["rts"]), rd=_t(c["rd"]), wr=_t(c["wr"]),
        extent=_t(c["extent"]))
    assert commit_ts.dtype == torch.int64 and ext_need.dtype == torch.bool
    np.testing.assert_array_equal(commit_ts.numpy(), want_ts)
    np.testing.assert_array_equal(ext_need.numpy(), want_ext)
    assert (K.ts_gather.calls, K.ts_gather.launches) == (1, 0)


def test_ts_gather_cases_reach_each_path():
    """Fine and coarse, G = 1 to 3; one op a lane, K off the warp, K wider
    than the 256-thread block and several strides; a write whose rts + 1
    wraps to 0 and so adds nothing to commit_ts; ops that both read and
    write, lanes that do neither (commit_ts 0); reads that need an
    extension, reads that do not, and point reads of extent 0 and -2 as
    well as scans; keys -1 and past the end, groups G and G + 2."""
    assert {c["fine"] for _, c in OBSERVE_CASES} == {True, False}
    assert {c["wts"].shape[1] for _, c in OBSERVE_CASES} == {1, 2, 3}
    assert {c["keys"].shape[1] for _, c in OBSERVE_CASES} == set(
        chip_smoke.OBSERVE_WIDTHS)
    assert max(chip_smoke.OBSERVE_WIDTHS) > 256
    wraps = both = idle = need = no_need = short = scans = 0
    for i, (_, c) in enumerate(OBSERVE_CASES):
        N, G = c["wts"].shape
        assert (c["keys"] == -1).any() and (c["keys"] >= N).any()
        assert (c["groups"] >= G).any()
        commit_ts, ext_need, rts_op = _ref_observe(i)
        wraps += int((c["wr"] & (rts_op == 0xFFFFFFFF)).sum())
        both += int((c["rd"] & c["wr"]).sum())
        idle += int((commit_ts == 0).sum())
        need += int(ext_need.sum())
        no_need += int((c["rd"] & ~ext_need & (c["extent"] <= 1)).sum())
        short += int((c["rd"] & (c["extent"] < 1)).sum())
        scans += int((c["rd"] & (c["extent"] > 1)).sum())
    assert wraps and both and idle and need and no_need and short and scans


@functools.lru_cache(maxsize=None)
def _ref_ring_ok(i):
    """ref.mv_gather's ok on RING_CASES[i]. A masked key (-1 or past the
    end) with an out-of-range group reads begin 0 in the oracle, a visible
    version, where the port (as the Pallas kernel) reads nothing: ok False
    (ROADMAP C.2)."""
    _, c = RING_CASES[i]
    N, _, G = c["begin"].shape
    _, ok = ref.mv_gather(jnp.asarray(c["begin"]), jnp.asarray(c["keys"]),
                          jnp.asarray(c["groups"]), jnp.uint32(c["snap_ts"]),
                          c["fine"])
    ok = np.asarray(ok)
    pinned = (((c["keys"] < 0) | (c["keys"] >= N))
              & ((c["groups"] < 0) | (c["groups"] >= G)) & c["fine"])
    assert ok[pinned].all()
    return np.where(pinned, False, ok)


@functools.lru_cache(maxsize=None)
def _ref_validate(i):
    """JAX's MV wave on RING_CASES[i]: claim_scatter into claim_w and
    claim_r, one occ_validate per channel, OR-ed; the tables."""
    _, c = RING_CASES[i]
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
    return (check(cw, c["check"]) | check(cr, c["check_r"]),
            np.asarray(cw), np.asarray(cr))


@pytest.mark.parametrize("i", range(len(RING_CASES)),
                         ids=[c[0] for c in RING_CASES])
def test_validate_ring_form_plain_matches_ref_on_card_cases(i):
    _, c = RING_CASES[i]
    want, want_cw, want_cr = _ref_validate(i)
    cw, cr = _t(c["claim_w"]), _t(c["claim_r"])
    K.reset_launches()
    conflict, ok = K.validate(
        cw, _t(c["keys"]), _t(c["groups"]), _t(c["prio"]), _t(c["check"]),
        c["wave"], c["fine"], claim_r=cr, check_r=_t(c["check_r"]),
        install_w=_t(c["install_w"]), install_r=_t(c["install_r"]),
        begin=_t(c["begin"]), snap_ts=c["snap_ts"])
    np.testing.assert_array_equal(conflict.numpy(), want)
    np.testing.assert_array_equal(ok.numpy(), _ref_ring_ok(i))
    np.testing.assert_array_equal(cw.numpy().view(np.uint32), want_cw)
    np.testing.assert_array_equal(cr.numpy().view(np.uint32), want_cr)
    assert (K.validate.calls, K.validate.launches) == (1, 0)
    assert K.mv_gather.calls == 0


def _ref_probe(c, table, mask):
    """ref.claim_probe_fused on one table at the lane priority.  An
    out-of-range group probes the oracle's take_along_axis fill
    (0xFFFFFFFF) on the fine side, where the port answers NO_PRIO (ROADMAP
    C.2): both mean no claimant."""
    prio = np.broadcast_to(c["prio"][:, None], c["keys"].shape)
    t, p = ref.claim_probe_fused(
        jnp.asarray(table), jnp.asarray(c["keys"]), jnp.asarray(c["groups"]),
        jnp.asarray(prio.astype(np.uint32)), jnp.asarray(mask),
        jnp.uint32(c["wave"]), c["fine"])
    p = np.asarray(p)
    fill = p == 0xFFFFFFFF
    assert not (fill & (c["groups"] < table.shape[1])).any()
    return np.asarray(t), np.where(fill, NO_PRIO, p)


@pytest.mark.parametrize("i", range(len(RING_CASES)),
                         ids=[c[0] for c in RING_CASES])
def test_claim_probe_ring_form_plain_matches_ref_on_card_cases(i):
    """The two-table claim_probe with the ring (its verdict form, the
    sharded MV owner's claim step) against JAX's owner chain:
    ref.claim_probe_fused per table, ref.mv_gather's ok, the verdict bits
    of src/repro/core/distributed.py and ref.verdict_pack."""
    _, c = RING_CASES[i]
    cw, cr = _t(c["claim_w"]), _t(c["claim_r"])
    prio = _t(c["prio"])[:, None].expand(c["keys"].shape).contiguous()
    K.reset_launches()
    words = K.claim_probe(
        cw, _t(c["keys"]), _t(c["groups"]), prio, c["wave"],
        _t(c["install_w"]), c["fine"], claim_r=cr,
        mask_r=_t(c["install_r"]), begin=_t(c["begin"]),
        snap_ts=c["snap_ts"], is_r=_t(c["is_r"]), is_rp=_t(c["is_rp"]))
    want_cw, want_w = _ref_probe(c, c["claim_w"], c["install_w"])
    want_cr, want_r = _ref_probe(c, c["claim_r"], c["install_r"])
    p = np.broadcast_to(c["prio"][:, None], c["keys"].shape).astype(np.int64)
    mask, mask_r = c["install_w"], c["install_r"]
    uncond = ((mask_r & (want_w < p)) | (mask & ~mask_r & (want_r < p))
              | (c["is_r"] & ~_ref_ring_ok(i)))
    rdval = c["is_rp"] & (want_w < p)
    want = ref.verdict_pack(jnp.asarray(
        uncond.astype(np.int8) | (rdval.astype(np.int8) << 1)))
    np.testing.assert_array_equal(words.numpy(), np.asarray(want))
    np.testing.assert_array_equal(cw.numpy().view(np.uint32), want_cw)
    np.testing.assert_array_equal(cr.numpy().view(np.uint32), want_cr)
    assert (K.claim_probe.calls, K.claim_probe.launches) == (1, 0)
    assert K.mv_gather.calls == 0


def test_ring_fold_cases_reach_each_path():
    """Fine and coarse, D = 4 and 1, G = 1 to 3, both claim-tag halves,
    ring stamps on both sides of 2**31; the waves' masks and overlapping
    ones; ops that see a version and ops that see none: empty slots, a
    record whose every slot is empty, a reclaimed snapshot (every stamp
    newer); keys -1 and past the end, groups G and G + 2, and the pinned
    corner of ROADMAP C.2; reads (point reads a subset) that see a
    version and reads that see none; a conflict; and a wave of more ops
    than an H100 keeps co-resident threads."""
    assert {c["fine"] for _, c in RING_CASES} == {True, False}
    assert {c["begin"].shape[1:] for _, c in RING_CASES} == {
        (4, 1), (4, 2), (4, 3), (1, 2)}
    assert {(0xFFFF - (c["wave"] & 0xFFFF)) >> 15
            for _, c in RING_CASES} == {0, 1}
    assert {c["snap_ts"] >> 31 for _, c in RING_CASES} == {0, 1}
    assert {label.split()[0] for label, _ in RING_CASES} == {"waves",
                                                             "overlap"}
    seen = empty = reclaimed = pinned = conflicts = 0
    read_seen = read_unseen = 0
    for i, (_, c) in enumerate(RING_CASES):
        N, D, G = c["begin"].shape
        assert (c["keys"] == -1).any() and (c["keys"] >= N).any()
        assert (c["groups"] == G).any() and (c["groups"] == G + 2).any()
        assert not (c["is_rp"] & ~c["is_r"]).any()
        ok = _ref_ring_ok(i)
        seen += int(ok.sum())
        read_seen += int((c["is_r"] & ok).sum())
        read_unseen += int((c["is_r"] & ~ok).sum())
        live = (c["keys"] >= 0) & (c["keys"] < N)
        rows = c["begin"][np.where(live, c["keys"], 0)]
        empty += int((live & (rows == 0xFFFFFFFF).all(axis=(-2, -1))).sum())
        reclaimed += int((live & ~ok & (rows != 0xFFFFFFFF).all(
            axis=(-2, -1))).sum())
        pinned += int((~live & (c["groups"] >= G) & c["fine"]).sum())
        conflicts += int(_ref_validate(i)[0].sum())
    assert seen and empty and reclaimed and pinned and conflicts
    assert read_seen and read_unseen
    assert max(c["keys"].size for _, c in RING_CASES) > H100_THREADS


def _ts_gather_call(given):
    """(call, table, its words before) of ts_gather with the TicToc
    keywords in ``given`` ("flat": keys of shape [T * K])."""
    _, c = OBSERVE_CASES[0]
    x = {n: _t(c[n]) for n in ("wts", "rts", "keys", "groups", "rd", "wr",
                               "extent")}
    if "flat" in given:
        x.update({n: x[n].reshape(-1) for n in ("keys", "groups", "rd",
                                                "wr", "extent")})
    kw = {n: x[n] for n in given if n != "flat"}
    return (lambda: K.ts_gather(x["wts"], x["keys"], x["groups"], c["fine"],
                                **kw), x["wts"], c["wts"])


def _validate_call(given):
    """(call, claim_w, its words before) of validate with the keywords in
    ``given``."""
    _, c = RING_CASES[0]
    x = {n: _t(c[n]) for n in ("claim_w", "claim_r", "keys", "groups",
                               "prio", "check", "check_r", "install_w",
                               "install_r", "begin")}
    x["snap_ts"] = c["snap_ts"]
    kw = {n: x[n] for n in given}
    return (lambda: K.validate(x["claim_w"], x["keys"], x["groups"],
                               x["prio"], x["check"], c["wave"], c["fine"],
                               **kw), x["claim_w"], c["claim_w"])


def _claim_probe_call(given):
    """(call, claim_w, its words before) of claim_probe with the keywords
    in ``given``."""
    _, c = RING_CASES[0]
    x = {n: _t(c[n]) for n in ("claim_w", "claim_r", "keys", "groups",
                               "install_w", "install_r", "begin", "is_r",
                               "is_rp")}
    prio = _t(c["prio"])[:, None].expand(c["keys"].shape).contiguous()
    pool = {"claim_r": x["claim_r"], "mask_r": x["install_r"],
            "begin": x["begin"], "snap_ts": c["snap_ts"], "is_r": x["is_r"],
            "is_rp": x["is_rp"]}
    kw = {n: pool[n] for n in given}
    return (lambda: K.claim_probe(x["claim_w"], x["keys"], x["groups"],
                                  prio, c["wave"], x["install_w"],
                                  c["fine"], **kw), x["claim_w"],
            c["claim_w"])


#: Argument sets the folded forms refuse, as (call, the keywords given,
#: the error): ts_gather's TicToc tensors apart and keys that are not
#: [T, K]; validate's ring without its snapshot, a snapshot alone and the
#: ring without the installs; claim_probe's ring without its snapshot,
#: with one table, and outside the verdict form (without is_r and is_rp,
#: or without is_rp).
_INSTALLS = ("claim_r", "check_r", "install_w", "install_r")
BAD_FOLD_ARGS = {
    "ts_gather-rts-alone": (_ts_gather_call, ("rts",), "come together"),
    "ts_gather-no-wr": (_ts_gather_call, ("rts", "rd", "extent"),
                        "come together"),
    "ts_gather-no-extent": (_ts_gather_call, ("rts", "rd", "wr"),
                            "come together"),
    "ts_gather-masks-alone": (_ts_gather_call, ("rd", "wr", "extent"),
                              "come together"),
    "ts_gather-flat-keys": (_ts_gather_call,
                            ("rts", "rd", "wr", "extent", "flat"),
                            r"\[T, K\]"),
    "validate-begin-alone": (_validate_call, _INSTALLS + ("begin",),
                             "begin and snap_ts"),
    "validate-snap-alone": (_validate_call, _INSTALLS + ("snap_ts",),
                            "begin and snap_ts"),
    "validate-ring-no-installs": (_validate_call,
                                  ("claim_r", "check_r", "begin",
                                   "snap_ts"), "begin and snap_ts"),
    "claim_probe-begin-alone": (_claim_probe_call,
                                ("claim_r", "mask_r", "begin"),
                                "begin and snap_ts"),
    "claim_probe-ring-one-table": (_claim_probe_call, ("begin", "snap_ts"),
                                   "begin and snap_ts"),
    "claim_probe-ring-answer-form": (_claim_probe_call,
                                     ("claim_r", "mask_r", "begin",
                                      "snap_ts"), "begin and snap_ts"),
    "claim_probe-ring-without-is_rp": (_claim_probe_call,
                                       ("claim_r", "mask_r", "begin",
                                        "snap_ts", "is_r"),
                                       "begin and snap_ts"),
}


@pytest.mark.parametrize("bad", BAD_FOLD_ARGS.values(),
                         ids=list(BAD_FOLD_ARGS))
def test_folded_forms_refuse_mixed_arguments(bad):
    """A mixed call raises ValueError before it touches a table."""
    make, given, msg = bad
    call, table, before = make(given)
    with pytest.raises(ValueError, match=msg):
        call()
    np.testing.assert_array_equal(table.numpy().view(np.uint32), before)


YCSB_E = YCSBWorkload.make(n_keys=2000, theta=0.9, scan_frac=0.5,
                           scan_len=8)
YCSB_MV = YCSBWorkload.make(n_keys=2000, theta=0.9, write_frac=0.8,
                            ro_frac=0.2)
TPCC_SCANS = TPCCWorkload.make(n_warehouses=8, scale=0.05, scan_len=16)
LANES, WAVES, SEED = 16, 5, 23


@pytest.mark.parametrize("wl,gran", [(YCSB_MV, 0), (YCSB_E, 0),
                                     (TPCC_SCANS, 1)],
                         ids=["ycsb-coarse", "ycsb-scans-coarse",
                              "tpcc-scans-fine"])
def test_tictoc_observes_once_a_wave_and_matches_jax(wl, gran):
    """wts, rts, counters and causes stay JAX's with one ts_gather call a
    wave (JAX makes two, then the arithmetic)."""
    draws = jax_draws(wl, LANES, WAVES, seed=SEED)
    K.reset_launches()
    state = assert_engine_parity(wl, jt.CC_TICTOC, gran, LANES, draws,
                                 seed=SEED)
    assert K.ts_gather.calls == WAVES
    assert sum(K.launch_counts().values()) == 0
    assert int(state.ext_events) > 0


@pytest.mark.parametrize("wl,cc,gran,kw", [
    (TPCC_SCANS, jt.CC_MVOCC, 1, {}),
    (YCSB_MV, jt.CC_MVCC, 0, {"snapshot_age": 6})],
    ids=["tpcc-scans-mvocc-fine", "ycsb-mvcc-coarse-aged"])
def test_mv_waves_read_the_ring_in_validate_and_match_jax(wl, cc, gran, kw):
    """Claim tables, the ring, counters and causes stay JAX's with one
    validate call a wave and no mv_gather call; snapshots older than the
    ring abort as stale."""
    draws = jax_draws(wl, LANES, WAVES, seed=SEED)
    K.reset_launches()
    state = assert_engine_parity(wl, cc, gran, LANES, draws, seed=SEED,
                                 **kw)
    assert K.validate.calls == WAVES and K.mv_gather.calls == 0
    assert sum(K.launch_counts().values()) == 0
    if kw:
        assert int(state.abort_causes[jt.CAUSE_STALE_SNAPSHOT]) > 0


@pytest.fixture(scope="module")
def shards():
    sh = init_shards("cpu")
    yield sh
    close_shards(sh)


@pytest.mark.parametrize("cc,gran", [("mvcc", 0), ("mvocc", 1)])
def test_sharded_mv_wave_reads_the_ring_in_claim_probe(shards, cc, gran):
    """One rank (gloo) against JAX make_wave_fn on a (1,) mesh: commit
    masks, stats and tables bit-identical, both claim channels and the
    ring read in one claim_probe call a wave, no mv_gather call."""
    jcfg = JD.DistConfig(n_records=96, n_groups=2, lanes_per_shard=12,
                         slots=6, granularity=gran, backend="jnp", cc=cc,
                         mv_depth=3)
    cfg = convert.dist_config_from_fields(dataclasses.asdict(jcfg))
    ds = dist_draws(sum(map(ord, cc)) + 11 * gran)
    want, want_tables = dist_jax_run(jcfg, jax.make_mesh((1,), ("data",)),
                                     ds)
    K.reset_launches()
    got, tables = dist_port_run(cfg, ds)
    assert K.claim_probe.calls == len(ds) and K.mv_gather.calls == 0
    for w, ((jc, js), (pc, ps)) in enumerate(zip(want, got)):
        np.testing.assert_array_equal(pc, jc, err_msg=f"commit, wave {w}")
        np.testing.assert_array_equal(ps, js, err_msg=f"stats, wave {w}")
    for i, (a, b) in enumerate(zip(convert.dist_tables_to_numpy(cfg, tables),
                                   want_tables)):
        np.testing.assert_array_equal(a, b, err_msg=f"table {i}")
