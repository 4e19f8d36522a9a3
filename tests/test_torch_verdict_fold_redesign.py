"""The sharded wave's verdict pack and unpack folded into the launches
beside them, held against the JAX package.

The owner's claim launch writes the packed verdict words itself
(``wave_commit(..., pack=True)``, ``claim_probe``'s verdict form on one
table and on two with the ring), ``iterate_validate`` ORs the scan
verdicts into them (``words=``, bit 0 or 1), and the owner's install
launches read the arrived commit words (``commit_install`` and
``mv_install`` with ``words=``); the sender calls ``verdict_unpack`` and
``verdict_pack`` once each, in their gather forms.  ``chip_smoke.py``
holds every CUDA form against its plain version on
``chip_smoke.verdict_fold_cases``.  Here, on the CPU, each plain form
meets, bit for bit and on exactly those cases (made with numpy from a
seed), the chain it replaces written with the port's plain ops and the
JAX chain of ``src/repro/core/distributed.py``: ``ref.wave_commit`` or
``ref.claim_probe_fused`` (and ``ref.mv_gather``), the verdict bits,
``ref.iterate_validate`` and ``ref.verdict_pack``; ``ref.verdict_unpack``
before ``ref.occ_commit`` and ``ref.mv_install``; the sender's gather and
lane map around ``ref.verdict_unpack`` and ``ref.verdict_pack``.  The
cases are shown to reach their edges and the forms refuse mixed
arguments.  One-rank gloo runs of OCC fused and unfused, MVCC and MV-OCC,
with and without scans, stay bit-identical to JAX ``make_wave_fn`` and
call ``verdict_pack`` and ``verdict_unpack`` once a wave each.  The CUDA
kernels run on the same cases in tests/test_torch_cuda.py.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from repro.core import distributed as JD
from repro.kernels import ref
from repro_torch import kernels as K
from repro_torch.core import convert
from repro_torch.core import distributed as D
from repro_torch.kernels.claim_probe import claim_probe_plain
from repro_torch.kernels.iterate_validate import iterate_validate_plain
from repro_torch.kernels.mv_gather import mv_gather_plain
from repro_torch.kernels.mv_install import mv_install_plain
from repro_torch.kernels.occ_commit import commit_install_plain
from repro_torch.kernels.verdict_pack import (verdict_pack_plain,
                                              verdict_unpack_plain)
from repro_torch.kernels.wave_commit import wave_commit_plain
from repro_torch.launch.mesh import close_shards, init_shards
from test_torch_dist_single import draws as dist_draws
from test_torch_dist_single import jax_run as dist_jax_run
from test_torch_dist_single import port_run as dist_port_run

CASES = chip_smoke.verdict_fold_cases()
IDS = [label for label, _ in CASES]
H100_THREADS = chip_smoke.H100_SMS * chip_smoke.SM_THREADS
B = 8          # the coarse interval bucket of the fold cases


def _t(x):
    return torch.from_numpy(
        (x.view(np.int32) if x.dtype == np.uint32 else x).copy())


def _u(x):
    """A port tensor (int32 words) as numpy uint32."""
    x = x.numpy()
    return x.view(np.uint32) if x.dtype == np.int32 else x


def _ivw(wave):
    return jnp.uint32(0xFFFF - (wave & 0xFFFF))


@functools.lru_cache(maxsize=None)
def _jax_owner(i):
    """JAX's owner chains on CASES[i] (core/distributed.py's owner_claim):
    the fused OCC words and post-install table, the phantom flags, the
    unfused OCC words and table, the MV words and both tables."""
    c = CASES[i][1]
    j = {k: jnp.asarray(v) for k, v in c.items()
         if isinstance(v, np.ndarray)}
    prio = jnp.asarray(c["prio"].astype(np.uint32))
    wave, fine = jnp.uint32(c["wave"]), c["fine"]
    kg = (j["keys"], j["groups"], prio)
    cw, _, _, conflict, _ = ref.wave_commit(
        j["claim_w"], None, None, *kg, j["is_w"], None, j["is_rp"], None,
        None, None, wave, fine, False, False)
    occ = ref.verdict_pack(conflict.astype(jnp.int8))
    ph = ref.iterate_validate(cw, j["keys"], j["ext"], j["groups"], prio,
                              j["is_sc"], _ivw(c["wave"]), fine, B,
                              chip_smoke.FOLD_EXT_CAP)
    # The unfused OCC claim and the MV writer channel install and probe
    # the same table with the same mask.
    tw, wprio_w = ref.claim_probe_fused(j["claim_w"], *kg, j["is_w"], wave,
                                        fine)
    unf = ref.verdict_pack((j["is_rp"] & (wprio_w < prio)).astype(jnp.int8))
    tr, wprio_r = ref.claim_probe_fused(j["claim_r"], *kg, j["is_pw"], wave,
                                        fine)
    _, ok = ref.mv_gather(j["begin"], j["keys"], j["groups"],
                          jnp.uint32(c["snap_ts"]), fine)
    is_ad = j["is_w"] & ~j["is_pw"]
    uncond = ((j["is_pw"] & (wprio_w < prio)) | (is_ad & (wprio_r < prio))
              | (j["is_r"] & ~ok))
    rdval = j["is_rp"] & (wprio_w < prio)
    mv = ref.verdict_pack(uncond.astype(jnp.int8)
                          | (rdval.astype(jnp.int8) << 1))
    out = dict(occ=occ, cw=cw, ph=ph, unf=unf, t1=tw, mv=mv, tw=tw, tr=tr)
    return {k: np.asarray(v) for k, v in out.items()}


def _words(x):
    return np.asarray(x).view(np.uint32)


@pytest.mark.parametrize("i", range(len(CASES)), ids=IDS)
def test_owner_claim_words_match_jax(i):
    """wave_commit's packed form and claim_probe's verdict forms on the
    CPU equal the port's chain (the answer forms, the verdict bits,
    verdict_pack_plain) and JAX's chain, words and installed tables."""
    c, want = CASES[i][1], _jax_owner(i)
    a = {k: _t(v) for k, v in c.items() if isinstance(v, np.ndarray)}
    kg = (a["keys"], a["groups"], a["prio"])
    wave, fine = c["wave"], c["fine"]
    K.reset_launches()
    cw = a["claim_w"].clone()
    words, _ = K.wave_commit(cw, None, None, *kg, a["is_w"], None,
                             a["is_rp"], None, None, None, wave, fine, False,
                             False, pack=True)
    cw2 = a["claim_w"].clone()
    conflict, _ = wave_commit_plain(cw2, None, None, *kg, a["is_w"], None,
                                    a["is_rp"], None, None, None, wave, fine,
                                    False, False)
    chain = verdict_pack_plain(conflict.to(torch.int8))
    for got in (words, chain):
        np.testing.assert_array_equal(_u(got), _words(want["occ"]))
    np.testing.assert_array_equal(_u(cw), want["cw"])
    # Unfused OCC: one table.
    t1 = a["claim_w"].clone()
    words = K.claim_probe(t1, *kg, wave, a["is_w"], fine, is_rp=a["is_rp"])
    t1c = a["claim_w"].clone()
    wprio = claim_probe_plain(t1c, *kg, wave, a["is_w"], fine)
    chain = verdict_pack_plain((a["is_rp"] & (wprio < a["prio"]))
                               .to(torch.int8))
    for got in (words, chain):
        np.testing.assert_array_equal(_u(got), _words(want["unf"]))
    np.testing.assert_array_equal(_u(t1), want["t1"])
    # MVCC/MV-OCC: two tables and the ring.
    tw, tr = a["claim_w"].clone(), a["claim_r"].clone()
    words = K.claim_probe(tw, *kg, wave, a["is_w"], fine, claim_r=tr,
                          mask_r=a["is_pw"], begin=a["begin"],
                          snap_ts=c["snap_ts"], is_r=a["is_r"],
                          is_rp=a["is_rp"])
    twc, trc = a["claim_w"].clone(), a["claim_r"].clone()
    ww = claim_probe_plain(twc, *kg, wave, a["is_w"], fine)
    wr = claim_probe_plain(trc, *kg, wave, a["is_pw"], fine)
    ok = mv_gather_plain(a["begin"], a["keys"], a["groups"], c["snap_ts"],
                         fine)[1]
    chain = verdict_pack_plain(chip_smoke._mv_verdicts(
        ww, wr, ok, a["prio"], a["is_w"], a["is_pw"], a["is_r"],
        a["is_rp"]))
    for got in (words, chain):
        np.testing.assert_array_equal(_u(got), _words(want["mv"]))
    np.testing.assert_array_equal(_u(tw), want["tw"])
    np.testing.assert_array_equal(_u(tr), want["tr"])
    assert sum(K.launch_counts().values()) == 0


@pytest.mark.parametrize("i", range(len(CASES)), ids=IDS)
def test_scan_verdicts_or_into_the_words_as_jax(i):
    """iterate_validate's words form ORs each phantom into bit 0 (OCC) or
    bit 1 (MV-OCC) of the claim launch's words: the port's chain (flags,
    shift, pack, OR) and JAX's (ref.iterate_validate, then the OR into
    the verdict bytes before ref.verdict_pack) agree."""
    c, want = CASES[i][1], _jax_owner(i)
    a = {k: _t(v) for k, v in c.items() if isinstance(v, np.ndarray)}
    cw = torch.from_numpy(want["cw"].view(np.int32).copy())
    iv = (cw, a["keys"], a["ext"], a["groups"], a["prio"], a["is_sc"],
          c["wave"], c["fine"], B, chip_smoke.FOLD_EXT_CAP)
    base = torch.from_numpy(_words(want["occ"]).view(np.int32).copy())
    flags = iterate_validate_plain(*iv)
    np.testing.assert_array_equal(flags.numpy(), want["ph"])
    occ_bytes = ref.verdict_unpack(jnp.asarray(want["occ"]), c["cap"])
    for bit in (0, 1):
        got = K.iterate_validate(*iv, words=base.clone(), bit=bit)
        chain = base | verdict_pack_plain(flags.to(torch.int8) << bit)
        jax_words = ref.verdict_pack(
            occ_bytes | (jnp.asarray(want["ph"]).astype(jnp.int8) << bit))
        for w in (got, chain):
            np.testing.assert_array_equal(_u(w), _words(jax_words))


@pytest.mark.parametrize("i", range(len(CASES)), ids=IDS)
def test_installs_read_the_commit_words_as_jax(i):
    """commit_install and mv_install with the arrived commit words equal
    the port's chain (verdict_unpack_plain, > 0, &, the plain install)
    and JAX's owner_install (ref.verdict_unpack, ref.occ_commit,
    ref.mv_install)."""
    c = CASES[i][1]
    a = {k: _t(v) for k, v in c.items() if isinstance(v, np.ndarray)}
    bump = jnp.asarray(c["is_w"]) & (ref.verdict_unpack(
        jnp.asarray(c["cwords"]), c["cap"]) > 0)
    args = (jnp.asarray(c["keys"]), jnp.asarray(c["groups"]), bump)
    want_wts = np.asarray(ref.occ_commit(jnp.asarray(c["wts"]), *args))
    want_b, want_h = ref.mv_install(jnp.asarray(c["begin"]),
                                    jnp.asarray(c["head"]), *args,
                                    jnp.uint32(c["ts"]))
    inst = (a["keys"], a["groups"], a["is_w"])
    chain_do = a["is_w"] & (verdict_unpack_plain(a["cwords"],
                                                 c["cap"]) > 0)
    wts, wts_c = a["wts"].clone(), a["wts"].clone()
    K.commit_install(wts, *inst, words=a["cwords"])
    commit_install_plain(wts_c, a["keys"], a["groups"], chain_do)
    for got in (wts, wts_c):
        np.testing.assert_array_equal(_u(got), want_wts)
    ring, ring_c = ((a["begin"].clone(), a["head"].clone())
                    for _ in range(2))
    K.mv_install(*ring, *inst, c["ts"], words=a["cwords"])
    mv_install_plain(*ring_c, a["keys"], a["groups"], chain_do, c["ts"])
    for b, h in (ring, ring_c):
        np.testing.assert_array_equal(_u(b), np.asarray(want_b))
        np.testing.assert_array_equal(h.numpy(), np.asarray(want_h))


@pytest.mark.parametrize("i", range(len(CASES)), ids=IDS)
def test_sender_gather_forms_match_jax(i):
    """verdict_unpack at the routing coordinates and verdict_pack through
    the lane channel equal the port's chains (the full-row plain op, the
    gather, the mask) and JAX's sender_commit chains."""
    c = CASES[i][1]
    a = {k: _t(v) for k, v in c.items() if isinstance(v, np.ndarray)}
    D_, cap, T = c["D"], c["cap"], c["commit"].shape[0]
    full = ref.verdict_unpack(jnp.asarray(c["vwords"]), cap)
    vv = full[jnp.clip(jnp.asarray(c["owner"]), 0, D_ - 1),
              jnp.clip(jnp.asarray(c["pos"]), 0, cap - 1)]
    want = np.asarray(jnp.where(jnp.asarray(c["took"]), vv, jnp.int8(0)))
    got = K.verdict_unpack(a["vwords"], cap, owner=a["owner"],
                           pos=a["pos"], took=a["took"])
    chain = chip_smoke._gather_chain(verdict_unpack_plain, a["vwords"], cap,
                                     a["owner"], a["pos"], a["took"])
    for g in (got, chain):
        np.testing.assert_array_equal(g.numpy(), want)
    lane = jnp.asarray(c["lane"])
    want = _words(ref.verdict_pack(jnp.where(
        lane >= 0, jnp.asarray(c["commit"])[jnp.clip(lane, 0, T - 1)]
        .astype(jnp.int8), jnp.int8(0))))
    got = K.verdict_pack(a["commit"], lane=a["lane"])
    chain = chip_smoke._lane_chain(verdict_pack_plain, a["commit"],
                                   a["lane"])
    for g in (got, chain):
        np.testing.assert_array_equal(_u(g), want)


def test_cases_reach_their_edges():
    """cap % 16 of 0 and 8 and cap = 8, 1, 3 and 8 rows, the one-card
    rows, empty rows, all-conflict words, every MV field value, bit 31,
    scan conflicts sharing a word, dropped ops, empty lane cells, and a
    wave past the H100's resident threads."""
    caps = {c["cap"] for _, c in CASES}
    assert {cap % 16 for cap in caps} == {0, 8} and 8 in caps
    assert {1, 3, 8} <= {c["D"] for _, c in CASES}
    assert {16384, 32768} <= caps
    assert any((c["keys"] < 0).all() for _, c in CASES)
    fields, full, bit31, shared = set(), 0, 0, 0
    for i, (_, c) in enumerate(CASES):
        w = _jax_owner(i)["mv"].view(np.uint32)
        for f in range(16):
            fields |= set(np.unique((w >> (2 * f)) & 3).tolist())
        full += int((w == 0xFFFFFFFF).sum())
        bit31 += int((w >= 1 << 31).sum())
        ph = np.pad(_jax_owner(i)["ph"], ((0, 0), (0, -c["cap"] % 16)))
        shared += int((ph.reshape(c["D"], -1, 16).sum(-1) >= 2).sum())
    assert fields == {0, 1, 2, 3} and full and bit31 and shared
    assert any((~c["took"] & (c["owner"] >= 0) & (c["owner"] < c["D"]))
               .any() for _, c in CASES)
    assert all((c["lane"] == -1).any() for _, c in CASES)
    assert max(c["keys"].size for _, c in CASES) > H100_THREADS


_M = torch.zeros((2, 24), dtype=torch.bool)
_Z = torch.zeros((2, 24), dtype=torch.int32)
_R = torch.zeros((64, 4, 2), dtype=torch.int32)
_W = torch.zeros((2, 2), dtype=torch.int32)
_O = torch.zeros((8,), dtype=torch.int32)


def _table():
    return torch.full((64, 2), -1, dtype=torch.int32)


def _one(**kw):
    """A claim_probe call on [2, 24] ops with ``kw``."""
    return lambda: K.claim_probe(_table(), _Z, _Z, _Z, 3, _M, True, **kw)


BAD_FOLD_ARGS = {
    "claim_probe-is_r-on-one-table": (_one(is_r=_M, is_rp=_M),
                                      "verdict form"),
    "claim_probe-ring-without-is_r": (
        _one(claim_r=_table(), mask_r=_M, begin=_R, snap_ts=5, is_rp=_M),
        "verdict form"),
    "claim_probe-two-tables-no-ring": (
        _one(claim_r=_table(), mask_r=_M, is_rp=_M), "verdict form"),
    "claim_probe-is_r-alone": (_one(is_r=_M), "verdict form"),
    "claim_probe-flat-keys": (
        lambda: K.claim_probe(_table(), _O, _O, _O, 3, _O > 0, True,
                              is_rp=_O > 0), r"keys \[D, M\]"),
    "iterate_validate-bit-2": (
        lambda: K.iterate_validate(_table(), _Z, _Z, _Z, _Z, _M, 3, True,
                                   8, 8, words=_W.clone(), bit=2),
        "bit 0 or 1"),
    "commit_install-flat-keys": (
        lambda: K.commit_install(_W, _O, _O, _O > 0, words=_W[:1]),
        r"keys \[D, M\]"),
    "mv_install-words-shape": (
        lambda: K.mv_install(_R, torch.zeros(64, dtype=torch.int32), _Z,
                             _Z, _M, 9, words=torch.zeros((2, 3),
                                                          dtype=torch.int32)),
        "shape"),
    "verdict_unpack-owner-alone": (
        lambda: K.verdict_unpack(_W, 24, owner=_O), "come together"),
    "verdict_pack-lane-with-2d-v": (
        lambda: K.verdict_pack(_M.to(torch.int8), lane=_Z), "gather form"),
}


@pytest.mark.parametrize("bad", BAD_FOLD_ARGS.values(),
                         ids=list(BAD_FOLD_ARGS))
def test_folded_forms_refuse_mixed_arguments(bad):
    call, msg = bad
    with pytest.raises(ValueError, match=msg):
        call()


@pytest.fixture(scope="module")
def shards():
    sh = init_shards("cpu")
    yield sh
    close_shards(sh)


#: One-rank sharded configurations: OCC fused and unfused, MVCC and
#: MV-OCC, with scans (intervals of up to 8 records) and without, and
#: route_cap = 8 (one partial verdict word a row, capacity drops).
SHARDED = [
    ("occ", 1, dict(route_cap=8)), ("occ", 0, dict(max_extent=8)),
    ("occ", 1, dict(fuse_wave=False, max_extent=8)),
    ("mvcc", 1, dict(max_extent=8)), ("mvocc", 0, dict(max_extent=8)),
    ("mvocc", 1, dict(route_cap=8)),
]


@pytest.mark.parametrize("cc,gran,kw", SHARDED,
                         ids=[f"{c}-{g}-{'-'.join(map(str, k.items()))}"
                              for c, g, k in SHARDED])
def test_sharded_wave_packs_once_a_wave_and_matches_jax(shards, cc, gran,
                                                        kw):
    """Commit masks, stats and tables bit-identical to JAX make_wave_fn on
    a (1,) mesh; verdict_pack and verdict_unpack called once a wave each
    (the sender's gather forms), the claim and the install call once a
    wave each, with the words."""
    jcfg = JD.DistConfig(n_records=96, n_groups=2, lanes_per_shard=12,
                         slots=6, granularity=gran, backend="jnp", cc=cc,
                         mv_depth=3 if cc != "occ" else 0, **kw)
    cfg = convert.dist_config_from_fields(dataclasses.asdict(jcfg))
    ds = dist_draws(sum(map(ord, cc)) + 7 * gran + len(kw),
                    scans=jcfg.max_extent > 1)
    want, want_tables = dist_jax_run(jcfg, jax.make_mesh((1,), ("data",)),
                                     ds)
    K.reset_launches()
    got, tables = dist_port_run(cfg, ds)
    calls = K.call_counts()
    claim = ("wave_commit" if cc == "occ" and cfg.fuse_wave
             else "claim_probe")
    install = "mv_install" if cfg.is_mv else "commit_install"
    for op in ("verdict_pack", "verdict_unpack", claim, install):
        assert calls[op] == len(ds), op
    assert sum(K.launch_counts().values()) == 0
    for w, ((jc, js), (pc, ps)) in enumerate(zip(want, got)):
        np.testing.assert_array_equal(pc, jc, err_msg=f"commit, wave {w}")
        np.testing.assert_array_equal(ps, js, err_msg=f"stats, wave {w}")
    for i, (a, b) in enumerate(zip(convert.dist_tables_to_numpy(cfg, tables),
                                   want_tables)):
        np.testing.assert_array_equal(a, b, err_msg=f"table {i}")
    stats = np.stack([s for _, s in got]).sum(axis=0)
    assert stats[D.STAT_ABORTS] > 0
    if "route_cap" in kw:
        assert stats[D.STAT_DROPPED_OPS] > 0
