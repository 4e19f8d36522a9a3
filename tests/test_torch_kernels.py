"""The plain versions of the port's kernels against the JAX oracles.

Each plain version (the route a CPU tensor takes through the kernel
wrapper) must be bit-identical to the ``repro.kernels.ref`` function of
the same name on the same numpy inputs: duplicate cells, masked keys
(-1), stale wave tags, waves whose tag has its top bit clear, both
granularities, every flag.  ``segment_count``, ``ts_gather``,
``ts_install_max``, ``commit_install`` and ``claim_scatter`` are also held
against their Pallas kernels in interpret mode; the Pallas kernels of
``wave_commit``, ``claim_probe`` and ``validate_dual`` do not run on this
JAX version, so ``ref`` is their reference.  The CUDA kernels are held
against these plain versions in tests/test_torch_cuda.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.claimword import claim_word as jax_claim_word
from repro.kernels import ops, ref
from repro_torch import kernels as K

T, KS, N, G = 6, 5, 11, 2  # few records: many duplicate cells


def _words_t(a):
    return torch.from_numpy(np.asarray(a, np.uint32).view(np.int32).copy())


def _u32(t):
    return t.numpy().view(np.uint32)


def _ops(rng, T=T, K=KS, N=N, G=G):
    keys = rng.integers(0, N, (T, K)).astype(np.int32)
    keys[rng.random((T, K)) < 0.2] = -1
    groups = rng.integers(0, G, (T, K)).astype(np.int32)
    return keys, groups


def _claim_table(rng, wave, N=N, G=G):
    """Claim words from stale waves, the empty word, and live claims of
    this wave already installed — never a wave newer than ``wave`` (the
    monotone-tag precondition)."""
    old = np.asarray(jax_claim_word(
        jnp.asarray(np.maximum(wave - rng.integers(1, 4, (N, G)), 0),
                    jnp.uint32),
        jnp.asarray(rng.integers(0, 1 << 16, (N, G)), jnp.uint32)))
    live = np.asarray(jax_claim_word(
        jnp.uint32(wave),
        jnp.asarray(rng.integers(0, 1 << 16, (N, G)), jnp.uint32)))
    pick = rng.random((N, G))
    return np.where(pick < 0.2, np.uint32(0xFFFFFFFF),
                    np.where(pick < 0.35, live, old)).astype(np.uint32)


def _masks(rng, n, shape=(T, KS)):
    return [rng.random(shape) < 0.5 for _ in range(n)]


def _wave_commit_case(seed, wave, fine, dual, bump, optional):
    rng = np.random.default_rng(seed)
    keys, groups = _ops(rng)
    lane_prio = ((63 << 10) | rng.permutation(T)).astype(np.uint32)
    prio = np.broadcast_to(lane_prio[:, None], (T, KS)).copy()
    claim_w = _claim_table(rng, wave)
    claim_r = _claim_table(rng, wave)
    wts = rng.integers(0, 1 << 32, (N, G), dtype=np.uint64).astype(np.uint32)
    wts[0, 0] = 0xFFFFFFFF  # the +1 bump wraps
    do_w, do_r, check_w, check_w2, check_r, extra = _masks(rng, 6)
    extra = extra & (rng.random((T, KS)) < 0.1)
    if not optional:
        # The oracle needs check_r whenever dual.
        check_w2 = extra = None
        check_r = check_r if dual else None
    return dict(claim_w=claim_w, claim_r=claim_r, wts=wts, keys=keys,
                groups=groups, prio=prio, do_w=do_w, do_r=do_r,
                check_w=check_w, check_w2=check_w2, check_r=check_r,
                extra=extra)


@pytest.mark.parametrize("optional", [True, False],
                         ids=["all-masks", "absent-masks"])
@pytest.mark.parametrize("bump", [True, False], ids=["bump", "nobump"])
@pytest.mark.parametrize("dual", [True, False], ids=["dual", "single"])
@pytest.mark.parametrize("fine", [True, False], ids=["fine", "coarse"])
def test_wave_commit_plain_matches_ref(fine, dual, bump, optional):
    for seed, wave in ((1, 5), (2, 70_000)):
        c = _wave_commit_case(seed, wave, fine, dual, bump, optional)
        j = {k: (None if v is None else jnp.asarray(v)) for k, v in c.items()}
        cw, cr, wts, conflict, commit = ref.wave_commit(
            j["claim_w"], j["claim_r"] if dual else None,
            j["wts"] if bump else None, j["keys"], j["groups"], j["prio"],
            j["do_w"], j["do_r"] if dual else None, j["check_w"],
            j["check_w2"], j["check_r"] if dual else None, j["extra"],
            jnp.uint32(wave), fine, dual, bump)
        tw, tr, tt = (_words_t(c["claim_w"]), _words_t(c["claim_r"]),
                      _words_t(c["wts"]))

        def tb(name):
            return None if c[name] is None else torch.from_numpy(c[name])
        got_conflict, got_commit = K.wave_commit(
            tw, tr, tt, torch.from_numpy(c["keys"]),
            torch.from_numpy(c["groups"]),
            _words_t(c["prio"]), tb("do_w"), tb("do_r"), tb("check_w"),
            tb("check_w2"), tb("check_r"), tb("extra"), wave, fine, dual,
            bump)
        np.testing.assert_array_equal(got_conflict.numpy(),
                                      np.asarray(conflict))
        np.testing.assert_array_equal(got_commit.numpy(), np.asarray(commit))
        np.testing.assert_array_equal(_u32(tw), np.asarray(cw))
        np.testing.assert_array_equal(
            _u32(tr), np.asarray(cr) if dual else c["claim_r"])
        np.testing.assert_array_equal(
            _u32(tt), np.asarray(wts) if bump else c["wts"])
    assert K.wave_commit.launches == 0


@pytest.mark.parametrize("G_", [1, 2])
def test_segment_count_plain_matches_ref_and_pallas(G_):
    rng = np.random.default_rng(11 + G_)
    keys, groups = _ops(rng, G=G_)
    mask = rng.random((T, KS)) < 0.7  # masked-true ops with key -1 too
    want = np.asarray(ref.segment_count(jnp.asarray(keys), jnp.asarray(groups),
                                        G_, jnp.asarray(mask)))
    pallas = np.asarray(ops.segment_count(
        jnp.asarray(keys), jnp.asarray(groups), G_, jnp.asarray(mask),
        use_pallas=True))
    got = K.segment_count(torch.from_numpy(keys), torch.from_numpy(groups),
                          G_, torch.from_numpy(mask))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(pallas, want)
    assert K.segment_count.launches == 0


@pytest.mark.parametrize("fine", [True, False], ids=["fine", "coarse"])
def test_ts_gather_plain_matches_ref_and_pallas(fine):
    rng = np.random.default_rng(21)
    keys, groups = _ops(rng)
    table = rng.integers(0, 1 << 32, (N, G), dtype=np.uint64).astype(
        np.uint32)
    want = np.asarray(ref.ts_gather(jnp.asarray(table), jnp.asarray(keys),
                                    jnp.asarray(groups), fine))
    pallas = np.asarray(ops.ts_gather(jnp.asarray(table), jnp.asarray(keys),
                                      jnp.asarray(groups), fine,
                                      use_pallas=True))
    got = K.ts_gather(_words_t(table), torch.from_numpy(keys),
                      torch.from_numpy(groups), fine)
    np.testing.assert_array_equal(_u32(got), want)
    np.testing.assert_array_equal(pallas, want)
    assert K.ts_gather.launches == 0


@pytest.mark.parametrize("whole_row", [False, True],
                         ids=["cell", "whole-row"])
def test_ts_install_max_plain_matches_ref_and_pallas(whole_row):
    rng = np.random.default_rng(31)
    keys, groups = _ops(rng)
    table = rng.integers(0, 1 << 32, (N, G), dtype=np.uint64).astype(
        np.uint32)
    vals = rng.integers(0, 1 << 32, (T, KS), dtype=np.uint64).astype(
        np.uint32)
    mask = rng.random((T, KS)) < 0.6
    args = (jnp.asarray(keys), jnp.asarray(groups), jnp.asarray(vals),
            jnp.asarray(mask))
    want = np.asarray(ref.ts_install_max(jnp.asarray(table), *args,
                                         whole_row))
    pallas = np.asarray(ops.ts_install_max(jnp.asarray(table), *args,
                                           whole_row, use_pallas=True))
    tt = _words_t(table)
    out = K.ts_install_max(tt, torch.from_numpy(keys),
                           torch.from_numpy(groups), _words_t(vals),
                           torch.from_numpy(mask), whole_row)
    assert out is tt  # updated in place
    np.testing.assert_array_equal(_u32(tt), want)
    np.testing.assert_array_equal(pallas, want)
    assert K.ts_install_max.launches == 0



# Waves whose claim tag (inv_wave) has its top bit set (5) and clear
# (40_000: the words are then positive as int32 bit patterns).
WAVES = [5, 40_000]


def _claim_ops(rng, wave):
    """Ops with duplicate and masked keys, a claim table with stale, empty
    and live words, and lane priorities."""
    keys, groups = _ops(rng)
    table = _claim_table(rng, wave)
    lane_prio = ((63 << 10) | rng.permutation(T)).astype(np.uint32)
    prio = np.broadcast_to(lane_prio[:, None], (T, KS)).copy()
    return keys, groups, table, prio, rng.random((T, KS)) < 0.6


def test_commit_install_plain_matches_ref_and_pallas():
    rng = np.random.default_rng(41)
    keys, groups = _ops(rng)
    wts = rng.integers(0, 1 << 32, (N, G), dtype=np.uint64).astype(np.uint32)
    do = rng.random((T, KS)) < 0.7
    i = np.argwhere(do & (keys >= 0))[0]
    wts[keys[tuple(i)], groups[tuple(i)]] = 0xFFFFFFFF  # its +1 wraps
    args = (jnp.asarray(keys), jnp.asarray(groups), jnp.asarray(do))
    want = np.asarray(ref.occ_commit(jnp.asarray(wts), *args))
    pallas = np.asarray(ops.occ_commit(jnp.asarray(wts), *args,
                                       use_pallas=True))
    tw = _words_t(wts)
    assert K.commit_install(tw, torch.from_numpy(keys),
                            torch.from_numpy(groups),
                            torch.from_numpy(do)) is None  # in place
    np.testing.assert_array_equal(_u32(tw), want)
    np.testing.assert_array_equal(pallas, want)
    assert (want != wts).any()
    assert K.commit_install.launches == 0


@pytest.mark.parametrize("wave", WAVES)
def test_claim_scatter_plain_matches_ref_and_pallas(wave):
    rng = np.random.default_rng(51 + wave % 7)
    keys, groups, table, prio, mask = _claim_ops(rng, wave)
    args = (jnp.asarray(keys), jnp.asarray(groups), jnp.asarray(prio),
            jnp.asarray(mask), jnp.uint32(wave))
    want = np.asarray(ref.claim_scatter(jnp.asarray(table), *args))
    pallas = np.asarray(ops.claim_scatter(jnp.asarray(table), *args,
                                          use_pallas=True))
    tt = _words_t(table)
    K.claim_scatter(tt, torch.from_numpy(keys), torch.from_numpy(groups),
                    _words_t(prio), wave, torch.from_numpy(mask))
    np.testing.assert_array_equal(_u32(tt), want)
    np.testing.assert_array_equal(pallas, want)
    assert (want != table).any()
    assert K.claim_scatter.launches == 0


@pytest.mark.parametrize("wave", WAVES)
def test_validate_dual_plain_matches_ref(wave):
    rng = np.random.default_rng(61 + wave % 7)
    keys, groups, table, prio, check = _claim_ops(rng, wave)
    groups[0, :2] = G  # out of range: no conflict on the fine side
    want_f, want_c = ref.occ_validate_dual(
        jnp.asarray(table), jnp.asarray(keys), jnp.asarray(groups),
        jnp.asarray(prio), jnp.asarray(check), jnp.uint32(
            0xFFFF - (wave & 0xFFFF)))
    fine, coarse = K.validate_dual(
        _words_t(table), torch.from_numpy(keys), torch.from_numpy(groups),
        _words_t(prio), torch.from_numpy(check), wave)
    np.testing.assert_array_equal(fine.numpy(), np.asarray(want_f))
    np.testing.assert_array_equal(coarse.numpy(), np.asarray(want_c))
    assert np.asarray(want_c).any() and not np.array_equal(want_f, want_c)
    assert K.validate_dual.launches == 0


@pytest.mark.parametrize("wave", WAVES)
@pytest.mark.parametrize("fine", [True, False], ids=["fine", "coarse"])
def test_claim_probe_plain_matches_ref(fine, wave):
    rng = np.random.default_rng(71 + wave % 7)
    keys, groups, table, prio, mask = _claim_ops(rng, wave)
    want_t, want_p = ref.claim_probe_fused(
        jnp.asarray(table), jnp.asarray(keys), jnp.asarray(groups),
        jnp.asarray(prio), jnp.asarray(mask), jnp.uint32(wave), fine)
    tt = _words_t(table)
    got = K.claim_probe(tt, torch.from_numpy(keys), torch.from_numpy(groups),
                        _words_t(prio), wave, torch.from_numpy(mask), fine)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(_u32(tt), np.asarray(want_t))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want_p))
    assert K.claim_probe.launches == 0
