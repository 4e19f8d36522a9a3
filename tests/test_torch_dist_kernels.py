"""The plain versions of the sharded wave's kernels against the JAX oracles.

``route_pack``, ``verdict_pack`` and ``verdict_unpack`` (the route a CPU
tensor takes through the wrappers) must be bit-identical to
``repro.kernels.ref`` and to the Pallas kernels in interpret mode on the
same numpy inputs: 1, 3 and 8 destinations, capacity drops, masked owners
(-1, n_dest and beyond), verdict rows whose length is not a multiple of 16
and words with bit 31 set.  ``wave_commit`` on rows wider than 1,024 ops
(the sharded owner's rows) is held against ``ref.wave_commit``.  The CUDA
kernels are held against these plain versions in tests/test_torch_cuda.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref
from repro.kernels.route_pack import route_pack_pallas
from repro.kernels.verdict_pack import (verdict_pack_pallas,
                                        verdict_unpack_pallas)
from repro_torch import kernels as K
from repro_torch.core.distributed import LANE_FILL, META_FILL, NO_OP

FILLS = (NO_OP, META_FILL, LANE_FILL)


def _route_case(rng, M, n_dest, skew):
    owner = rng.integers(0, n_dest, M)
    if skew:
        owner[:] = n_dest - 1
    owner = np.where(rng.random(M) < 0.15,
                     rng.choice([-1, n_dest, n_dest + 3], M), owner)
    vals = rng.integers(-2 ** 31, 2 ** 31, (3, M), dtype=np.int64)
    return owner.astype(np.int32), vals.astype(np.int32)


@pytest.mark.parametrize("n_dest", [1, 3, 8])
@pytest.mark.parametrize("M,cap,skew", [(100, 64, False), (100, 8, False),
                                        (301, 200, True)],
                         ids=["roomy", "drops", "skewed"])
def test_route_pack_plain_matches_ref_and_pallas(n_dest, M, cap, skew):
    rng = np.random.default_rng(n_dest * 7 + M + cap)
    owner, vals = _route_case(rng, M, n_dest, skew)
    want = ref.route_pack(jnp.asarray(owner), jnp.asarray(vals), n_dest, cap,
                          FILLS)
    pallas = route_pack_pallas(jnp.asarray(owner), jnp.asarray(vals), n_dest,
                               cap, FILLS, interpret=True)
    got = K.route_pack(torch.from_numpy(owner), torch.from_numpy(vals),
                       n_dest, cap, FILLS)
    for g, w, p in zip(got, want, pallas):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        np.testing.assert_array_equal(g.numpy(), np.asarray(p))
    buf, pos, took = got
    live = (owner >= 0) & (owner < n_dest)
    assert not took.numpy()[~live].any() and (pos.numpy()[~live] == 0).all()
    if cap == 8 or skew:
        assert (live & ~took.numpy()).any()   # the case drops ops


def test_route_pack_places_ops_in_stable_order():
    """A dropped op keeps its rank; the kept ops of a destination sit in
    flat-op order, as a stable argsort by owner puts them."""
    owner = np.array([1, 0, 1, 1, 5, 0, 1], np.int32)
    vals = np.arange(7, dtype=np.int32)[None, :]
    buf, pos, took = K.route_pack(torch.from_numpy(owner),
                                  torch.from_numpy(vals), 2, 3, (-9,))
    assert pos.tolist() == [0, 0, 1, 2, 0, 1, 3]
    assert took.tolist() == [True, True, True, True, False, True, False]
    assert buf[0].tolist() == [[1, 5, -9], [0, 2, 3]]


@pytest.mark.parametrize("D,M", [(1, 16), (3, 37), (8, 200), (2, 1)])
def test_verdict_pack_plain_matches_ref_and_pallas(D, M):
    rng = np.random.default_rng(D * 100 + M)
    v = rng.integers(-128, 128, (D, M)).astype(np.int8)
    v[:, 15::16] = 3                      # bit 31 of every full word
    want = np.asarray(ref.verdict_pack(jnp.asarray(v)))
    pallas = np.asarray(verdict_pack_pallas(jnp.asarray(v), interpret=True))
    got = K.verdict_pack(torch.from_numpy(v)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, pallas)
    assert got.shape == (D, -(-M // 16))
    if M >= 16:
        assert (got[:, :M // 16] < 0).all()


@pytest.mark.parametrize("D,n", [(1, 16), (3, 37), (8, 200), (2, 5)])
def test_verdict_unpack_plain_matches_ref_and_pallas(D, n):
    rng = np.random.default_rng(D * 10 + n)
    W = -(-n // 16)
    words = rng.integers(-2 ** 31, 2 ** 31, (D, W)).astype(np.int32)
    want = np.asarray(ref.verdict_unpack(jnp.asarray(words), n))
    pallas = np.asarray(verdict_unpack_pallas(jnp.asarray(words), n,
                                              interpret=True))
    got = K.verdict_unpack(torch.from_numpy(words), n).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, pallas)
    # Round trip through the pack of the low two bits.
    back = K.verdict_pack(torch.from_numpy(got)).numpy()
    mask = np.where(np.arange(W * 16) < n, 3, 0).reshape(W, 16)
    keep = (mask << (2 * np.arange(16))).sum(axis=1).astype(np.uint32)
    np.testing.assert_array_equal(back.view(np.uint32),
                                  words.view(np.uint32) & keep)


def test_verdict_unpack_refuses_too_few_words():
    with pytest.raises(ValueError, match="fewer than"):
        K.verdict_unpack(torch.zeros((1, 2), dtype=torch.int32), 33)


def test_cpu_calls_count_calls_not_launches():
    before = {op: (K.WRAPPERS[op].calls, K.WRAPPERS[op].launches)
              for op in ("route_pack", "verdict_pack", "verdict_unpack")}
    K.route_pack(torch.zeros(4, dtype=torch.int32),
                 torch.zeros((3, 4), dtype=torch.int32), 1, 8, FILLS)
    w = K.verdict_pack(torch.zeros((1, 4), dtype=torch.int8))
    K.verdict_unpack(w, 4)
    for op, (calls, launches) in before.items():
        assert K.WRAPPERS[op].calls == calls + 1
        assert K.WRAPPERS[op].launches == launches


@pytest.mark.parametrize("fine", [True, False])
@pytest.mark.parametrize("T,KW", [(1, 2048), (2, 1500)])
def test_wide_wave_commit_plain_matches_ref(fine, T, KW):
    """The sharded owner's rows: one row per source shard of up to 4 x the
    fair share of ops, each op with its own prio, few records."""
    from repro.core.claimword import claim_word as jax_claim_word
    rng = np.random.default_rng(KW + T)
    N, G, wave = 300, 2, 12
    old = np.asarray(jax_claim_word(
        jnp.asarray(np.full((N, G), wave - 2), jnp.uint32),
        jnp.asarray(rng.integers(0, 1 << 16, (N, G)), jnp.uint32)))
    claim_w = np.where(rng.random((N, G)) < 0.3, np.uint32(0xFFFFFFFF),
                       old).astype(np.uint32)
    keys = rng.integers(0, N, (T, KW)).astype(np.int32)
    keys[rng.random((T, KW)) < 0.2] = -1
    groups = rng.integers(0, G, (T, KW)).astype(np.int32)
    prio = rng.integers(0, 1 << 16, (T, KW)).astype(np.uint32)
    do_w, check_w = (rng.random((T, KW)) < 0.4 for _ in range(2))
    cw, _, _, conflict, commit = ref.wave_commit(
        jnp.asarray(claim_w), None, None, jnp.asarray(keys),
        jnp.asarray(groups), jnp.asarray(prio), jnp.asarray(do_w), None,
        jnp.asarray(check_w), None, None, None, jnp.uint32(wave), fine,
        False, False)
    tw = torch.from_numpy(claim_w.view(np.int32).copy())
    got_conflict, got_commit = K.wave_commit(
        tw, None, None, torch.from_numpy(keys), torch.from_numpy(groups),
        torch.from_numpy(prio.view(np.int32)), torch.from_numpy(do_w), None,
        torch.from_numpy(check_w), None, None, None, wave, fine, False,
        False)
    np.testing.assert_array_equal(got_conflict.numpy(), np.asarray(conflict))
    np.testing.assert_array_equal(got_commit.numpy(), np.asarray(commit))
    np.testing.assert_array_equal(tw.numpy().view(np.uint32), np.asarray(cw))
    assert np.asarray(conflict).any() and not np.asarray(conflict).all()
