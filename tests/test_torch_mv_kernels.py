"""The multi-version slice's kernels against the JAX oracles.

The plain versions of ``mv_gather`` and ``mv_install`` (the route a CPU
tensor takes through the kernel wrapper) must be bit-identical to
``repro.kernels.ref`` on the same numpy inputs: empty slots, snapshots
before every retained slot, stamps with the top bit set (the unsigned
compares), masked keys, several groups and duplicate ops on one record,
a ring that wraps (head at D-1) and D = 1.  ``mv_install`` is also held
against its Pallas kernel in interpret mode; ``mv_gather``'s Pallas
kernel does not run on this JAX version.  ``mvstore``'s clocks and ring
layout match the JAX package's.  The CUDA kernels are held against these
plain versions in tests/test_torch_cuda.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import mvstore as jmv
from repro.kernels import ops, ref
from repro_torch import kernels as K
from repro_torch.core import mvstore as pmv
from repro_torch.core import types as pt

T, KS, N, G = 6, 5, 11, 2
EMPTY = 0xFFFFFFFF


def _words_t(a):
    return torch.from_numpy(np.asarray(a, np.uint32).view(np.int32).copy())


def _u32(t):
    return t.numpy().view(np.uint32)


def _ring(rng, D, base=0):
    """A ring per record as the engine leaves it: a run of installed slots
    with increasing stamps (per group, carried forward), empty slots
    behind a young record's head, a head anywhere (D-1 included)."""
    begin = np.full((N, D, G), EMPTY, np.uint64)
    head = rng.integers(0, D, N).astype(np.int32)
    for r in range(N):
        n_inst = rng.integers(1, D + 1)
        stamp = np.zeros(G, np.uint64) + base
        for i in range(n_inst):
            slot = (head[r] - (n_inst - 1) + i) % D
            stamp = stamp + rng.integers(0, 3, G)
            stamp[rng.integers(0, G)] += 1
            begin[r, slot] = stamp
    return begin.astype(np.uint32), head


def _keys(rng):
    keys = rng.integers(0, N, (T, KS)).astype(np.int32)
    keys[rng.random((T, KS)) < 0.15] = -1
    return keys, rng.integers(0, G, (T, KS)).astype(np.int32)


def test_mvstore_clocks_and_ring_match_jax():
    for wave in (0, 3, 9, 0xFFFFFFFF):
        assert pmv.install_ts(wave) == int(jmv.install_ts(jnp.uint32(wave)))
        for age in (0, 2, 8):
            assert pmv.snapshot_ts(wave, age) == int(
                jmv.snapshot_ts(jnp.uint32(wave), age))
    b, h, v = pmv.mv_init(5, 3, 2, "cpu")
    jb, jh, _ = jmv.mv_init(5, 3, 2)
    np.testing.assert_array_equal(_u32(b), np.asarray(jb))
    np.testing.assert_array_equal(h.numpy(), np.asarray(jh))
    assert tuple(v.shape) == (1, 1, 1)
    store = pt.store_init(7, 2, device="cpu", mv_depth=4)
    assert store.mv_depth == 4 and tuple(store.mv_begin.shape) == (7, 4, 2)
    assert pt.store_init(7, 2, device="cpu").mv_depth == 1  # placeholder


@pytest.mark.parametrize("D", [4, 1])
@pytest.mark.parametrize("fine", [True, False], ids=["fine", "coarse"])
def test_mv_gather_plain_matches_ref(fine, D):
    rng = np.random.default_rng(3 + D)
    # Stamps around 2**31: an int32 compare would get them wrong.
    for base in (0, 0x7FFFFFF0):
        begin, _ = _ring(rng, D, base)
        keys, groups = _keys(rng)
        keys[0, 0] = N + 2          # beyond the table: masked
        for ts in (base, base + 2, base + 5, base + 40):
            want_s, want_ok = ref.mv_gather(
                jnp.asarray(begin), jnp.asarray(keys), jnp.asarray(groups),
                jnp.uint32(ts), fine)
            slot, ok = K.mv_gather(_words_t(begin), torch.from_numpy(keys),
                                   torch.from_numpy(groups), ts, fine)
            assert slot.dtype == torch.int32 and ok.dtype == torch.bool
            np.testing.assert_array_equal(slot.numpy(), np.asarray(want_s))
            np.testing.assert_array_equal(ok.numpy(), np.asarray(want_ok))
        # A snapshot before every retained slot: nothing visible.
        _, ok = K.mv_gather(_words_t(begin), torch.from_numpy(keys),
                            torch.from_numpy(groups), 0, fine)
        if base:
            assert not ok.any()
    assert K.mv_gather.launches == 0


@pytest.mark.parametrize("D", [4, 1])
def test_mv_install_plain_matches_ref_and_pallas(D):
    rng = np.random.default_rng(17 + D)
    begin, head = _ring(rng, D)
    head[2] = D - 1                 # the ring wraps
    keys, groups = _keys(rng)
    keys[1, :4] = 2                 # duplicates on one record ...
    groups[1, :4] = [0, 1, 1, 0]    # ... in several groups
    do = rng.random((T, KS)) < 0.6
    do[1, :4] = True
    ts = int(begin[begin != EMPTY].max()) + 1
    args = (jnp.asarray(keys), jnp.asarray(groups), jnp.asarray(do),
            jnp.uint32(ts))
    want_b, want_h = ref.mv_install(jnp.asarray(begin), jnp.asarray(head),
                                    *args)
    pal_b, pal_h = ops.mv_install(jnp.asarray(begin), jnp.asarray(head),
                                  *args, use_pallas=True)
    tb, th = _words_t(begin), torch.from_numpy(head.copy())
    assert K.mv_install(tb, th, torch.from_numpy(keys),
                        torch.from_numpy(groups), torch.from_numpy(do),
                        ts) is None  # in place
    np.testing.assert_array_equal(_u32(tb), np.asarray(want_b))
    np.testing.assert_array_equal(th.numpy(), np.asarray(want_h))
    np.testing.assert_array_equal(np.asarray(pal_b), np.asarray(want_b))
    np.testing.assert_array_equal(np.asarray(pal_h), np.asarray(want_h))
    assert int(th[2]) == 0          # wrapped from D-1
    assert (th.numpy() != head).any() == (D > 1)
    # One slot per record: both groups of record 2 stamped in ONE slot.
    assert (_u32(tb)[2, int(th[2])] == ts).all()
    assert K.mv_install.launches == 0


def test_mv_install_plain_refuses_a_stamp_not_above_the_ring():
    rng = np.random.default_rng(5)
    begin, head = _ring(rng, 4)
    keys, groups = _keys(rng)
    do = np.ones((T, KS), bool)
    ts = int(begin[begin != EMPTY].max())   # not above every stamp
    with pytest.raises(ValueError, match="precondition"):
        K.mv_install(_words_t(begin), torch.from_numpy(head),
                     torch.from_numpy(keys), torch.from_numpy(groups),
                     torch.from_numpy(do), ts)


def test_mv_gather_masks_keys_as_the_pallas_kernel():
    """A key outside [0, N) sees no version (slot 0, ok False) whatever its
    group, as in the Pallas kernel.  ``ref.mv_gather`` agrees except for a
    fine read with a group outside [0, G), where its fill row reads as
    begin 0 and gives ok True (ROADMAP queue C); the engine never builds
    such an op."""
    rng = np.random.default_rng(9)
    begin, _ = _ring(rng, 4)
    keys = np.array([[-1, -1, N, 3]], np.int32)
    groups = np.array([[0, G, G, 1]], np.int32)
    slot, ok = K.mv_gather(_words_t(begin), torch.from_numpy(keys),
                           torch.from_numpy(groups), 50, True)
    assert slot.tolist() == [[0, 0, 0, slot[0, 3].item()]]
    assert ok.tolist() == [[False, False, False, True]]
    _, want_ok = ref.mv_gather(jnp.asarray(begin), jnp.asarray(keys),
                               jnp.asarray(groups), jnp.uint32(50), True)
    assert np.asarray(want_ok).tolist() == [[False, True, True, True]]
