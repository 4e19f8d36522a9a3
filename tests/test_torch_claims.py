"""The port's claim words and per-wave arithmetic against the JAX package.

Bit-exact: the claim-word layout, priorities, the stateless hash (uint32
wraparound included), same-cell counts, first-conflict indices and the
abort-cause histogram, on the same numpy inputs.  The lazily decayed heats
of Adaptive and AutoGran match to rtol 1e-6 (``decay ** dt`` is a float32
pow), their heat waves exactly.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import claimword as jcw
from repro.core import claims as jcl
from repro.core import types as jt
from repro_torch.core import claimword as cw
from repro_torch.core import claims as cl
from repro_torch.core import types as pt


@pytest.mark.parametrize("wave", [0, 1, 7, 65_535, 65_536, 70_001,
                                  2 ** 32 - 1])
def test_claim_word_layout_matches_jax(wave):
    rng = np.random.default_rng(wave % 1000)
    prio = rng.integers(0, 1 << 20, 64).astype(np.uint32)
    want = np.asarray(jcw.claim_word(jnp.uint32(wave), jnp.asarray(prio)))
    got = cw.claim_word(wave, torch.from_numpy(prio.view(np.int32)))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    assert cw.inv_wave(wave) == int(jcw.inv_wave(jnp.uint32(wave)))
    words = rng.integers(0, 1 << 32, 64, dtype=np.uint64).astype(np.uint32)
    words[:8] = want[:8]
    ivw = cw.inv_wave(wave)
    np.testing.assert_array_equal(
        cw.live_prio(cw.u32(torch.from_numpy(words.view(np.int32))),
                     ivw).numpy(),
        np.asarray(jcw.live_prio(jnp.asarray(words), jnp.uint32(ivw))))


def test_u32_round_trip():
    vals = np.array([0, 1, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF], np.uint32)
    t = torch.from_numpy(vals.view(np.int32))
    assert cw.u32(t).tolist() == [int(v) for v in vals]
    assert torch.equal(cw.to_i32(cw.u32(t)), t)
    assert cw.to_i32(torch.tensor([2 ** 32 + 5, -1])).tolist() == [5, -1]


@pytest.mark.parametrize("use_age", [False, True])
def test_prio16_matches_jax(use_age):
    rng = np.random.default_rng(3)
    age = rng.integers(-3, 100, 128).astype(np.int32)
    rank = rng.permutation(128).astype(np.uint32)
    want = np.asarray(jcl.prio16(jnp.asarray(age), jnp.asarray(rank),
                                 use_age=use_age))
    got = cl.prio16(torch.from_numpy(age), torch.from_numpy(rank.astype(
        np.int64)), use_age=use_age)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int32))


@pytest.mark.parametrize("wave", [0, 5, 131, 2 ** 31 + 7, 2 ** 32 - 1])
def test_hash01_bit_exact_with_wraparound(wave):
    T, K = 128, 64
    want = np.asarray(jcl.hash01(jnp.uint32(wave), jcl.lane_op_ids(T, K)))
    got = cl.hash01(wave, cl.lane_op_ids(T, K))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    # The overlap thresholds compare in float32 on both sides.
    for thr in (0.6, 0.55):
        np.testing.assert_array_equal((got < thr).numpy(),
                                      np.asarray(jnp.asarray(want) < thr))


@pytest.mark.parametrize("G", [1, 2])
def test_cell_counts_matches_jax(G):
    rng = np.random.default_rng(G)
    keys = rng.integers(-1, 9, (16, 8)).astype(np.int32)
    groups = rng.integers(0, G, (16, 8)).astype(np.int32)
    mask = rng.random((16, 8)) < 0.7
    want = np.asarray(jcl.cell_counts(jnp.asarray(keys), jnp.asarray(groups),
                                      G, jnp.asarray(mask)))
    got = cl.cell_counts(torch.from_numpy(keys), torch.from_numpy(groups), G,
                         torch.from_numpy(mask))
    np.testing.assert_array_equal(got.numpy(), want)


def test_first_true_index_matches_jax():
    rng = np.random.default_rng(9)
    flags = rng.random((32, 16)) < 0.1
    flags[0] = False
    want = np.asarray(jcl.first_true_index(jnp.asarray(flags), 16))
    got = cl.first_true_index(torch.from_numpy(flags), 16)
    np.testing.assert_array_equal(got.numpy(), want)
    assert got[0] == 16


def test_cause_counts_matches_jax_and_sums_to_aborts():
    rng = np.random.default_rng(4)
    cause = rng.integers(0, pt.N_ABORT_CAUSES + 1, 256).astype(np.int32)
    aborted = (rng.random(256) < 0.4) & (cause < pt.N_ABORT_CAUSES)
    want = np.asarray(jt.cause_counts(jnp.asarray(cause),
                                      jnp.asarray(aborted)))
    got = pt.cause_counts(torch.from_numpy(cause), torch.from_numpy(aborted))
    np.testing.assert_array_equal(got.numpy(), want)
    assert int(got.sum()) == int(aborted.sum())
    assert pt.CAUSE_NAMES == jt.CAUSE_NAMES
    assert (pt.N_ABORT_CAUSES, pt.CAUSE_NONE) == (jt.N_ABORT_CAUSES,
                                                   jt.CAUSE_NONE)


def _heats(rng, n=12):
    heat = (rng.random(n) * 3).astype(np.float32)
    heat_wave = rng.integers(0, 40, n).astype(np.int32)
    keys = rng.integers(-1, n, (8, 6)).astype(np.int32)  # dups and -1
    keys[0, :3] = 4                                        # a hot record
    return heat, heat_wave, keys


def _with_sink(a: np.ndarray) -> torch.Tensor:
    """The port's per-record table: the records, then the zero sink slot
    (``types.SINK``) that the masked scatters write."""
    return torch.from_numpy(np.append(a, np.zeros(pt.SINK, a.dtype)))


@pytest.mark.parametrize("decay", [0.95, 0.97])
def test_lazy_decayed_matches_jax(decay):
    rng = np.random.default_rng(17)
    heat, heat_wave, keys = _heats(rng)
    wave = 37  # some heats were touched after it: dt clamps at 0
    want = np.asarray(jcl.lazy_decayed(
        jnp.asarray(heat), jnp.asarray(heat_wave), jnp.asarray(keys),
        jnp.uint32(wave), decay))
    got = cl.lazy_decayed(_with_sink(heat), _with_sink(heat_wave),
                          torch.from_numpy(keys), wave, decay)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
    assert (got.numpy()[keys < 0] == 0).all()


def test_touch_heat_matches_jax():
    rng = np.random.default_rng(19)
    heat, heat_wave, keys = _heats(rng)
    mask = rng.random(keys.shape) < 0.6
    mask[0, :3] = True  # three adds on one record
    add = np.ones(keys.shape, np.float32)
    want_h, want_w = jcl.touch_heat(
        jnp.asarray(heat), jnp.asarray(heat_wave), jnp.asarray(keys),
        jnp.asarray(add), jnp.uint32(41), 0.95,
        jnp.asarray(mask & (keys >= 0)))
    th, tw = _with_sink(heat), _with_sink(heat_wave)
    assert cl.touch_heat(th, tw, torch.from_numpy(keys), torch.from_numpy(add),
                         41, 0.95, torch.from_numpy(mask)) is None  # in place
    assert th[-1] == 0 and tw[-1] == 0   # the masked ops' sink slot
    th, tw = th[:-pt.SINK], tw[:-pt.SINK]
    np.testing.assert_allclose(th.numpy(), np.asarray(want_h), rtol=1e-6)
    np.testing.assert_array_equal(tw.numpy(), np.asarray(want_w))
    assert th[4] > 2.0 and tw[4] == 41
    untouched = ~np.isin(np.arange(12), keys[mask & (keys >= 0)])
    np.testing.assert_array_equal(th.numpy()[untouched], heat[untouched])
