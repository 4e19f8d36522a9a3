"""The backend op ``probe`` (kernels/claim_probe.py) against the JAX oracle.

``probe(table, keys, groups, wave, fine)`` returns the strongest live
claimant prio16 of each op's cell (fine) or row (coarse) at ``wave``, and
NO_PRIO where nobody claims or the key is masked: ``ref.claim_probe``.
The Pallas kernel ``claim_probe_pallas`` does not run in interpret mode
on jax 0.9.0 (ROADMAP, C caveats), so the oracle is ``ref``.  Tables mix
live claims of this wave, claims of stale waves and empty words; keys mix
masked (-1), out-of-range and hot duplicated records.  Integer outputs
must be bit-identical.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref
from repro_torch import kernels as K
from repro_torch.core import backend as pb
from repro_torch.core.claimword import NO_PRIO, inv_wave
from repro_torch.kernels.claim_probe import claim_probe_plain
from repro_torch.kernels.wave_commit import probe_plain

WAVE = 15                      # inv_wave 0xFFF0, as tests/test_kernels.py
OOB_KEY = 0x7F000000


def _inputs(T, K_, N, G, seed):
    rng = np.random.default_rng(seed)
    ivw = inv_wave(WAVE)
    words = rng.integers(0, 2 ** 32, (N, G), dtype=np.uint64)
    tags = rng.choice([ivw, ivw + 1, ivw + 3, 0xFFFF], (N, G))
    words = (tags.astype(np.uint64) << 16) | (words & 0xFFFF)
    words = np.where(rng.random((N, G)) < 0.2, 0xFFFFFFFF, words)
    table = words.astype(np.uint32)
    keys = rng.integers(-1, N, (T, K_)).astype(np.int32)
    hot = rng.random((T, K_))
    keys = np.where(hot < 0.3, 1, keys)
    keys = np.where(hot > 0.9, N + 3, keys)
    keys[0, 0] = OOB_KEY
    keys[-1, -1] = -1
    groups = rng.integers(0, G, (T, K_)).astype(np.int32)
    return table, keys, groups


def _torch(table, keys, groups):
    return (torch.from_numpy(table.view(np.int32).copy()),
            torch.from_numpy(keys), torch.from_numpy(groups))


@pytest.mark.parametrize("T,K_,N,G", [(4, 8, 64, 2), (3, 5, 17, 1)])
@pytest.mark.parametrize("fine", [True, False], ids=["fine", "coarse"])
def test_probe_matches_ref(T, K_, N, G, fine):
    table, keys, groups = _inputs(T, K_, N, G, seed=T * 100 + G)
    want = np.asarray(ref.claim_probe(jnp.asarray(table), jnp.asarray(keys),
                                      jnp.asarray(groups),
                                      jnp.uint32(inv_wave(WAVE)), fine))
    tt, tk, tg = _torch(table, keys, groups)
    plain = probe_plain(tt, tk, tg, inv_wave(WAVE), fine)
    np.testing.assert_array_equal(plain.numpy(), want.astype(np.int64))
    before = (K.probe.calls, K.probe.launches)
    got = pb.BACKEND.probe(tt, tk, tg, WAVE, fine)
    assert got.dtype == torch.int32 and tuple(got.shape) == (T, K_)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int32))
    # CPU tensors run the plain version: one call, no launch.
    assert (K.probe.calls, K.probe.launches) == (before[0] + 1, before[1])
    # The table is read, never written.
    np.testing.assert_array_equal(tt.numpy().view(np.uint32), table)
    assert (want[keys < 0] == NO_PRIO).all()


@pytest.mark.parametrize("fine", [True, False], ids=["fine", "coarse"])
def test_probe_of_an_installed_table_is_claim_probes_answer(fine):
    """On the table a claim install has just written, probe gives what the
    fused install + probe (claim_probe) returned."""
    table, keys, groups = _inputs(6, 7, 40, 2, seed=5)
    tt, tk, tg = _torch(table, keys, groups)
    prio = torch.from_numpy(np.random.default_rng(6).integers(
        0, 1 << 16, (6, 7)).astype(np.int32))
    mask = torch.from_numpy(np.random.default_rng(7).random((6, 7)) < 0.5)
    fused = claim_probe_plain(tt, tk, tg, prio, WAVE, mask, fine)
    np.testing.assert_array_equal(pb.BACKEND.probe(tt, tk, tg, WAVE, fine),
                                  fused)


def test_probe_out_of_range_groups_give_no_prio():
    """An out-of-range group probes NO_PRIO on the fine side, where the
    oracle's ``take_along_axis`` fill reads 0xFFFFFFFF past the row: both
    mean no claimant, and no engine path makes such a group (the
    sibling claim_probe pins the same).  Coarse probes ignore the
    group."""
    table, keys, _ = _inputs(3, 4, 16, 2, seed=9)
    keys = np.where(keys >= 0, keys % 16, keys).astype(np.int32)
    groups = np.full((3, 4), 2, np.int32)
    groups[0] = -1
    tt, tk, tg = _torch(table, keys, groups)
    got = pb.BACKEND.probe(tt, tk, tg, WAVE, True).numpy()
    assert (got == NO_PRIO).all()
    want =np.asarray(ref.claim_probe(
        jnp.asarray(table), jnp.asarray(keys[1:]), jnp.asarray(groups[1:]),
        jnp.uint32(inv_wave(WAVE)), True))
    assert (want >= NO_PRIO).all()
    coarse = pb.BACKEND.probe(tt, tk, tg, WAVE, False).numpy()
    np.testing.assert_array_equal(coarse, np.asarray(ref.claim_probe(
        jnp.asarray(table), jnp.asarray(keys), jnp.asarray(groups % 2),
        jnp.uint32(inv_wave(WAVE)), False)))


def test_probe_no_longer_waits():
    """Every op of the backend surface is ported: probe answers instead of
    raising NotImplementedError."""
    assert set(pb.SURFACE_OPS) <= set(K.WRAPPERS)
    assert pb.Backend.probe is K.probe
    empty = torch.full((8, 2), -1, dtype=torch.int32)
    keys = torch.arange(4, dtype=torch.int32).reshape(2, 2)
    assert (pb.BACKEND.probe(empty, keys, keys % 2, 0, True)
            == NO_PRIO).all()
