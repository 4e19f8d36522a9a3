"""The scan slice's kernels and phantom pass against the JAX oracles.

- ``scan_span`` and the plain version of ``iterate_validate`` against
  ``repro.kernels.ref`` (fine and coarse, bucket 8 and 1, intervals that
  cross the table's end, masked keys, point ops mixed with scans, waves
  whose claim tag has its top bit set and clear), bit-identical;
- ``validate``'s plain version against ``ref.occ_validate``;
- ``base.phantom_validate`` inside every mechanism's wave against a port
  of the numpy sequential-replay oracle of tests/test_scan.py: all eight
  mechanisms at both granularities (MVCC never flags a scan, MV-OCC only
  on update lanes, AutoGran always scans at the coarse layout).

The Pallas kernels of ``iterate_validate`` and ``occ_validate`` do not run
on this JAX version, so ``ref`` is their reference.  The CUDA kernels are
held against these plain versions in tests/test_torch_cuda.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.claimword import claim_word as jax_claim_word
from repro.kernels import ref
from repro_torch import kernels as K
from repro_torch.core import types as pt
from repro_torch.core.cc import VALIDATORS
from repro_torch.kernels.iterate_validate import scan_span

T, KS, N, G = 6, 5, 40, 2
WAVES = [5, 40_000]


def _words_t(a):
    return torch.from_numpy(np.asarray(a, np.uint32).view(np.int32).copy())


def _claim_table(rng, wave, n=N, live_share=0.1):
    """Stale, empty and live claim words (never newer than ``wave``)."""
    old = np.asarray(jax_claim_word(
        jnp.asarray(np.maximum(wave - rng.integers(1, 4, (n, G)), 0),
                    jnp.uint32),
        jnp.asarray(rng.integers(0, 1 << 16, (n, G)), jnp.uint32)))
    live = np.asarray(jax_claim_word(
        jnp.uint32(wave),
        jnp.asarray(rng.integers(0, 1 << 16, (n, G)), jnp.uint32)))
    pick = rng.random((n, G))
    return np.where(pick < 0.2, np.uint32(0xFFFFFFFF),
                    np.where(pick < 0.2 + live_share, live,
                             old)).astype(np.uint32)


def _scan_ops(rng, ext_cap):
    """Point ops and scans of extent 2..ext_cap, some running past the
    table's end, masked keys, and keys beyond the table."""
    keys = rng.integers(0, N, (T, KS)).astype(np.int32)
    keys[rng.random((T, KS)) < 0.15] = -1
    keys[0, 0] = N - 2            # a scan that crosses the table's end
    keys[0, 1] = N + 3            # past the end: coarse buckets still probe
    groups = rng.integers(0, G, (T, KS)).astype(np.int32)
    ext = np.where(rng.random((T, KS)) < 0.6,
                   rng.integers(2, ext_cap + 1, (T, KS)), 1).astype(np.int32)
    ext[0, :2] = ext_cap
    prio = np.broadcast_to(((63 << 10) | rng.permutation(T))[:, None],
                           (T, KS)).astype(np.uint32).copy()
    check = rng.random((T, KS)) < 0.8
    return keys, groups, ext, prio, check


@pytest.mark.parametrize("ext_cap", [1, 2, 9, 200])
@pytest.mark.parametrize("B", [1, 8, 3])
def test_scan_span_matches_ref(ext_cap, B):
    for fine in (True, False):
        assert scan_span(ext_cap, fine, B) == ref.scan_span(ext_cap, fine, B)
    # TPC-C's Stock-level window at the default bucket: 1 + ceil(199/8)
    # buckets of 8 rows.
    assert scan_span(200, False, 8) == 208


@pytest.mark.parametrize("wave", WAVES)
@pytest.mark.parametrize("B", [8, 1])
@pytest.mark.parametrize("fine", [True, False], ids=["fine", "coarse"])
def test_iterate_validate_plain_matches_ref(fine, B, wave):
    rng = np.random.default_rng(7 + B + wave % 5)
    ext_cap = 9
    table = _claim_table(rng, wave)
    keys, groups, ext, prio, check = _scan_ops(rng, ext_cap)
    want = np.asarray(ref.iterate_validate(
        jnp.asarray(table), jnp.asarray(keys), jnp.asarray(ext),
        jnp.asarray(groups), jnp.asarray(prio), jnp.asarray(check),
        jnp.uint32(0xFFFF - (wave & 0xFFFF)), fine, B, ext_cap))
    got = K.iterate_validate(
        _words_t(table), torch.from_numpy(keys), torch.from_numpy(ext),
        torch.from_numpy(groups), _words_t(prio), torch.from_numpy(check),
        wave, fine, B, ext_cap)
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.any() and not want.all()
    assert K.iterate_validate.launches == 0


def test_iterate_validate_plain_with_nothing_to_check():
    z = torch.zeros((T, KS), dtype=torch.int32)
    got = K.iterate_validate(z.new_zeros((N, G)), z, z + 4, z, z,
                             torch.zeros((T, KS), dtype=torch.bool), 3,
                             False, 8, 4)
    assert got.dtype == torch.bool and not got.any()


@pytest.mark.parametrize("wave", WAVES)
@pytest.mark.parametrize("fine", [True, False], ids=["fine", "coarse"])
def test_validate_plain_matches_ref(fine, wave):
    rng = np.random.default_rng(21 + wave % 7)
    table = _claim_table(rng, wave, live_share=0.5)
    keys, groups, _, prio, check = _scan_ops(rng, 2)
    groups[1, :2] = G  # out of range: no conflict on the fine side
    want = np.asarray(ref.occ_validate(
        jnp.asarray(table), jnp.asarray(keys), jnp.asarray(groups),
        jnp.asarray(prio), jnp.asarray(check),
        jnp.uint32(0xFFFF - (wave & 0xFFFF)), fine))
    got = K.validate(_words_t(table), torch.from_numpy(keys),
                     torch.from_numpy(groups), _words_t(prio),
                     torch.from_numpy(check), wave, fine)
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.any()
    assert K.validate.launches == 0


# ------------------------------- numpy sequential-replay phantom oracle
def np_phantom_oracle(keys, groups, kinds, ext, prio, fine, B, n):
    """Sequential replay: install every live write's claim (strongest
    priority per cell), then walk each scan's interval (fine: its group
    over [key, key+ext); coarse: both groups over the bucket expansion).
    A scan conflicts iff a covered cell holds a strictly stronger claim."""
    lanes, slots = keys.shape
    big = 1 << 30
    claim = np.full((n, 2), big, np.int64)
    for lane in range(lanes):
        for k in range(slots):
            if kinds[lane, k] in (pt.WRITE, pt.ADD) and keys[lane, k] >= 0:
                r, g = keys[lane, k], groups[lane, k]
                claim[r, g] = min(claim[r, g], int(prio[lane]))
    out = np.zeros((lanes, slots), bool)
    for lane in range(lanes):
        for k in range(slots):
            if ext[lane, k] <= 1 or kinds[lane, k] == pt.NOP:
                continue
            lo, hi = int(keys[lane, k]), int(keys[lane, k] + ext[lane, k])
            if not fine:
                lo, hi = (lo // B) * B, -(-hi // B) * B
            lo, hi = max(lo, 0), min(hi, n)
            for r in range(lo, hi):
                cells = ([claim[r, groups[lane, k]]] if fine
                         else [claim[r, 0], claim[r, 1]])
                if any(c < int(prio[lane]) for c in cells):
                    out[lane, k] = True
    return out


def _replay_batch(rng, lanes, slots, n, ext_cap):
    keys = rng.integers(0, n, (lanes, slots), dtype=np.int32)
    groups = rng.integers(0, 2, (lanes, slots), dtype=np.int32)
    kinds = rng.choice([pt.READ, pt.WRITE], (lanes, slots)).astype(np.int32)
    ext = np.ones((lanes, slots), np.int32)
    sc = (rng.random((lanes, slots)) < 0.5) & (kinds == pt.READ)
    if sc.any():
        ext[sc] = rng.integers(2, ext_cap + 1, sc.sum())
    keys = np.minimum(keys, n - ext).astype(np.int32)
    return keys, groups, kinds, ext


@pytest.mark.parametrize("gran", [0, 1], ids=["coarse", "fine"])
@pytest.mark.parametrize("cc", list(pt.CC_IDS))
def test_phantom_matches_replay_oracle(cc, gran):
    """Each mechanism's scan verdicts equal the sequential-replay oracle,
    carrying CAUSE_PHANTOM on exactly the conflicting scans."""
    n, lanes, slots, ext_cap = 64, 8, 3, 6
    exact = pt.CostModel(opt_overlap=1.0, phase_overlap=1.0)
    for seed in (0, 1, 2):
        rng = np.random.default_rng(seed)
        keys, groups, kinds, ext = _replay_batch(rng, lanes, slots, n,
                                                 ext_cap)
        prio = rng.permutation(lanes).astype(np.int32)
        cfg = pt.EngineConfig(
            cc=pt.CC_IDS[cc], lanes=lanes, slots=slots, n_records=n,
            n_groups=2, n_cols=0, n_txn_types=1, granularity=gran,
            cost=exact, max_extent=ext_cap,
            mv_depth=4 if pt.CC_IDS[cc] in pt.MV_CCS else 0)
        store = pt.store_init(n, 2, device="cpu", mv_depth=cfg.mv_depth)
        batch = pt.TxnBatch(
            op_key=torch.from_numpy(keys), op_group=torch.from_numpy(groups),
            op_col=torch.zeros((lanes, slots), dtype=torch.int32),
            op_kind=torch.from_numpy(kinds),
            op_val=torch.zeros((lanes, slots)),
            txn_type=torch.zeros((lanes,), dtype=torch.int32),
            n_ops=torch.full((lanes,), slots, dtype=torch.int32),
            op_extent=torch.from_numpy(ext))
        _, res = VALIDATORS[cfg.cc](store, batch, torch.from_numpy(prio), 1,
                                    cfg)
        got = res.conflict_op.numpy()
        causes = res.cause_op.numpy()
        is_scan = ext > 1
        fine = bool(gran) and cc != "autogran"
        want = np_phantom_oracle(keys, groups, kinds, ext, prio, fine,
                                 cfg.bucket_size, n)
        if cc == "mvcc":
            want = np.zeros_like(want)
        elif cc == "mvocc":
            has_write = ((kinds != pt.READ) & (kinds != pt.NOP)).any(axis=1)
            want = want & has_write[:, None]
        np.testing.assert_array_equal(got[is_scan], want[is_scan])
        assert (causes[want] == pt.CAUSE_PHANTOM).all()
        assert (causes[is_scan & ~want] == pt.CAUSE_NONE).all()
