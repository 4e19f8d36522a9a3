"""The port's workload generators, checked by distribution.

torch.Generator cannot reproduce jax.random, so the generators are held
against the JAX package's by what they draw: the Zipf rank histogram, the
hot-key scrambling (bit-exact), the TPC-C mix and op layout, ring-tail
advance and key ranges.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import types as jt
from repro.workloads import TPCCWorkload as JTPCC
from repro.workloads import YCSBWorkload as JYCSB
from repro.workloads.zipf import ZipfSampler as JZipf
from repro.workloads.zipf import scramble as jscramble
from repro_torch.workloads import TPCCWorkload, YCSBWorkload
from repro_torch.workloads.tpcc import MIX
from repro_torch.workloads.zipf import ZipfSampler, scramble


def _gen(seed=0):
    g = torch.Generator()
    g.manual_seed(seed)
    return g


def test_zipf_rank_histogram_matches_jax_sampler():
    n, draws = 1000, 200_000
    ours = ZipfSampler.make(n, 0.9).ranks(_gen(), (draws,), "cpu").numpy()
    theirs = np.asarray(JZipf.make(n, 0.9).ranks(jax.random.PRNGKey(0),
                                                 (draws,)))
    assert ours.min() >= 0 and ours.max() < n
    h1 = np.bincount(ours, minlength=n) / draws
    h2 = np.bincount(theirs, minlength=n) / draws
    # The hottest ranks one by one, the tail by deciles.
    np.testing.assert_allclose(h1[:10], h2[:10], atol=0.006)
    d1 = h1.reshape(10, -1).sum(axis=1)
    d2 = h2.reshape(10, -1).sum(axis=1)
    np.testing.assert_allclose(d1, d2, atol=0.01)


def test_scramble_bit_exact():
    x = np.arange(0, 200_000, 7, dtype=np.int32)
    for n in (1000, 4000, 10_000_000):
        np.testing.assert_array_equal(
            scramble(torch.from_numpy(x), n).numpy(),
            np.asarray(jscramble(jnp.asarray(x), n)))


def test_ycsb_batch_shape_ranges_and_hot_key():
    wl = YCSBWorkload.make(n_keys=4000, theta=0.9)
    tails = torch.zeros((1,), dtype=torch.int32)
    g = _gen(1)
    keys, kinds = [], []
    for w in range(40):
        b, t2 = wl.gen(g, w, 64, tails)
        assert torch.equal(t2, tails)
        assert b.op_key.shape == (64, 16) and b.op_key.dtype == torch.int32
        assert torch.equal(b.op_group, b.op_col % 2)
        assert int(b.op_col.min()) >= 0 and int(b.op_col.max()) < 10
        assert torch.all(b.op_extent == 1) and torch.all(b.n_ops == 16)
        keys.append(b.op_key.numpy())
        kinds.append(b.op_kind.numpy())
    keys, kinds = np.concatenate(keys), np.concatenate(kinds)
    assert keys.min() >= 0 and keys.max() < wl.n_records
    assert set(np.unique(kinds)) <= {jt.READ, jt.WRITE}
    assert abs((kinds == jt.WRITE).mean() - 0.5) < 0.02
    # The hottest key is rank 0, scrambled the same way as in JAX.
    hot = np.bincount(keys.ravel()).argmax()
    assert hot == int(jscramble(jnp.int32(0), wl.n_keys))


def test_ycsb_read_only_class():
    wl = YCSBWorkload.make(n_keys=2000, ro_frac=0.5)
    assert wl.n_txn_types == JYCSB.make(n_keys=2000, ro_frac=0.5).n_txn_types
    b, _ = wl.gen(_gen(2), 0, 256, torch.zeros((1,), dtype=torch.int32))
    ro = b.txn_type == 1
    assert 0.35 < float(ro.float().mean()) < 0.65
    assert not torch.any(b.op_kind[ro] == jt.WRITE)


@pytest.fixture(scope="module")
def tpcc_draws():
    wl = TPCCWorkload.make(n_warehouses=8, scale=0.05)
    g = _gen(3)
    tails = torch.zeros((wl.n_rings,), dtype=torch.int32)
    out = []
    for w in range(40):
        b, new = wl.gen(g, w, 128, tails)
        out.append((b, tails, new))
        tails = new
    return wl, out


def test_tpcc_layout_matches_jax(tpcc_draws):
    wl, _ = tpcc_draws
    jwl = JTPCC.make(n_warehouses=8, scale=0.05)
    assert wl.n_records == jwl.n_records
    for attr in ("d_base", "c_base", "i_base", "s_base", "o_base",
                 "ol_base", "n_rings", "slots", "n_cols", "n_groups",
                 "n_txn_types"):
        assert getattr(wl, attr) == getattr(jwl, attr), attr
    assert TPCCWorkload.make().n_records == 2_450_808


def test_tpcc_mix_and_key_ranges(tpcc_draws):
    wl, draws = tpcc_draws
    types = np.concatenate([b.txn_type.numpy() for b, _, _ in draws])
    frac = np.bincount(types, minlength=3) / types.size
    np.testing.assert_allclose(frac, MIX, atol=0.025)
    for b, _, _ in draws:
        live = b.op_key >= 0
        assert torch.all(b.op_key[live] < wl.n_records)
        assert torch.all(b.op_kind[live] != jt.NOP)
        assert torch.all(b.op_key[~live] == -1)
        assert torch.all((b.op_group == 0) | (b.op_group == 1))


def test_tpcc_op_layout_per_type_matches_jax(tpcc_draws):
    """Per transaction type, the slot layout (kind, group, column) and the
    op count equal the JAX generator's."""
    wl, draws = tpcc_draws
    jwl = JTPCC.make(n_warehouses=8, scale=0.05)
    jb, _ = jwl.gen(jax.random.PRNGKey(0), jnp.uint32(0), 128,
                    jnp.zeros((jwl.n_rings,), jnp.int32))
    b = draws[0][0]

    def layouts(op_kind, op_group, op_col, op_key, txn_type, n_ops):
        out = {}
        for i in range(len(txn_type)):
            live = op_key[i] >= 0
            out.setdefault((int(txn_type[i]), int(n_ops[i])), set()).add(
                (tuple(op_kind[i][live]), tuple(op_group[i][live]),
                 tuple(op_col[i][live])))
        return out
    ours = layouts(*(getattr(b, f).numpy() for f in
                     ("op_kind", "op_group", "op_col", "op_key", "txn_type",
                      "n_ops")))
    theirs = layouts(*(np.asarray(getattr(jb, f)) for f in
                       ("op_kind", "op_group", "op_col", "op_key",
                        "txn_type", "n_ops")))
    for key in set(ours) & set(theirs):
        assert ours[key] == theirs[key], key
    # Payment (6 ops) and Order-status (18 ops) appear in both draws.
    assert {(1, 6), (2, 18)} <= set(ours) & set(theirs)


def test_tpcc_ring_tails_advance_by_new_orders(tpcc_draws):
    wl, draws = tpcc_draws
    for b, tails, new in draws:
        is_no = b.txn_type == 0
        ring = ((b.op_key[:, 1] - wl.d_base)).to(torch.int64)
        want = tails + torch.bincount(ring[is_no],
                                      minlength=wl.n_rings).to(torch.int32)
        assert torch.equal(new, want)
        # New-orders of one district take consecutive ring slots.
        o_keys = b.op_key[is_no, 48].to(torch.int64)
        assert o_keys.unique().numel() == o_keys.numel()
