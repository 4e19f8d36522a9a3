"""The port's sharded open loop (core/distributed.py ``init_open_queue``,
``make_open_wave_fn``, ``run_open_loop``) against the JAX package.

- One gloo rank in the test process against JAX ``make_open_wave_fn`` on
  a ``(1,)`` mesh (``backend="jnp"``), wave by wave on the same numpy
  draws and arrival counts: commit masks, all ``STATS_LEN`` stats slots,
  every field of the queue state and the time-to-commit histogram
  bit-identical; OCC, MVCC and MV-OCC at both granularities, scans and
  capacity drops.  ``run_open_loop``'s summary is those waves'.
- The one-rank open wave against the port's own local admission ring
  (core/admission.py) composed with the local OCC validator, as JAX
  tests/test_open_loop.py holds its engine.
- The conservation identities, exactly: ``admitted == commits +
  queued_final + inc_drops``, ``offered == admitted + arrival_drops``,
  the histogram counting every commit and the inc_cap cause every
  incarnation drop.

Two ranks: tests/test_torch_dist_open_multi.py.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import distributed as JD
from repro.workloads.arrivals import PoissonArrivals as JArrivals
from repro_torch.core import admission as padm
from repro_torch.core import convert
from repro_torch.core import distributed as D
from repro_torch.core import types as t
from repro_torch.core.cc import VALIDATORS
from repro_torch.launch.mesh import close_shards, init_shards
from repro_torch.workloads.arrivals import PoissonArrivals

N, T, K, WAVES, CAP = 96, 12, 6, 10, 24


@pytest.fixture(scope="module")
def shards():
    sh = init_shards("cpu")
    yield sh
    close_shards(sh)


def gen_fn(n_total, seed_base, scans=False, n=N):
    """Each wave's candidates, globally shaped, from numpy: masked slots,
    every op kind, with ``scans`` READ intervals of up to 8 records
    (``kind | extent << 2``)."""
    def gen(w):
        rng = np.random.default_rng(seed_base + w)
        keys = rng.integers(0, n, (n_total, K)).astype(np.int32)
        keys[rng.random((n_total, K)) < 0.1] = -1
        groups = rng.integers(0, 2, (n_total, K)).astype(np.int32)
        kinds = rng.choice([t.NOP, t.READ, t.WRITE, t.ADD], (n_total, K),
                           p=[0.1, 0.5, 0.3, 0.1])
        if scans:
            ext = np.where(rng.random((n_total, K)) < 0.4,
                           rng.integers(2, 9, (n_total, K)), 1)
            kinds = np.where(kinds == t.READ, kinds | (ext << 2), kinds)
        prio = rng.permutation(n_total).astype(np.uint32)
        return keys, groups, kinds.astype(np.int32), prio
    return gen


def _configs(cc, gran, **kw):
    jcfg = JD.DistConfig(n_records=N, n_groups=2, lanes_per_shard=T,
                         slots=K, granularity=gran, backend="jnp", cc=cc,
                         mv_depth=3 if cc != "occ" else 0, queue_cap=CAP,
                         max_incarnations=2, lat_bins=8, **kw)
    return jcfg, convert.dist_config_from_fields(dataclasses.asdict(jcfg))


def _assert_identities(s):
    assert s["admitted"] == s["commits"] + s["queued_final"] + s["inc_drops"]
    assert s["offered"] == s["admitted"] + s["arrival_drops"]
    assert int(np.asarray(s["lat_hist"]).sum()) == s["commits"]
    assert s["abort_causes"][t.CAUSE_INC_CAP] == s["inc_drops"]
    assert sum(s["abort_causes"]) == s["aborts"]


CASES = [("occ", 0, {}), ("occ", 1, dict(fuse_wave=False)),
         ("occ", 0, dict(max_extent=8)), ("occ", 1, dict(route_cap=8)),
         ("mvcc", 1, {}), ("mvcc", 0, dict(max_extent=8)),
         ("mvocc", 0, {}), ("mvocc", 1, dict(max_extent=8))]


@pytest.mark.parametrize("cc,gran,kw", CASES,
                         ids=[f"{c}-{g}-{'-'.join(map(str, k.items()))}"
                              for c, g, k in CASES])
def test_one_rank_open_wave_matches_jax(shards, cc, gran, kw):
    jcfg, cfg = _configs(cc, gran, **kw)
    mesh = jax.make_mesh((1,), ("data",))
    gen = gen_fn(T, 40 + len(cc) + gran, scans=jcfg.max_extent > 1)
    arr = JArrivals(rate=9.0, seed=gran + 2).shard_counts(WAVES, 1, T)
    jwave = jax.jit(JD.make_open_wave_fn(jcfg, mesh))
    jtab, jq = JD.init_tables(jcfg, mesh), JD.init_open_queue(jcfg, mesh)
    pwave = D.make_open_wave_fn(cfg)
    ptab, pq = D.init_tables(cfg, None, "cpu"), D.init_open_queue(
        cfg, None, "cpu")
    total = np.zeros(D.STATS_LEN, np.int64)
    for w in range(WAVES):
        draw = gen(w)
        jc, jtab, jq, js = jwave(*(jnp.asarray(x) for x in draw),
                                 jnp.asarray(arr[w]), jtab, jq,
                                 jnp.uint32(w))
        pc, ptab, pq, ps = pwave(
            *(torch.from_numpy(x.astype(np.int32)) for x in draw),
            int(arr[w, 0]), ptab, pq, w)
        np.testing.assert_array_equal(pc.numpy(), np.asarray(jc),
                                      err_msg=f"commit, wave {w}")
        np.testing.assert_array_equal(ps.numpy(), np.asarray(js),
                                      err_msg=f"stats, wave {w}")
        for name, a, b in zip(D.OpenQueue._fields, pq, jq):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                          err_msg=f"{name}, wave {w}")
        total += ps.numpy()
    for i, (a, b) in enumerate(zip(convert.dist_tables_to_numpy(cfg, ptab),
                                   jtab)):
        np.testing.assert_array_equal(a, np.asarray(b), err_msg=f"table {i}")
    assert total[D.STAT_COMMITS] > 0 and total[D.STAT_ABORTS] > 0
    if "route_cap" in kw:
        assert total[D.STAT_DROPPED_OPS] > 0
    if jcfg.max_extent > 1 and cc != "mvcc":
        assert total[D.STAT_CAUSE0 + t.CAUSE_PHANTOM] > 0

    # run_open_loop is those waves, summarized as the JAX package does.
    s = D.run_open_loop(cfg, arr, gen, WAVES, device="cpu")
    np.testing.assert_array_equal(s["per_shard_stats"], total[None])
    np.testing.assert_array_equal(s["lat_hist"], np.asarray(jq[-1])[None])
    assert s["queued_final"] == int(jq[7][0])
    assert s["offered"] == int(np.minimum(arr, T).sum())
    for k, slot in (("commits", D.STAT_COMMITS), ("aborts", D.STAT_ABORTS),
                    ("admitted", D.STAT_ADMITTED),
                    ("arrival_drops", D.STAT_ARRIVAL_DROPS),
                    ("inc_drops", D.STAT_INC_DROPS)):
        assert s[k] == total[slot], k
    _assert_identities(s)


@pytest.mark.parametrize("seed", [2, 5])
def test_one_rank_matches_the_local_composition(shards, seed):
    """The one-rank open wave == the local admission ring composed with
    the local OCC validator (window thinning off), wave by wave: commit
    masks, admitted counts and the queue's occupancy."""
    from repro_torch.core.types import CostModel, EngineConfig, store_init
    cfg = D.DistConfig(n_records=N, n_groups=2, lanes_per_shard=T, slots=K,
                       queue_cap=CAP, max_incarnations=2, lat_bins=8)
    wave = D.make_open_wave_fn(cfg)
    tables, qs = D.init_tables(cfg, None, "cpu"), D.init_open_queue(
        cfg, None, "cpu")
    arr = PoissonArrivals(rate=9.0, seed=seed).counts(WAVES, T)
    gen = gen_fn(T, 70 + seed)
    ecfg = EngineConfig(cc=t.CC_OCC, lanes=T, slots=K, n_records=N,
                        n_groups=2, n_cols=0, n_txn_types=1, granularity=1,
                        cost=CostModel(opt_overlap=1.0, phase_overlap=1.0))
    store = store_init(N, 2, device="cpu")
    q = padm.queue_init(CAP, K, "cpu")
    next_id, commits = 0, 0
    for w in range(WAVES):
        keys, groups, kinds, prio = (torch.from_numpy(x.astype(np.int32))
                                     for x in gen(w))
        commit_d, tables, qs, stats = wave(keys, groups, kinds, prio,
                                           int(arr[w]), tables, qs, w)
        fresh = t.TxnBatch(op_key=keys, op_group=groups,
                           op_col=torch.zeros_like(keys), op_kind=kinds,
                           op_val=torch.zeros(keys.shape),
                           txn_type=torch.zeros(T, dtype=torch.int32),
                           n_ops=torch.full((T,), K, dtype=torch.int32))
        lane = torch.arange(T)
        q, n_acc, _ = padm.enqueue(
            q, fresh, torch.full((T,), w, dtype=torch.int32),
            torch.zeros(T, dtype=torch.int32), next_id + lane,
            lane < int(arr[w]))
        next_id += int(arr[w])
        q, batch, aw, inc, tid, got = padm.dequeue(q, T)
        store, res = VALIDATORS[t.CC_OCC](store, batch, prio, w, ecfg)
        commit_l = res.commit & got
        retry = got & ~commit_l & (inc < cfg.max_incarnations)
        q, _, _ = padm.enqueue(q, batch, aw, inc + 1, tid, retry)
        assert torch.equal(commit_d, commit_l), w
        assert int(stats[D.STAT_ADMITTED]) == int(n_acc)
        assert int(stats[D.STAT_QUEUED]) == int(q.size)
        commits += int(commit_d.sum())
    assert commits > 0


@pytest.mark.parametrize("cc", ["occ", "mvcc"])
def test_conservation_under_overload(shards, cc):
    """Arrivals at the full lane width into a small queue with one
    incarnation: arrival drops and incarnation drops both occur, and every
    identity holds exactly."""
    cfg = D.DistConfig(n_records=48, n_groups=2, lanes_per_shard=T,
                       slots=K, cc=cc, mv_depth=3 if cc != "occ" else 0,
                       queue_cap=T + 4, max_incarnations=1, lat_bins=4)
    arr = PoissonArrivals(rate=2.0 * T, seed=11).shard_counts(16, 1, T)
    s = D.run_open_loop(cfg, arr, gen_fn(T, 300, n=48), 16, device="cpu")
    _assert_identities(s)
    assert s["arrival_drops"] > 0 and s["inc_drops"] > 0
    assert s["exchange_bytes"] == 16 * D.wire_bytes_per_wave(
        cfg, 1)["wire_bytes_per_wave"]


def test_open_loop_config_checks(shards):
    base = dict(n_records=N, lanes_per_shard=T, slots=K)
    closed = D.DistConfig(**base)
    for fn in (D.make_open_wave_fn, D.init_open_queue):
        with pytest.raises(ValueError, match="queue_cap"):
            fn(closed)
    with pytest.raises(ValueError, match="queue_cap"):
        D.make_open_run_fn(closed, 2)
    # One rank runs the synchronous wave at any depth, as the JAX package.
    deep = D.DistConfig(**base, queue_cap=CAP, pipeline_depth=2)
    assert deep.depth(1) == 1
    with pytest.raises(ValueError, match="synchronous"):
        D.make_open_run_fn(deep, 2)
    s = D.run_open_loop(deep, np.full((2, 1), 4), gen_fn(T, 1), 2,
                        device="cpu")
    _assert_identities(s)
    assert D.init_open_queue(deep, None, "cpu").next_id.tolist() == [0]
