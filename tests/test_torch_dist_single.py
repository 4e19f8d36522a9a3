"""The port's sharded wave on one rank against the JAX engine on a 1-device
mesh.

A one-rank gloo group in the test process runs
``repro_torch.core.distributed.make_wave_fn`` on the CPU (the plain
versions of the kernels); JAX runs ``repro.core.distributed.make_wave_fn``
on a ``(1,)`` mesh with ``backend="jnp"``.  Both take the same numpy
draws over several waves, and the commit masks, every table and all
``STATS_LEN`` stats slots must be bit-identical: OCC, MVCC and MV-OCC at
both granularities, the fused and unfused OCC owner routes, scans
(intervals of up to 8 records) and capacity drops (``route_cap=8``).  The
config checks are the JAX package's, and a (1, 1) axis-wise mesh runs as
the flat exchange.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import distributed as JD
from repro_torch.core import convert
from repro_torch.core import distributed as D
from repro_torch.core import types as t
from repro_torch.launch.mesh import close_shards, init_shards

N, T, K, WAVES = 96, 12, 6, 3


@pytest.fixture(scope="module")
def shards():
    sh = init_shards("cpu")
    yield sh
    close_shards(sh)


def draws(seed, waves=WAVES, lanes=T, scans=False, n=N):
    """[(keys, groups, kinds, prio)] per wave: masked slots, every op
    kind (ADD too), and with ``scans`` READs of up to 8 records packed as
    ``kind | extent << 2``."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(waves):
        keys = rng.integers(0, n, (lanes, K)).astype(np.int32)
        keys[rng.random((lanes, K)) < 0.1] = -1
        groups = rng.integers(0, 2, (lanes, K)).astype(np.int32)
        kinds = rng.choice([t.NOP, t.READ, t.WRITE, t.ADD], (lanes, K),
                           p=[0.1, 0.5, 0.3, 0.1]).astype(np.int32)
        if scans:
            ext = np.where(rng.random((lanes, K)) < 0.4,
                           rng.integers(2, 9, (lanes, K)), 1)
            kinds = np.where(kinds == t.READ, kinds | (ext << 2), kinds)
        prio = rng.permutation(lanes).astype(np.uint32)
        out.append((keys, groups, kinds.astype(np.int32), prio))
    return out


def jax_run(jcfg, mesh, ds):
    """JAX make_wave_fn over the draws: [(commit, stats)], final tables."""
    wave = jax.jit(JD.make_wave_fn(jcfg, mesh))
    tables = JD.init_tables(jcfg, mesh)
    outs = []
    for w, (keys, groups, kinds, prio) in enumerate(ds):
        commit, tables, stats = wave(jnp.asarray(keys), jnp.asarray(groups),
                                     jnp.asarray(kinds), jnp.asarray(prio),
                                     tables, jnp.uint32(w))
        outs.append((np.asarray(commit), np.asarray(stats)))
    return outs, tuple(np.asarray(x) for x in tables)


def port_run(cfg, ds, rank=0, ns=1, tables=None, group=None):
    """The port's wave over this rank's slice of the draws."""
    wave = D.make_wave_fn(cfg, group)
    if tables is None:
        tables = D.init_tables(cfg, group, "cpu")
    lanes = slice(rank * cfg.lanes_per_shard,
                  (rank + 1) * cfg.lanes_per_shard)
    outs = []
    for w, (keys, groups, kinds, prio) in enumerate(ds):
        commit, tables, stats = wave(
            *(torch.from_numpy(np.ascontiguousarray(a[lanes]))
              for a in (keys, groups, kinds, prio.astype(np.int32))),
            tables, w)
        outs.append((commit.numpy(), stats.numpy()))
    return outs, tables


CASES = [
    ("occ", 0, {}), ("occ", 1, {}), ("occ", 1, dict(fuse_wave=False)),
    ("occ", 0, dict(max_extent=8)), ("occ", 1, dict(max_extent=8)),
    ("occ", 1, dict(route_cap=8)),
    ("mvcc", 0, {}), ("mvcc", 1, {}), ("mvcc", 1, dict(max_extent=8)),
    ("mvcc", 1, dict(snapshot_age=2)),
    ("mvocc", 0, {}), ("mvocc", 1, {}), ("mvocc", 0, dict(max_extent=8)),
    ("mvocc", 1, dict(max_extent=8)), ("mvocc", 0, dict(route_cap=8)),
]


@pytest.mark.parametrize("cc,gran,kw", CASES,
                         ids=[f"{c}-{g}-{'-'.join(map(str, k.items()))}"
                              for c, g, k in CASES])
def test_one_shard_wave_matches_jax(shards, cc, gran, kw):
    jcfg = JD.DistConfig(n_records=N, n_groups=2, lanes_per_shard=T,
                         slots=K, granularity=gran, backend="jnp", cc=cc,
                         mv_depth=3 if cc != "occ" else 0, **kw)
    cfg = convert.dist_config_from_fields(dataclasses.asdict(jcfg))
    ds = draws(sum(map(ord, cc)) + gran, scans=jcfg.max_extent > 1)
    want, want_tables = jax_run(jcfg, jax.make_mesh((1,), ("data",)), ds)
    got, tables = port_run(cfg, ds)
    for w, ((jc, js), (pc, ps)) in enumerate(zip(want, got)):
        np.testing.assert_array_equal(pc, jc, err_msg=f"commit, wave {w}")
        np.testing.assert_array_equal(ps, js, err_msg=f"stats, wave {w}")
    for i, (a, b) in enumerate(zip(convert.dist_tables_to_numpy(cfg, tables),
                                   want_tables)):
        np.testing.assert_array_equal(a, b, err_msg=f"table {i}")
    stats = np.stack([s for _, s in got]).sum(axis=0)
    assert stats[D.STAT_CAUSES].sum() == stats[D.STAT_ABORTS]
    assert stats[D.STAT_COMMITS] > 0 and stats[D.STAT_ABORTS] > 0
    if "route_cap" in kw:
        assert stats[D.STAT_DROPPED_OPS] > 0
    if jcfg.max_extent > 1 and cc != "mvcc":
        assert stats[D.STAT_CAUSE0 + t.CAUSE_PHANTOM] > 0


def test_tables_carry_across_from_jax(shards):
    """Tables converted from JAX's init_tables run like fresh ones, and the
    wave's exchange counts the modelled wire bytes."""
    jcfg = JD.DistConfig(n_records=N, lanes_per_shard=T, slots=K,
                         cc="mvocc", mv_depth=2)
    cfg = convert.dist_config_from_fields(dataclasses.asdict(jcfg))
    jt = [np.asarray(x) for x in JD.init_tables(
        jcfg, jax.make_mesh((1,), ("data",)))]
    tables = convert.dist_tables_from_numpy(cfg, jt, 0, 1, "cpu")
    for a, b in zip(tables, D.init_tables(cfg, None, "cpu")):
        assert torch.equal(a, b)
    wave = D.make_wave_fn(cfg)
    keys, groups, kinds, prio = draws(3, waves=1)[0]
    wave(torch.from_numpy(keys), torch.from_numpy(groups),
         torch.from_numpy(kinds), torch.from_numpy(prio.astype(np.int32)),
         tables, 0)
    assert wave.exchange.calls == 3
    assert wave.exchange.bytes_sent == \
        D.wire_bytes_per_wave(cfg, 1)["wire_bytes_per_wave"]
    assert D.wire_bytes_per_wave(cfg, 1) == JD.wire_bytes_per_wave(
        jcfg, jax.make_mesh((1,), ("data",)))


def test_run_fn_is_a_loop_of_waves(shards):
    cfg = D.DistConfig(n_records=N, lanes_per_shard=T, slots=K, cc="occ",
                       granularity=0)
    ds = draws(9)
    stack = [torch.from_numpy(np.stack([d[i] for d in ds]).astype(np.int32))
             for i in range(4)]
    run = D.make_run_fn(cfg, WAVES)
    commit, tables, stats = run(*stack, D.init_tables(cfg, None, "cpu"))
    want, want_tables = port_run(cfg, ds)
    np.testing.assert_array_equal(commit.numpy(), np.stack([c for c, _ in
                                                            want]))
    np.testing.assert_array_equal(stats.numpy(), np.stack([s for _, s in
                                                           want]))
    for a, b in zip(tables, want_tables):
        assert torch.equal(a, b)


BAD = [
    dict(cc="tictoc"), dict(cc="mvcc"), dict(mv_depth=2),
    dict(snapshot_age=-1), dict(snapshot_age=2),
    dict(pipeline_depth=0),
    dict(cc="mvcc", mv_depth=4, pipeline_depth=2, snapshot_age=1),
    dict(topology="ring"), dict(route_cap=-8), dict(route_cap=8),
    dict(route_cap=20), dict(n_groups=3), dict(queue_cap=-1),
    dict(max_incarnations=-1), dict(queue_cap=4, lat_bins=1),
    dict(max_incarnations=2), dict(max_extent=0), dict(max_extent=4096),
    dict(bucket_size=0), dict(cc="mvcc", mv_depth=4, max_extent=8,
                              snapshot_age=1),
]


@pytest.mark.parametrize("kw", BAD, ids=[str(k) for k in BAD])
def test_config_checks_are_the_jax_packages(kw):
    base = dict(n_records=N, lanes_per_shard=T, slots=16)
    with pytest.raises(ValueError):
        JD.DistConfig(**base, **kw)
    with pytest.raises(ValueError):
        D.DistConfig(**base, **kw)


def test_wave_checks_interval_limits(shards):
    with pytest.raises(ValueError, match="rec_per"):
        D.make_wave_fn(D.DistConfig(n_records=4, slots=4, max_extent=8))
    with pytest.raises(ValueError, match="bucket_size"):
        D.make_wave_fn(D.DistConfig(n_records=12, slots=4, max_extent=8,
                                    granularity=0))


def test_settings_outside_the_slice_raise(shards):
    """Every setting is ported: a (1, 1) axis-wise mesh runs, one
    exchange per axis, as the flat exchange at twice the bytes; a mesh
    that does not cover the ranks raises; one shard falls back to the
    synchronous wave at any depth."""
    cfg = D.DistConfig(n_records=N, lanes_per_shard=T, slots=K,
                       topology="axiswise")
    keys, groups, kinds, prio = (torch.from_numpy(a.astype(np.int32))
                                 for a in draws(4, waves=1)[0])
    outs = {}
    for shape in ((1, 1), (1,)):             # one axis: the flat exchange
        wave = D.make_wave_fn(cfg, mesh_shape=shape)
        tables = D.init_tables(cfg, None, "cpu")
        outs[shape] = wave(keys, groups, kinds, prio, tables, 0), wave
    (c2, t2, s2), axis = outs[(1, 1)]
    (c1, t1, s1), flat = outs[(1,)]
    assert torch.equal(c2, c1) and torch.equal(s2, s1)
    assert all(torch.equal(a, b) for a, b in zip(t2, t1))
    assert axis.exchange.calls == 2 * flat.exchange.calls == 6
    assert axis.exchange.bytes_sent == 2 * flat.exchange.bytes_sent == \
        D.wire_bytes_per_wave(cfg, 1, (1, 1))["wire_bytes_per_wave"]
    open_cfg = D.DistConfig(n_records=N, queue_cap=4, topology="axiswise")
    D.make_open_wave_fn(open_cfg, mesh_shape=(1, 1))
    with pytest.raises(ValueError, match="does not cover"):
        D.make_open_wave_fn(open_cfg, mesh_shape=(2, 1))
    # One shard falls back to the synchronous wave at any depth.
    assert D.DistConfig(n_records=N, pipeline_depth=2).depth(1) == 1
    assert D.make_run_fn(D.DistConfig(n_records=N, pipeline_depth=2),
                         1).exchange.calls == 0

