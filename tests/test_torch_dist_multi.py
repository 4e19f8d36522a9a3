"""The port's sharded wave on 4 gloo ranks against the JAX engine on a
4-device mesh.

Both run in subprocesses with a hard timeout: JAX with 4 forced host
devices (``make_wave_fn``, ``backend="jnp"``), the port as 4 processes
that join one gloo group through a ``FileStore`` and each run their
rank's lanes and table slice.  The same numpy draws go into both, and
every wave's commit masks and per-shard stats, and the final tables
gathered from the ranks, must be bit-identical: OCC, MVCC and MV-OCC at
both granularities, the unfused OCC route, capacity drops, and scans whose
intervals cross range-shard boundaries (two fragments on two owners).
"""
import json
import os
import subprocess
import sys
import textwrap

import numpy as np

from repro_torch.core import distributed as D
from repro_torch.core import types as t

ROOT = os.path.join(os.path.dirname(__file__), "..")
NS, N, T, K, WAVES = 4, 96, 6, 6, 3     # rec_per = 24 records a shard
TIMEOUT = 240

CASES = [
    ("occ", 0, {}), ("occ", 1, {}), ("occ", 1, {"fuse_wave": False}),
    ("occ", 1, {"route_cap": 8}), ("occ", 0, {"max_extent": 8}),
    ("mvcc", 1, {}), ("mvcc", 0, {"max_extent": 8}),
    ("mvocc", 0, {}), ("mvocc", 1, {"max_extent": 8}),
]

JAX_PROG = textwrap.dedent("""
    import json, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax, jax.numpy as jnp, numpy as np
    from repro.core import distributed as JD
    cases, data = json.load(open(sys.argv[1])), np.load(sys.argv[2])
    N, T, K, WAVES = json.load(open(sys.argv[3]))
    mesh = jax.make_mesh((4,), ("data",))
    out = {}
    for i, (cc, gran, kw) in enumerate(cases):
        cfg = JD.DistConfig(n_records=N, n_groups=2, lanes_per_shard=T,
                            slots=K, granularity=gran, backend="jnp", cc=cc,
                            mv_depth=3 if cc != "occ" else 0, **kw)
        wave = jax.jit(JD.make_wave_fn(cfg, mesh))
        tables = JD.init_tables(cfg, mesh)
        for w in range(WAVES):
            c, tables, s = wave(*(jnp.asarray(data[f"{i}_{f}"][w])
                                  for f in ("keys", "groups", "kinds",
                                            "prio")),
                                tables, jnp.uint32(w))
            out[f"{i}_commit_{w}"] = np.asarray(c)
            out[f"{i}_stats_{w}"] = np.asarray(s)
        for j, x in enumerate(tables):
            out[f"{i}_table_{j}"] = np.asarray(x)
    np.savez(sys.argv[4], **out)
""")

TORCH_PROG = textwrap.dedent("""
    import dataclasses, json, sys
    import numpy as np, pytest, torch
    from repro_torch.core import convert, distributed as D
    from repro_torch.launch.mesh import close_shards, init_shards
    cases, data = json.load(open(sys.argv[1])), np.load(sys.argv[2])
    N, T, K, WAVES = json.load(open(sys.argv[3]))
    sh = init_shards("cpu", init_file=sys.argv[5])
    mine = slice(sh.rank * T, (sh.rank + 1) * T)
    out = {}
    try:
        for i, (cc, gran, kw) in enumerate(cases):
            cfg = D.DistConfig(n_records=N, n_groups=2, lanes_per_shard=T,
                               slots=K, granularity=gran, cc=cc,
                               mv_depth=3 if cc != "occ" else 0, **kw)
            wave = D.make_wave_fn(cfg)
            tables = D.init_tables(cfg, None, "cpu")
            for w in range(WAVES):
                c, tables, s = wave(*(torch.from_numpy(np.ascontiguousarray(
                    data[f"{i}_{f}"][w][mine].astype(np.int32)))
                    for f in ("keys", "groups", "kinds", "prio")),
                    tables, w)
                out[f"{i}_commit_{w}"] = c.numpy()
                out[f"{i}_stats_{w}"] = s.numpy()
            for j, x in enumerate(convert.dist_tables_to_numpy(cfg, tables)):
                out[f"{i}_table_{j}"] = x
            assert wave.exchange.bytes_sent == WAVES * \\
                D.wire_bytes_per_wave(cfg, sh.size)["wire_bytes_per_wave"]
        # Depth 2 on four ranks runs the pipelined runner: the last case's
        # waves again, WAVES + 3 exchanges, the same commits and stats.
        deep = dataclasses.replace(cfg, pipeline_depth=2)
        run = D.make_run_fn(deep, WAVES)
        c, _, s = run(*(torch.from_numpy(np.ascontiguousarray(
            data[f"{i}_{f}"][:, mine].astype(np.int32)))
            for f in ("keys", "groups", "kinds", "prio")),
            D.init_tables(deep, None, "cpu"))
        assert run.exchange.calls == WAVES + 3
        for w in range(WAVES):
            assert np.array_equal(c[w].numpy(), out[f"{i}_commit_{w}"])
            assert np.array_equal(s[w].numpy(), out[f"{i}_stats_{w}"])
        with pytest.raises(ValueError, match="one synchronous wave per call"):
            D.make_wave_fn(deep)
    finally:
        close_shards(sh)
    np.savez(sys.argv[4] + f".rank{sh.rank}.npz", **out)
""")


def _draws():
    """Global draws per case: masked slots, every kind, and for scan cases
    READ intervals of up to 8 records started near shard boundaries."""
    rng = np.random.default_rng(21)
    data, crossing = {}, 0
    lanes = NS * T
    for i, (_, _, kw) in enumerate(CASES):
        scans = kw.get("max_extent", 1) > 1
        per = {f: [] for f in ("keys", "groups", "kinds", "prio")}
        for _ in range(WAVES):
            keys = rng.integers(0, N, (lanes, K))
            groups = rng.integers(0, 2, (lanes, K))
            kinds = rng.choice([t.NOP, t.READ, t.WRITE, t.ADD], (lanes, K),
                               p=[0.1, 0.5, 0.3, 0.1])
            keys[rng.random((lanes, K)) < 0.1] = -1
            if scans:
                ext = np.where(rng.random((lanes, K)) < 0.5,
                               rng.integers(2, 9, (lanes, K)), 1)
                near = (keys // 24 + 1) * 24 - rng.integers(1, 6, keys.shape)
                sc = (kinds == t.READ) & (ext > 1) & (keys >= 0)
                keys = np.where(sc & (rng.random(keys.shape) < 0.5),
                                np.minimum(near, N - 1), keys)
                crossing += int((sc & (keys // 24 != (np.minimum(
                    keys + ext, N) - 1) // 24)).sum())
                kinds = np.where(sc, kinds | (ext << 2), kinds)
            per["keys"].append(keys)
            per["groups"].append(groups)
            per["kinds"].append(kinds)
            per["prio"].append(rng.permutation(lanes))
        for f, v in per.items():
            data[f"{i}_{f}"] = np.stack(v).astype(
                np.uint32 if f == "prio" else np.int32)
    return data, crossing


def test_four_gloo_ranks_match_the_jax_mesh(tmp_path):
    data, crossing = _draws()
    assert crossing > 10          # intervals that split into two fragments
    paths = [str(tmp_path / n) for n in ("cases.json", "data.npz",
                                         "dims.json", "out")]
    json.dump(CASES, open(paths[0], "w"))
    np.savez(paths[1], **data)
    json.dump([N, T, K, WAVES], open(paths[2], "w"))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(ROOT, "src"), os.path.join(ROOT, "tests")]))
    procs = [subprocess.Popen(
        [sys.executable, "-c", JAX_PROG, *paths[:3], paths[3] + ".jax.npz"],
        env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)]
    store = str(tmp_path / "store")
    for r in range(NS):
        procs.append(subprocess.Popen(
            [sys.executable, "-c", TORCH_PROG, *paths, store],
            env=dict(env, RANK=str(r), WORLD_SIZE=str(NS)), cwd=ROOT,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=TIMEOUT)[0])
    finally:
        for p in procs:
            p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    want = np.load(paths[3] + ".jax.npz")
    ranks = [np.load(paths[3] + f".rank{r}.npz") for r in range(NS)]
    for i, (cc, gran, kw) in enumerate(CASES):
        what = f"{cc}-{gran}-{kw}"
        total = 0
        for w in range(WAVES):
            np.testing.assert_array_equal(
                np.concatenate([r[f"{i}_commit_{w}"] for r in ranks]),
                want[f"{i}_commit_{w}"], err_msg=f"{what} commit {w}")
            stats = np.concatenate([r[f"{i}_stats_{w}"] for r in ranks])
            np.testing.assert_array_equal(stats, want[f"{i}_stats_{w}"],
                                          err_msg=f"{what} stats {w}")
            total = total + stats.reshape(NS, D.STATS_LEN).sum(axis=0)
        j = 0
        while f"{i}_table_{j}" in want:
            for r in ranks:
                np.testing.assert_array_equal(
                    r[f"{i}_table_{j}"], want[f"{i}_table_{j}"],
                    err_msg=f"{what} table {j}")
            j += 1
        assert j == (4 if cc != "occ" else 2)
        assert total[D.STAT_CAUSES].sum() == total[D.STAT_ABORTS]
        assert total[D.STAT_COMMITS] > 0
        if "route_cap" in kw:
            assert total[D.STAT_DROPPED_OPS] > 0
        if kw.get("max_extent", 1) > 1 and cc != "mvcc":
            assert total[D.STAT_CAUSE0 + t.CAUSE_PHANTOM] > 0
