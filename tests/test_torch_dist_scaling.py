"""The sharded engine's scaling CLI (repro_torch.launch.txn_scaling) on
the CPU against the JAX engine.

The CLI runs in a subprocess with its own one-rank gloo group; its rows
carry the JAX benchmark rows' keys, the sharded rows' counts equal JAX
``make_run_fn``'s on the same draws (benchmarks/txn_scaling.py's), and
the open-loop rows' counts JAX ``run_open_loop``'s on the benchmark's
candidates and arrivals; ``--pipeline-depth 2`` adds pipelined rows only
on more than one rank.
"""
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np

from repro.core import distributed as JD
from repro_torch.core import types as t


def test_txn_scaling_cli_rows_match_jax(tmp_path):
    """The scaling CLI on the CPU (its own one-rank gloo group, in a
    subprocess): the JAX rows' keys, and the sharded rows' counts equal
    JAX make_run_fn's on the same draws."""
    out = tmp_path / "rows.json"
    root = os.path.join(os.path.dirname(__file__), "..")
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.txn_scaling", "--device",
         "cpu", "--waves", "2", "--lanes", "32", "--n-keys", "4000",
         "--pipeline-depth", "2", "--json", str(out)],
        env=dict(os.environ, PYTHONPATH=os.path.join(root, "src")),
        cwd=root, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    rows = json.loads(out.read_text())
    assert [(x["shards"], x["cc"], x.get("mode")) for x in rows] == [
        (0, "occ", None), (1, "occ", None), (1, "mvcc", None)] + [
        (1, cc, "open_loop") for cc in ("occ", "occ", "mvcc", "mvcc")]
    keys = {"shards", "cc", "commits", "waves_per_s", "pipeline_depth",
            "ro_commits", "ro_aborts", "abort_causes", "kernel_ops",
            "coll_bytes_per_wave", "wire_bytes_per_wave",
            "route_bytes_per_wave", "verdict_bytes_per_wave",
            "verdict_bytes_per_wave_legacy", "device_name"}
    assert keys <= set(rows[1]) and keys <= set(rows[2])
    mesh = jax.make_mesh((1,), ("data",))
    rng = np.random.default_rng(0)
    keys_ = rng.integers(0, 4000, (32, 16), dtype=np.int32)
    groups = rng.integers(0, 2, (32, 16), dtype=np.int32)
    kinds = rng.choice([t.READ, t.WRITE], (32, 16)).astype(np.int32)
    prio = np.stack([np.random.default_rng(w).permutation(32)
                     for w in range(2)]).astype(np.uint32)
    for row in rows[1:3]:
        cfg = JD.DistConfig(n_records=4000, lanes_per_shard=32, slots=16,
                            cc=row["cc"],
                            mv_depth=4 if row["cc"] != "occ" else 0)
        commit, _, stats = JD.make_run_fn(cfg, mesh, 2)(
            *(jnp.asarray(np.broadcast_to(a, (2, 32, 16)))
              for a in (keys_, groups, kinds)), jnp.asarray(prio),
            JD.init_tables(cfg, mesh), jnp.uint32(0))
        s = np.asarray(stats).sum(axis=0)
        assert row["commits"] == int(np.asarray(commit).sum())
        assert row["abort_causes"] == s[JD.STAT_CAUSES].tolist()
        assert row["coll_bytes_per_wave"] == row["wire_bytes_per_wave"]
    # The open-loop rows: JAX run_open_loop on the same candidates and
    # arrival counts (one shard runs the synchronous wave at any depth).
    from repro.workloads.arrivals import PoissonArrivals
    from repro_torch.launch.txn_scaling import open_candidates
    gen = open_candidates(32, 16, 4000)
    arr = PoissonArrivals(rate=0.75 * 32, seed=7).shard_counts(2, 1, 32)
    for row in rows[3:]:
        cfg = JD.DistConfig(n_records=4000, lanes_per_shard=32, slots=16,
                            granularity=row["granularity"], cc=row["cc"],
                            mv_depth=4 if row["cc"] != "occ" else 0,
                            queue_cap=128, max_incarnations=8, lat_bins=32)
        want = JD.run_open_loop(
            cfg, mesh, arr, lambda w: tuple(jnp.asarray(x)
                                            for x in gen(w)), 2)
        for k in ("commits", "aborts", "offered", "admitted",
                  "arrival_drops", "inc_drops", "queued_final",
                  "ro_commits", "ro_aborts", "abort_causes"):
            assert row[k] == want[k], (row["cc"], k)
        assert row["pipeline_depth"] == 1
        assert row["admitted"] == (row["commits"] + row["queued_final"]
                                   + row["inc_drops"])
    # One rank runs depth 1 only (the rows above, deduplicated); more than
    # one rank adds each mechanism's pipelined closed row.
    from repro_torch.launch.txn_scaling import depths
    assert depths(1, 2) == [1] and depths(4, 2) == [1, 2]
    assert depths(4, 1) == [1] and depths(8, 3) == [1, 3]
