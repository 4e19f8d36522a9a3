"""The port's sharded open loop on two gloo ranks against the JAX
package on a 2-device mesh, at pipeline depth 1.

Both run in subprocesses with a hard timeout (the pattern of
tests/test_torch_dist_multi.py): JAX ``run_open_loop`` with 2 forced host
devices (``backend="jnp"``), the port as 2 processes joined through a
``FileStore``, each running its rank's admission ring and lanes.  The
same numpy draws (``test_torch_dist_open.gen_fn``) and per-rank arrival
counts go into both, and the summaries (commits, aborts, the queue's
counters, the causes), the per-rank stats and the per-rank
time-to-commit histograms must be bit-identical: OCC fine and MV-OCC
coarse.  At depth 2 on two ranks ``make_open_run_fn`` gives the
pipelined runner and ``run_open_loop`` runs it with the conservation
identities exact, and ``make_open_wave_fn`` refuses it as the JAX
package does (tests/test_torch_dist_pipeline.py holds depth 2 against
JAX).
"""
import json
import os
import subprocess
import sys
import textwrap

import numpy as np

from repro.workloads.arrivals import PoissonArrivals as JArrivals

ROOT = os.path.join(os.path.dirname(__file__), "..")
TIMEOUT = 240
NS2, N2 = 2, 96

JAX_PROG = textwrap.dedent("""
    import json, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax, jax.numpy as jnp, numpy as np
    from repro.core import distributed as JD
    from test_torch_dist_open import gen_fn
    cases, arr = json.load(open(sys.argv[1])), np.load(sys.argv[2])
    mesh = jax.make_mesh((2,), ("data",))
    out = {}
    for i, (cc, gran, T, K, waves) in enumerate(cases):
        cfg = JD.DistConfig(n_records=96, n_groups=2, lanes_per_shard=T,
                            slots=K, granularity=gran, backend="jnp",
                            cc=cc, mv_depth=3 if cc != "occ" else 0,
                            queue_cap=24, max_incarnations=2, lat_bins=8)
        gen = gen_fn(2 * T, 500 + i)
        s = JD.run_open_loop(cfg, mesh, arr[f"{i}"],
                             lambda w: tuple(jnp.asarray(x)
                                             for x in gen(w)), waves)
        out[f"{i}_summary"] = np.asarray(
            [s[k] for k in ("commits", "aborts", "offered", "admitted",
                            "arrival_drops", "inc_drops", "queued_final")]
            + s["abort_causes"])
        out[f"{i}_lat_hist"] = np.asarray(s["lat_hist"])
        out[f"{i}_per_shard"] = np.asarray(s["per_shard_stats"])
    np.savez(sys.argv[3], **out)
""")

TORCH_PROG = textwrap.dedent("""
    import json, sys
    import numpy as np, pytest
    from repro_torch.core import distributed as D
    from repro_torch.launch.mesh import close_shards, init_shards
    from test_torch_dist_open import gen_fn
    cases, arr = json.load(open(sys.argv[1])), np.load(sys.argv[2])
    sh = init_shards("cpu", init_file=sys.argv[4])
    out = {}
    try:
        for i, (cc, gran, T, K, waves) in enumerate(cases):
            cfg = D.DistConfig(n_records=96, n_groups=2, lanes_per_shard=T,
                               slots=K, granularity=gran, cc=cc,
                               mv_depth=3 if cc != "occ" else 0,
                               queue_cap=24, max_incarnations=2, lat_bins=8)
            s = D.run_open_loop(cfg, arr[f"{i}"], gen_fn(2 * T, 500 + i),
                                waves, device="cpu")
            out[f"{i}_summary"] = np.asarray(
                [s[k] for k in ("commits", "aborts", "offered", "admitted",
                                "arrival_drops", "inc_drops",
                                "queued_final")] + s["abort_causes"])
            out[f"{i}_lat_hist"] = s["lat_hist"]
            out[f"{i}_per_shard"] = s["per_shard_stats"]
        deep = D.DistConfig(n_records=96, lanes_per_shard=4, slots=6,
                            queue_cap=8, pipeline_depth=2)
        assert D.make_open_run_fn(deep, 3).exchange.calls == 0
        s = D.run_open_loop(deep, np.full((3, 2), 3), gen_fn(8, 1), 3,
                            device="cpu")
        assert s["admitted"] == (s["commits"] + s["queued_final"]
                                 + s["inc_drops"]) and s["commits"] > 0
        assert s["offered"] == s["admitted"] + s["arrival_drops"] == 18
        with pytest.raises(ValueError, match="one synchronous wave.*"
                                             "run_open_loop"):
            D.make_open_wave_fn(deep)
    finally:
        close_shards(sh)
    np.savez(sys.argv[3] + f".rank{sh.rank}.npz", **out)
""")

CASES2 = [("occ", 1, 6, 6, 6), ("mvocc", 0, 6, 6, 6)]


def test_two_gloo_ranks_match_the_jax_mesh(tmp_path):
    arr = {f"{i}": JArrivals(rate=9.0, seed=30 + i).shard_counts(
        c[4], NS2, c[2]) for i, c in enumerate(CASES2)}
    cases, data, out = (str(tmp_path / n) for n in
                        ("cases.json", "arr.npz", "out"))
    json.dump(CASES2, open(cases, "w"))
    np.savez(data, **arr)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(ROOT, "src"), os.path.join(ROOT, "tests")]))
    procs = [subprocess.Popen(
        [sys.executable, "-c", JAX_PROG, cases, data, out + ".jax.npz"],
        env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)]
    store = str(tmp_path / "store")
    for r in range(NS2):
        procs.append(subprocess.Popen(
            [sys.executable, "-c", TORCH_PROG, cases, data, out, store],
            env=dict(env, RANK=str(r), WORLD_SIZE=str(NS2)), cwd=ROOT,
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
    want = np.load(out + ".jax.npz")
    ranks = [np.load(out + f".rank{r}.npz") for r in range(NS2)]
    for i in range(len(CASES2)):
        for r in ranks:
            for k in ("summary", "lat_hist", "per_shard"):
                np.testing.assert_array_equal(r[f"{i}_{k}"],
                                              want[f"{i}_{k}"],
                                              err_msg=f"{CASES2[i]} {k}")
        commits, admitted, queued, inc = (want[f"{i}_summary"][j]
                                          for j in (0, 3, 6, 5))
        assert commits > 0 and admitted == commits + queued + inc
