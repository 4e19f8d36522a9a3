"""The software-pipelined sharded wave (``pipeline_depth >= 2``, closed
and open loop) and the axis-wise exchange, against the JAX package.

- Four gloo ranks in subprocesses (the pattern of
  tests/test_torch_dist_multi.py) against JAX on 4 forced host devices
  (``backend="jnp"``), the same numpy draws into both:
  - ``make_run_fn`` at depth 2 and 3 on test_torch_dist_multi's cases
    (OCC, MVCC and MV-OCC at both granularities, unfused OCC, capacity
    drops, scans crossing shard boundaries): per-wave commit masks and
    stats and the final tables bit-identical to JAX at depth 2 (JAX runs
    the same pipelined scan at every depth >= 2; a few cases also at its
    depth 3), and to the port's own depth 1; a run of n waves makes n + 3
    collective calls, against 3 n at depth 1;
  - ``run_open_loop`` at depth 2, with retries and a ring small enough
    that a rejected retry drops into ``inc_drops``: every summary
    counter, ``lat_hist`` and the per-shard stats equal JAX's, the
    conservation identities exact; with ``max_incarnations=0`` every
    counter equals depth 1's;
  - ``topology="axiswise"`` on a 2 x 2 mesh of the same ranks against
    ``jax.make_mesh((2, 2), ...)``: bit-identical to JAX and to the port's
    flat exchange, at twice its bytes;
  - ``make_wave_fn`` and ``make_open_wave_fn`` refuse depth >= 2.
- One gloo rank in the test process: the forced-depth runners
  (``_pipelined_run``, ``_open_loop`` at depth 2) equal the synchronous
  ones; the warm-up steps write no table; one ``exchange(`` call in each
  pipelined step body; the wire model of a two-axis mesh is JAX's.
"""
import ast
import dataclasses
import json
import os
import pathlib
import re
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch

from repro.core import distributed as JD
from repro.workloads.arrivals import PoissonArrivals as JArrivals
from repro_torch.core import convert
from repro_torch.core import distributed as D
from repro_torch.core import types as t
from repro_torch.launch.mesh import close_shards, init_shards
from test_torch_dist_multi import CASES
from test_torch_dist_open import gen_fn

ROOT = os.path.join(os.path.dirname(__file__), "..")
NS, N, T, K, WAVES = 4, 96, 6, 6, 6     # rec_per = 24 records a shard
TIMEOUT = 240
#: A case that JAX also runs at depth 3 (an index into CASES).
DEEP3 = [7]
#: Open loop at depth 2: (cc, granularity, extra fields).
OPEN_CASES = [["occ", 1, {"max_extent": 8}], ["mvocc", 0, {}]]
OPEN_WAVES = 10
OPEN_KW = dict(queue_cap=8, max_incarnations=3, lat_bins=8)
#: The 2 x 2 axis-wise mesh: (cc, granularity, extra fields, depth).
AXIS_CASES = [["occ", 1, {}, 1], ["mvocc", 0, {"max_extent": 8}, 2]]


#: Read by each subprocess: the cases and sizes (``S``, from argv[1]) and
#: the DistConfig fields of a case.
PREAMBLE = """
import json, os, sys
import numpy as np
S = json.loads(sys.argv[1])


def fields(cc, gran, kw):
    return dict(n_records=S["N"], n_groups=2, lanes_per_shard=S["T"],
                slots=S["K"], granularity=gran, cc=cc,
                mv_depth=3 if cc != "occ" else 0, **kw)


def candidates(data, i):
    return lambda w: tuple(data[f"open{i}_{f}"][w] for f in
                           ("keys", "groups", "kinds", "prio"))
"""

JAX_HEAD = PREAMBLE + """
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
os.environ["JAX_PLATFORMS"] = "cpu"
import jax, jax.numpy as jnp
from repro.core import distributed as JD
"""

JAX_CLOSED = JAX_HEAD + textwrap.dedent("""
    data, mine = np.load(sys.argv[2]), json.loads(sys.argv[4])
    mesh = jax.make_mesh((4,), ("data",))
    out = {}
    for i in mine:
        cc, gran, kw = S["CASES"][i]
        for depth in (2, 3) if i in S["DEEP3"] else (2,):
            cfg = JD.DistConfig(**fields(cc, gran, kw), backend="jnp",
                                pipeline_depth=depth)
            c, tables, s = jax.jit(JD.make_run_fn(cfg, mesh, S["WAVES"]))(
                *(jnp.asarray(data[f"{i}_{f}"]) for f in
                  ("keys", "groups", "kinds", "prio")),
                JD.init_tables(cfg, mesh), jnp.uint32(0))
            out[f"{i}_{depth}_commit"] = np.asarray(c)
            out[f"{i}_{depth}_stats"] = np.asarray(s)
            for j, x in enumerate(tables):
                out[f"{i}_{depth}_table_{j}"] = np.asarray(x)
    np.savez(sys.argv[3], **out)
""")

JAX_OTHER = JAX_HEAD + textwrap.dedent("""
    data, arr = np.load(sys.argv[2]), np.load(sys.argv[3])
    mesh = jax.make_mesh((4,), ("data",))
    out = {}
    for i, (cc, gran, kw) in enumerate(S["OPEN_CASES"]):
        cfg = JD.DistConfig(**fields(cc, gran, kw), **S["OPEN_KW"],
                            backend="jnp", pipeline_depth=2)
        gen = candidates(data, i)
        s = JD.run_open_loop(cfg, mesh, arr[f"{i}"],
                             lambda w: tuple(jnp.asarray(x)
                                             for x in gen(w)),
                             S["OPEN_WAVES"])
        out[f"open{i}_summary"] = np.asarray(
            [s[k] for k in ("commits", "aborts", "ro_commits", "ro_aborts",
                            "offered", "admitted", "arrival_drops",
                            "inc_drops", "queued_final")]
            + s["abort_causes"])
        out[f"open{i}_lat_hist"] = np.asarray(s["lat_hist"])
        out[f"open{i}_per_shard"] = np.asarray(s["per_shard_stats"])
    mesh2 = jax.make_mesh((2, 2), ("pod", "data"))
    for i, (cc, gran, kw, depth) in enumerate(S["AXIS_CASES"]):
        cfg = JD.DistConfig(**fields(cc, gran, kw), backend="jnp",
                            pipeline_depth=depth, topology="axiswise")
        c, tables, s = jax.jit(JD.make_run_fn(cfg, mesh2, S["WAVES"]))(
            *(jnp.asarray(data[f"axis{i}_{f}"]) for f in
              ("keys", "groups", "kinds", "prio")),
            JD.init_tables(cfg, mesh2), jnp.uint32(0))
        out[f"axis{i}_commit"] = np.asarray(c)
        out[f"axis{i}_stats"] = np.asarray(s)
        for j, x in enumerate(tables):
            out[f"axis{i}_table_{j}"] = np.asarray(x)
        out[f"axis{i}_wire"] = np.asarray(
            JD.wire_bytes_per_wave(cfg, mesh2)["wire_bytes_per_wave"])
    np.savez(sys.argv[4], **out)
""")

TORCH_PROG = PREAMBLE + textwrap.dedent("""
    import dataclasses
    import pytest, torch
    from repro_torch.core import convert, distributed as D
    from repro_torch.launch.mesh import close_shards, init_shards
    data, arr = np.load(sys.argv[2]), np.load(sys.argv[3])
    T, WAVES, OPEN_WAVES = S["T"], S["WAVES"], S["OPEN_WAVES"]
    sh = init_shards("cpu", init_file=sys.argv[5], mesh_shape=(2, 2))
    mine = slice(sh.rank * T, (sh.rank + 1) * T)
    out = {}

    def run(cfg, key, mesh_shape=None):
        run = D.make_run_fn(cfg, WAVES, mesh_shape=mesh_shape)
        c, tables, s = run(*(torch.from_numpy(np.ascontiguousarray(
            data[f"{key}_{f}"][:, mine].astype(np.int32)))
            for f in ("keys", "groups", "kinds", "prio")),
            D.init_tables(cfg, None, "cpu"))
        out[f"{key}_{cfg.pipeline_depth}_commit"] = c.numpy()
        out[f"{key}_{cfg.pipeline_depth}_stats"] = s.numpy()
        for j, x in enumerate(convert.dist_tables_to_numpy(cfg, tables)):
            out[f"{key}_{cfg.pipeline_depth}_table_{j}"] = x
        return run.exchange

    try:
        for i, (cc, gran, kw) in enumerate(S["CASES"]):
            ex = {d: run(D.DistConfig(**fields(cc, gran, kw),
                                      pipeline_depth=d), f"{i}")
                  for d in (1, 2, 3)}
            cfg = D.DistConfig(**fields(cc, gran, kw))
            words = 4 * (2 * cfg.cap(4) + 2 * D.verdict_words(cfg.cap(4)))
            assert ex[1].calls == 3 * WAVES
            for d in (2, 3):
                assert ex[d].calls == WAVES + 3, (d, ex[d].calls)
                assert ex[d].bytes_sent == (WAVES + 3) * words * 4
                assert ex[d].bytes_sent // (WAVES + 3) == \\
                    D.wire_bytes_per_wave(cfg, 4)["wire_bytes_per_wave"]
        for i, (cc, gran, kw) in enumerate(S["OPEN_CASES"]):
            cfg = D.DistConfig(**fields(cc, gran, kw), **S["OPEN_KW"],
                               pipeline_depth=2)
            gen = candidates(data, i)
            s = D.run_open_loop(cfg, arr[f"{i}"], gen, OPEN_WAVES,
                                device="cpu")
            out[f"open{i}_summary"] = np.asarray(
                [s[k] for k in ("commits", "aborts", "ro_commits",
                                "ro_aborts", "offered", "admitted",
                                "arrival_drops", "inc_drops",
                                "queued_final")] + s["abort_causes"])
            out[f"open{i}_lat_hist"] = s["lat_hist"]
            out[f"open{i}_per_shard"] = s["per_shard_stats"]
            # Without retries depth 2 admits, commits and drops as depth 1.
            flat = [D.run_open_loop(
                dataclasses.replace(cfg, max_incarnations=0,
                                    pipeline_depth=d),
                arr[f"{i}"], gen, OPEN_WAVES, device="cpu") for d in (1, 2)]
            for k, v in flat[0].items():
                if k not in ("wall_s", "exchange_bytes"):
                    np.testing.assert_array_equal(flat[1][k], v, err_msg=k)
            assert flat[0]["commits"] > 0
        for i, (cc, gran, kw, depth) in enumerate(S["AXIS_CASES"]):
            cfg = D.DistConfig(**fields(cc, gran, kw),
                               pipeline_depth=depth, topology="axiswise")
            ex_axis = run(cfg, f"axis{i}", mesh_shape=(2, 2))
            ex_flat = run(dataclasses.replace(cfg, topology="flat"),
                          f"axis{i}flat")
            assert ex_axis.calls == 2 * ex_flat.calls
            assert ex_axis.bytes_sent == 2 * ex_flat.bytes_sent
            steps = WAVES + 3 if depth > 1 else WAVES
            assert ex_axis.bytes_sent == steps * D.wire_bytes_per_wave(
                cfg, 4, (2, 2))["wire_bytes_per_wave"]
        deep = D.DistConfig(**fields("occ", 1, {}), pipeline_depth=2)
        with pytest.raises(ValueError, match="one synchronous wave per call"):
            D.make_wave_fn(deep)
        with pytest.raises(ValueError, match="one synchronous wave per call"):
            D.make_open_wave_fn(dataclasses.replace(deep, queue_cap=8))
    finally:
        close_shards(sh)
    np.savez(sys.argv[4] + f".rank{sh.rank}.npz", **out)
""")


def _fields(cc, gran, kw):
    return dict(n_records=N, n_groups=2, lanes_per_shard=T, slots=K,
                granularity=gran, cc=cc, mv_depth=3 if cc != "occ" else 0,
                **kw)


def _batch(rng, lanes, scans):
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
        kinds = np.where(sc, kinds | (ext << 2), kinds)
    return keys, groups, kinds, rng.permutation(lanes)


def _draws(key, kw, seed, data, lanes=NS * T):
    """WAVES global batches: masked slots, every kind, and with scans
    READ intervals of up to 8 records started near shard boundaries."""
    rng = np.random.default_rng(seed)
    waves = [_batch(rng, lanes, kw.get("max_extent", 1) > 1)
             for _ in range(WAVES)]
    for j, f in enumerate(("keys", "groups", "kinds", "prio")):
        data[f"{key}_{f}"] = np.stack([w[j] for w in waves]).astype(
            np.uint32 if f == "prio" else np.int32)


def _spawn(prog, args, env, **kw):
    return subprocess.Popen([sys.executable, "-c", prog, *args], env=env,
                            cwd=ROOT, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, **kw)


def _same_run(got, want, what, n_tables):
    for f in ("commit", "stats"):
        np.testing.assert_array_equal(got(f), want(f), err_msg=f"{what} {f}")
    for j in range(n_tables):
        np.testing.assert_array_equal(got(f"table_{j}"), want(f"table_{j}"),
                                      err_msg=f"{what} table {j}")


def test_four_gloo_ranks_pipelined_match_the_jax_mesh(tmp_path):
    data = {}
    for i, (_, _, kw) in enumerate(CASES):
        _draws(f"{i}", kw, 60 + i, data)
    for i, (_, _, kw, _) in enumerate(AXIS_CASES):
        _draws(f"axis{i}", kw, 90 + i, data)
        for f in ("keys", "groups", "kinds", "prio"):
            data[f"axis{i}flat_{f}"] = data[f"axis{i}_{f}"]
    for i, (_, _, kw) in enumerate(OPEN_CASES):
        gen = gen_fn(NS * T, 700 + i, scans=kw.get("max_extent", 1) > 1)
        for j, f in enumerate(("keys", "groups", "kinds", "prio")):
            data[f"open{i}_{f}"] = np.stack([gen(w)[j]
                                             for w in range(OPEN_WAVES)])
    arr = {f"{i}": JArrivals(rate=28.0, seed=80 + i).shard_counts(
        OPEN_WAVES, NS, T) for i in range(len(OPEN_CASES))}
    spec = json.dumps(dict(
        N=N, T=T, K=K, WAVES=WAVES, CASES=CASES, DEEP3=DEEP3,
        OPEN_CASES=OPEN_CASES, OPEN_KW=OPEN_KW, OPEN_WAVES=OPEN_WAVES,
        AXIS_CASES=AXIS_CASES))
    dpath, apath, out = (str(tmp_path / n) for n in
                         ("data.npz", "arr.npz", "out"))
    np.savez(dpath, **data)
    np.savez(apath, **arr)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    # JAX compiles one program a case and depth: two processes share them.
    halves = (list(range(0, len(CASES), 2)), list(range(1, len(CASES), 2)))
    procs = [_spawn(JAX_CLOSED, [spec, dpath, out + f".closed{h}.npz",
                                 json.dumps(half)], env)
             for h, half in enumerate(halves)]
    procs.append(_spawn(JAX_OTHER, [spec, dpath, apath, out + ".other.npz"],
                        env))
    store = str(tmp_path / "store")
    for r in range(NS):
        procs.append(_spawn(TORCH_PROG, [spec, dpath, apath, out, store],
                            dict(env, RANK=str(r), WORLD_SIZE=str(NS))))
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=TIMEOUT)[0])
    finally:
        for p in procs:
            p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    closed = {**np.load(out + ".closed0.npz"), **np.load(out + ".closed1.npz")}
    other = np.load(out + ".other.npz")
    ranks = [np.load(out + f".rank{r}.npz") for r in range(NS)]

    def port(key):
        def get(f):
            if f.startswith("table"):
                return ranks[0][f"{key}_{f}"]
            return np.concatenate([r[f"{key}_{f}"] for r in ranks], axis=1)
        return get

    def jax_(src, key):
        # Commit [waves, NS * T] and stats [waves, NS * STATS_LEN] hold the
        # shards side by side, as the ranks' rows concatenated.
        return lambda f: src[f"{key}_{f}"]

    for i, (cc, gran, kw) in enumerate(CASES):
        what = f"{cc}-{gran}-{kw}"
        nt = 4 if cc != "occ" else 2
        for d in (2, 3):
            _same_run(port(f"{i}_{d}"), jax_(closed, f"{i}_2"),
                      f"{what} depth {d} vs JAX", nt)
            _same_run(port(f"{i}_{d}"), port(f"{i}_1"),
                      f"{what} depth {d} vs depth 1", nt)
        if i in DEEP3:
            _same_run(jax_(closed, f"{i}_3"), jax_(closed, f"{i}_2"),
                      f"{what} JAX depth 3 vs 2", nt)
        total = port(f"{i}_2")("stats").reshape(WAVES, NS, -1) \
            .sum(axis=(0, 1))
        assert total[D.STAT_COMMITS] > 0
        assert total[D.STAT_CAUSES].sum() == total[D.STAT_ABORTS]
        if "route_cap" in kw:
            assert total[D.STAT_DROPPED_OPS] > 0
        if kw.get("max_extent", 1) > 1 and cc != "mvcc":
            assert total[D.STAT_CAUSE0 + t.CAUSE_PHANTOM] > 0

    rejected = 0
    for i in range(len(OPEN_CASES)):
        for r in ranks:
            for k in ("summary", "lat_hist", "per_shard"):
                np.testing.assert_array_equal(
                    r[f"open{i}_{k}"], other[f"open{i}_{k}"],
                    err_msg=f"{OPEN_CASES[i]} {k}")
        (commits, aborts, _, _, offered, admitted, arrival_drops, inc_drops,
         queued) = other[f"open{i}_summary"][:9]
        causes = other[f"open{i}_summary"][9:]
        assert commits > 0 and admitted == commits + queued + inc_drops
        assert offered == admitted + arrival_drops and arrival_drops > 0
        assert causes.sum() == aborts
        rejected += inc_drops - causes[t.CAUSE_INC_CAP]
    assert rejected > 0            # a retry the full ring rejected

    for i, (cc, gran, kw, depth) in enumerate(AXIS_CASES):
        what = f"axis-wise {cc}-{gran}-{kw} depth {depth}"
        nt = 4 if cc != "occ" else 2
        _same_run(port(f"axis{i}_{depth}"), jax_(other, f"axis{i}"), what,
                  nt)
        _same_run(port(f"axis{i}_{depth}"), port(f"axis{i}flat_{depth}"),
                  what + " vs flat", nt)
        cfg = D.DistConfig(**_fields(cc, gran, kw), pipeline_depth=depth,
                           topology="axiswise")
        assert D.wire_bytes_per_wave(cfg, NS, (2, 2))[
            "wire_bytes_per_wave"] == int(other[f"axis{i}_wire"]) == 2 * \
            D.wire_bytes_per_wave(cfg, NS)["wire_bytes_per_wave"]


# ------------------------------------------------ one rank, in process
@pytest.fixture(scope="module")
def shards():
    sh = init_shards("cpu")
    yield sh
    close_shards(sh)


def _stacked(kw, seed, waves=WAVES):
    """One rank's stacked (keys, groups, kinds, prio) of ``waves`` waves."""
    rng = np.random.default_rng(seed)
    ws = [_batch(rng, T, kw.get("max_extent", 1) > 1) for _ in range(waves)]
    return [torch.from_numpy(np.stack([w[j] for w in ws]).astype(np.int32))
            for j in range(4)]


IDS = [f"{c}-{g}-{'-'.join(map(str, k.items()))}" for c, g, k in CASES]


@pytest.mark.parametrize("cc,gran,kw", CASES, ids=IDS)
def test_one_rank_pipeline_equals_the_synchronous_runner(shards, cc, gran,
                                                         kw):
    """``_pipelined_run`` forces the pipeline on one rank (the card's
    entry): commit masks, stats and tables equal ``make_run_fn``'s, in
    WAVES + 3 exchanges of the fused buffer against 3 x WAVES."""
    cfg = D.DistConfig(**_fields(cc, gran, kw), pipeline_depth=2)
    assert cfg.depth(1) == 1
    st = _stacked(kw, 7 + len(cc) + gran)
    sync = D.make_run_fn(cfg, WAVES)
    want = sync(*st, D.init_tables(cfg, None, "cpu"))
    run = D._pipelined_run(cfg, WAVES)
    got = run(*st, D.init_tables(cfg, None, "cpu"))
    for name, a, b in (("commit", got[0], want[0]), ("stats", got[2],
                                                      want[2])):
        assert torch.equal(a, b), name
    for i, (a, b) in enumerate(zip(got[1], want[1])):
        assert torch.equal(a, b), f"table {i}"
    assert sync.exchange.calls == 3 * WAVES
    assert run.exchange.calls == WAVES + 3
    cap = cfg.cap(1)
    assert run.exchange.bytes_sent == (WAVES + 3) * 4 * (
        2 * cap + 2 * D.verdict_words(cap))
    assert run.exchange.bytes_sent == (WAVES + 3) * D.wire_bytes_per_wave(
        cfg, 1)["wire_bytes_per_wave"]
    assert int(want[0].sum()) > 0


@pytest.mark.parametrize("cc,gran,kw", CASES, ids=IDS)
def test_warmup_steps_write_no_table(shards, cc, gran, kw):
    """The first step's owner phases run on the empty slots at waves -3
    (install) and -1 (claim): no table changes, and the verdict and commit
    words it sends are zero.  A run of NOP waves from wave 0 (every step a
    warm-up or drain step) leaves the tables as they were."""
    cfg = D.DistConfig(**_fields(cc, gran, kw))
    st = _stacked(kw, 11 + gran)
    tables = D.init_tables(cfg, None, "cpu")
    D.make_run_fn(cfg, 4)(*(x[:4] for x in st), tables)   # claims, stamps
    before = [x.clone() for x in tables]
    step = D._make_pipeline_step(cfg, 1, D.Exchange())
    carry = (tables,) + D._pipe_carry_init(cfg, 1, "cpu")
    carry, _, _ = step(carry, *(x[4] for x in st), torch.tensor(0))
    for i, (a, b) in enumerate(zip(tables, before)):
        assert torch.equal(a, b), f"table {i} after step 0"
    assert not carry[4].any() and not carry[5].any()      # v and c words
    nop = [torch.stack([x] * 3) for x in D._nop_wave(cfg, "cpu")]
    c, _, s = D._pipelined_run(cfg, 3)(*nop, tables)
    for i, (a, b) in enumerate(zip(tables, before)):
        assert torch.equal(a, b), f"table {i} after NOP waves"
    assert bool(c.all()) and int(s[:, D.STAT_ABORTS].sum()) == 0


OPEN_ONE = [("occ", 0, {}), ("mvcc", 1, {}), ("mvocc", 1, {"max_extent": 8})]


@pytest.mark.parametrize("cc,gran,kw", OPEN_ONE,
                         ids=[f"{c}-{g}" for c, g, _ in OPEN_ONE])
def test_one_rank_open_pipeline(shards, cc, gran, kw):
    """``_open_loop`` at depth 2 on one rank (the card's entry): the
    conservation identities hold exactly; without retries every counter,
    ``lat_hist`` and the per-rank stats equal depth 1's."""
    cfg = D.DistConfig(**_fields(cc, gran, kw), **OPEN_KW)
    gen = gen_fn(T, 300 + gran, scans=kw.get("max_extent", 1) > 1)
    arr = JArrivals(rate=7.0, seed=5).shard_counts(OPEN_WAVES, 1, T)
    s = D._open_loop(cfg, arr, gen, OPEN_WAVES, None, "cpu", None, 2)
    assert s["admitted"] == s["commits"] + s["queued_final"] + s["inc_drops"]
    assert s["offered"] == s["admitted"] + s["arrival_drops"]
    assert sum(s["abort_causes"]) == s["aborts"]
    assert s["abort_causes"][t.CAUSE_INC_CAP] <= s["inc_drops"]
    assert int(s["lat_hist"].sum()) == s["commits"] > 0
    assert s["exchange_bytes"] == (OPEN_WAVES + 3) * D.wire_bytes_per_wave(
        cfg, 1)["wire_bytes_per_wave"]
    flat = dataclasses.replace(cfg, max_incarnations=0)
    a, b = (D._open_loop(flat, arr, gen, OPEN_WAVES, None, "cpu", None, d)
            for d in (1, 2))
    for k, v in a.items():
        if k not in ("wall_s", "exchange_bytes"):
            np.testing.assert_array_equal(b[k], v, err_msg=k)


def test_open_run_fn_requires_pipelined_config(shards):
    cfg = D.DistConfig(**_fields("occ", 1, {}), queue_cap=8,
                       pipeline_depth=2)
    with pytest.raises(ValueError, match="make_open_wave_fn"):
        D.make_open_run_fn(cfg, 4)                 # one shard: depth 1
    with pytest.raises(ValueError, match="queue_cap"):
        D.make_open_run_fn(dataclasses.replace(cfg, queue_cap=0), 4)
    with pytest.raises(ValueError, match="does not cover"):
        D.make_run_fn(cfg, 4, mesh_shape=(2, 2))


def test_single_exchange_ast_guard():
    """``all_to_all_single`` appears once, in ``Exchange``; each pipelined
    step body calls ``exchange(`` once and the synchronous body three
    times (JAX tests/test_pipeline.py's guard)."""
    tree = ast.parse(pathlib.Path(D.__file__).read_text())
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.FunctionDef, ast.ClassDef)):
            b = node.body
            if (b and isinstance(b[0], ast.Expr)
                    and isinstance(b[0].value, ast.Constant)
                    and isinstance(b[0].value.value, str)):
                node.body = b[1:] or [ast.Pass()]
    assert ast.unparse(tree).count("all_to_all_single") == 1
    defs = {n.name: ast.unparse(n) for n in tree.body
            if isinstance(n, (ast.FunctionDef, ast.ClassDef))}
    assert "all_to_all_single" in defs["Exchange"]
    call = re.compile(r"(?<![\w.])exchange\(")
    assert len(call.findall(defs["_make_pipeline_step"])) == 1
    assert len(call.findall(defs["_make_open_pipeline_step"])) == 1
    assert len(call.findall(defs["_make_shard_body"])) == 3


@pytest.mark.parametrize("topology", ["flat", "axiswise"])
@pytest.mark.parametrize("shape", [(1,), (1, 1), (1, 1, 1)])
def test_wire_bytes_take_the_mesh(topology, shape):
    """The wire model counts one hop per axis of an axis-wise mesh of two
    or more axes, as JAX's ``wire_bytes_per_wave``."""
    jcfg = JD.DistConfig(n_records=N, lanes_per_shard=T, slots=K,
                         topology=topology, backend="jnp")
    cfg = convert.dist_config_from_fields(dataclasses.asdict(jcfg))
    mesh = jax.make_mesh(shape, ("a", "b", "c")[:len(shape)])
    want = JD.wire_bytes_per_wave(jcfg, mesh)
    assert D.wire_bytes_per_wave(cfg, 1, shape) == want
    hops = len(shape) if topology == "axiswise" and len(shape) > 1 else 1
    assert want["wire_bytes_per_wave"] == hops * D.wire_bytes_per_wave(
        cfg, 1)["wire_bytes_per_wave"]
