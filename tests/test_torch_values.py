"""Tracked values in the port (``EngineConfig.track_values``) against the
JAX package, every float compared as its float32 bits.

- ``apply_values`` (the serial replay, kernels/apply_values.py) against
  JAX ``engine.apply_values``, flat and into the version ring
  (``slot_of``): masked ops, keys -1 and past the table, duplicate cells
  in a lane and across lanes, WRITE after ADD and ADD after WRITE,
  non-integer deltas, ties of priority, uncommitted lanes.
- MVCC coarse and MV-OCC fine (the open-loop file runs the other two)
  replaying the JAX engine's draws
  (tests/port_harness.py): ``values`` and ``mv_vals`` bit-identical to
  JAX ``run(..., track_values=True)``, and the ring's newest version of
  every record equal to the flat values (the JAX package's value oracle).
- ``snapshot_values`` against JAX's on the ring of such a run, at the
  run's last snapshot and at aged ones; a read that is ``ok`` equals the
  flat values of the wave it snapshots.
- The ADD conservation law (JAX tests/test_cc.py): every committed ADD of
  1.0 lands once, so the stored sum is the count of committed ADDs.
- The convert round trip of a tracked store, and an untracked run's
  placeholders: no ``apply_values`` call, an empty ``values``.
- A tracked wave reads no device value on the host outside the backend
  ops (the guard of tests/test_torch_device_wave.py).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from port_harness import (assert_values_parity, f32_bits, jax_draws,
                          port_replay)
from repro.core import engine as jengine
from repro.core import mvstore as jmv
from repro.core import types as jt
from repro.workloads import YCSBWorkload
from repro_torch import kernels as K
from repro_torch.core import backend as kb
from repro_torch.core import convert
from repro_torch.core import mvstore as pmv
from repro_torch.core import types as pt
from repro_torch.core.engine import (arrival_rate, draw_wave,
                                     make_wave_step, run)
from repro_torch.kernels.apply_values import apply_values_plain
from repro_torch.launch.txn_bench import make_config, make_workload
from repro_torch.workloads import YCSBWorkload as PYCSB
from test_torch_device_wave import guarded

LANES, WAVES, SEED = 8, 6, 2
WL = YCSBWorkload.make(n_keys=300, theta=0.9, write_frac=0.5)


@pytest.fixture(scope="module")
def draws():
    return jax_draws(WL, LANES, WAVES, seed=SEED)


# ----------------------------------------------------- apply_values itself
def _replay_case(seed, N=11, D=3, C=4, T=6, K=7):
    """A wave of ops built to reach apply_values' edges, as numpy."""
    rng = np.random.default_rng(seed)
    hot = rng.integers(0, N, 3)
    key = rng.integers(0, N, (T, K))
    pick = rng.random((T, K))
    key = np.where(pick < 0.45, hot[rng.integers(0, 3, (T, K))], key)
    key = np.where(pick > 0.92, -1, key)
    key = np.where((pick > 0.88) & (pick <= 0.92), N + 2, key)
    key[0, :3] = hot[0]                    # one cell thrice in one lane
    col = rng.integers(0, C, (T, K))
    col[0, :3] = 1
    kind = rng.choice([jt.NOP, jt.READ, jt.WRITE, jt.ADD], (T, K),
                      p=[0.1, 0.2, 0.3, 0.4])
    kind[0, :3] = (jt.ADD, jt.WRITE, jt.ADD)
    val = (rng.standard_normal((T, K)) * 3.7).astype(np.float32)
    commit = rng.random(T) < 0.7
    commit[0] = True
    prio = rng.permutation(T).astype(np.uint32)
    prio[-1] = prio[-2]                    # a tie: lane order breaks it
    values = (rng.standard_normal((N, C)) * 0.3).astype(np.float32)
    ring = (rng.standard_normal((N, D, C)) * 0.3).astype(np.float32)
    slot_of = rng.integers(0, D, N).astype(np.int32)
    return dict(key=key.astype(np.int32), col=col.astype(np.int32),
                kind=kind.astype(np.int32), val=val, commit=commit,
                prio=prio, values=values, ring=ring, slot_of=slot_of)


def _batches(c):
    T, K = c["key"].shape
    fields = dict(op_key=c["key"], op_group=np.zeros_like(c["key"]),
                  op_col=c["col"], op_kind=c["kind"], op_val=c["val"],
                  txn_type=np.zeros(T, np.int32),
                  n_ops=np.full(T, K, np.int32))
    return (convert.batch_from_numpy(fields, "cpu"),
            jt.TxnBatch(**{k: jnp.asarray(v) for k, v in fields.items()}))


@pytest.mark.parametrize("ring", [False, True], ids=["flat", "ring"])
@pytest.mark.parametrize("seed", range(3))
def test_apply_values_matches_jax(seed, ring):
    c = _replay_case(seed)
    pb, jb = _batches(c)
    vals = c["ring"] if ring else c["values"]
    slot = c["slot_of"] if ring else None
    want = jengine.apply_values(
        jnp.asarray(vals), jb, jnp.asarray(c["commit"]),
        jnp.asarray(c["prio"]), None if slot is None else jnp.asarray(slot))
    got = torch.from_numpy(vals.copy())
    before = K.WRAPPERS["apply_values"].calls
    out = kb.BACKEND.apply_values(
        got, pb, torch.from_numpy(c["commit"]),
        torch.from_numpy(c["prio"].astype(np.int32)),
        None if slot is None else torch.from_numpy(slot))
    assert out is got and K.WRAPPERS["apply_values"].calls == before + 1
    np.testing.assert_array_equal(f32_bits(got), f32_bits(want))
    # The replay changed cells: the case reaches the function.
    assert not np.array_equal(f32_bits(got), f32_bits(vals))


def test_apply_values_order_decides_the_bits():
    """Three adds of one cell whose float32 sum depends on their order:
    the replay takes the priority order, not the lane order."""
    T, K = 3, 1
    fields = dict(op_key=np.zeros((T, K), np.int32),
                  op_group=np.zeros((T, K), np.int32),
                  op_col=np.zeros((T, K), np.int32),
                  op_kind=np.full((T, K), pt.ADD, np.int32),
                  op_val=np.array([[1e8], [1.0], [-1e8]], np.float32),
                  txn_type=np.zeros(T, np.int32),
                  n_ops=np.ones(T, np.int32))
    batch = convert.batch_from_numpy(fields, "cpu")
    commit = torch.ones(T, dtype=torch.bool)
    outs = []
    for prio in ([0, 1, 2], [0, 2, 1]):
        v = torch.zeros((1, 1))
        apply_values_plain(v, batch, commit, torch.tensor(prio,
                                                          dtype=torch.int32))
        outs.append(float(v))
    assert outs == [0.0, 1.0]


# ------------------------------------------- the ring: MVCC and MV-OCC
@pytest.mark.parametrize("cc,gran", [(jt.CC_MVCC, 0), (jt.CC_MVOCC, 1)],
                         ids=["mvcc-coarse", "mvocc-fine"])
def test_ring_values_match_jax(draws, cc, gran):
    state = assert_values_parity(WL, cc, gran, LANES, draws, seed=SEED)
    store = state.store
    assert int(state.commits) > 0 and int((store.mv_head != 0).sum()) > 0
    newest = store.mv_vals[torch.arange(store.n_records),
                           store.mv_head.long()]
    assert torch.equal(newest, store.values)


def _history(cc, gran, waves=WAVES):
    """A tracked MV replay of the draws keeping the flat values after
    every wave: (final state, [values before wave w for w in 0..waves])."""
    jcfg = jt.EngineConfig(
        cc=cc, lanes=LANES, slots=WL.slots, n_records=WL.n_records,
        n_groups=WL.n_groups, n_cols=WL.n_cols, n_txn_types=WL.n_txn_types,
        granularity=gran, n_rings=WL.n_rings, mv_depth=3, track_values=True)
    cfg = convert.config_from_fields(dataclasses.asdict(jcfg))
    ds = jax_draws(WL, LANES, waves, seed=SEED)
    seen = [torch.zeros((WL.n_records, WL.n_cols))]
    state = None
    store0 = convert.store_to_numpy(pt.store_init(
        WL.n_records, WL.n_groups, WL.n_rings, device="cpu", mv_depth=3,
        n_cols=WL.n_cols))
    for w in range(1, waves + 1):
        state = port_replay(cfg, store0, ds[:w])
        seen.append(state.store.values.clone())
    return state, seen


@pytest.mark.parametrize("fine", [False, True], ids=["coarse", "fine"])
def test_snapshot_values_match_jax(fine):
    """Reads of every record and column at the run's last snapshot and at
    aged ones (the ring holds 3 versions, so the oldest are reclaimed):
    value and ok equal to JAX ``snapshot_values``, and an ok read equal
    to the flat value of the wave it snapshots."""
    state, seen = _history(jt.CC_MVCC, int(fine))
    st = state.store
    N, C = WL.n_records, WL.n_cols
    keys = np.repeat(np.arange(-1, N + 1, dtype=np.int32), C)[None, :]
    cols = np.tile(np.arange(C, dtype=np.int32), N + 2)[None, :]
    groups = (cols % 2).astype(np.int32)
    j_vals, j_begin = jnp.asarray(st.mv_vals.numpy()), jnp.asarray(
        st.mv_begin.numpy().view(np.uint32))
    n_ok = n_stale = 0
    for ts in range(WAVES + 1):
        got_v, got_ok = pmv.snapshot_values(
            st.mv_vals, st.mv_begin, torch.from_numpy(keys),
            torch.from_numpy(groups), torch.from_numpy(cols), ts, fine)
        want_v, want_ok = jmv.snapshot_values(
            j_vals, j_begin, jnp.asarray(keys), jnp.asarray(groups),
            jnp.asarray(cols), jnp.uint32(ts), fine)
        np.testing.assert_array_equal(got_ok.numpy(), np.asarray(want_ok))
        np.testing.assert_array_equal(f32_bits(got_v), f32_bits(want_v))
        ok = got_ok.numpy()[0]
        live = (keys[0] >= 0) & (keys[0] < N)
        assert not ok[~live].any()
        flat = seen[ts].numpy()[np.clip(keys[0], 0, N - 1), cols[0]]
        np.testing.assert_array_equal(f32_bits(got_v.numpy()[0][ok]),
                                      f32_bits(flat[ok]))
        n_ok += int(ok.sum())
        n_stale += int((~ok & live).sum())
    assert n_ok > 0 and n_stale > 0


# -------------------------------------------------------- the port alone
class _AddWorkload:
    """The port's YCSB with every write an ADD of 1.0."""

    def __init__(self, wl):
        self._wl = wl

    def __getattr__(self, name):
        return getattr(self._wl, name)

    def gen(self, gen, wave, lanes, tails):
        b, tails = self._wl.gen(gen, wave, lanes, tails)
        return dataclasses.replace(
            b, op_kind=torch.where(b.op_kind == pt.WRITE, pt.ADD,
                                   b.op_kind),
            op_val=torch.ones_like(b.op_val)), tails


@pytest.mark.parametrize("cc", ["occ", "mvocc"])
def test_add_conservation(cc):
    """Every committed ADD lands exactly once (the law of JAX
    tests/test_cc.py), in the flat values and, under MV-OCC, in the
    ring's newest versions: an open-loop run whose writes are ADDs of
    1.0, its lane forensics giving each wave's committed ADDs."""
    wl = _AddWorkload(PYCSB.make(n_keys=64, theta=0.5, write_frac=0.6,
                                 ops_per_txn=4))
    cfg = dataclasses.replace(make_config(wl, cc, 1, 8, arrival_rate=6.0),
                              track_values=True)
    res = run(cfg, wl, 12, seed=3, device="cpu", keep_state=True,
              trace=True)
    st = res.final_state.store
    _, _, _, _, key, kind, commit = res.trace
    adds = int(((kind == pt.ADD) & (key >= 0) & commit[..., None]).sum())
    assert res.commits > 0 and res.aborts > 0 and adds > 0
    assert float(st.values.sum()) == adds
    if cc == "mvocc":
        newest = st.mv_vals[torch.arange(st.n_records), st.mv_head.long()]
        assert torch.equal(newest, st.values)


def test_store_round_trips_values():
    store = pt.store_init(7, 2, 1, device="cpu", mv_depth=3, n_cols=4,
                          values=torch.randn(7, 4))
    store.mv_vals[:, 1:] = torch.randn(7, 2, 4)
    back = convert.store_from_numpy(convert.store_to_numpy(store), "cpu")
    assert back.tracks_values
    for k in ("values", "mv_vals", "mv_begin", "mv_head"):
        assert torch.equal(getattr(back, k), getattr(store, k)), k
    assert torch.equal(store.mv_vals[:, 0], store.values)
    plain = pt.store_init(7, 2, 1, device="cpu", mv_depth=3)
    arrays = convert.store_to_numpy(plain)
    assert "values" not in arrays and "mv_vals" not in arrays
    back = convert.store_from_numpy(arrays, "cpu")
    assert not back.tracks_values and back.values.numel() == 0
    assert tuple(back.mv_vals.shape) == (1, 1, 1)


@pytest.mark.parametrize("cc", ["occ", "mvcc"])
def test_untracked_runs_launch_nothing_new(cc):
    """Untracked: no apply_values call and placeholder values; tracked:
    one call a wave, two under MVCC (the flat values and the ring)."""
    wl = make_workload("ycsb", n_keys=200, theta=0.9)
    calls = {}
    for track in (False, True):
        cfg = dataclasses.replace(make_config(wl, cc, 0, 8),
                                  track_values=track)
        K.reset_launches()
        res = run(cfg, wl, 4, device="cpu", keep_state=True)
        calls[track] = K.call_counts()
        st = res.final_state.store
        assert st.tracks_values == track
        if not track:
            assert st.values.numel() == 0
            assert tuple(st.mv_vals.shape) == (1, 1, 1)
    assert calls[False]["apply_values"] == 0
    assert calls[True]["apply_values"] == 4 * (2 if cc == "mvcc" else 1)
    assert {op: n for op, n in calls[True].items() if op != "apply_values"} \
        == {op: n for op, n in calls[False].items() if op != "apply_values"}


@pytest.mark.parametrize("wl_name,cc", [("tpcc", "occ"), ("ycsb", "mvcc"),
                                        ("ycsb", "autogran")])
def test_a_tracked_wave_never_waits_on_the_host(monkeypatch, wl_name, cc):
    """Outside the backend ops (apply_values among them) a tracked wave
    reads nothing on the host: the head copy and the ring's copy-forward
    are index ops."""
    wl = make_workload(wl_name, **({"scale": 0.01} if wl_name == "tpcc"
                                   else {"n_keys": 400, "theta": 0.99}))
    cfg = dataclasses.replace(make_config(wl, cc, 1, 16), track_values=True)
    state = pt.engine_state_init(cfg, wl.init_store("cpu", cfg.mv_depth,
                                                    True))
    step = make_wave_step(cfg)
    gen = torch.Generator()
    gen.manual_seed(3)
    r = arrival_rate(cfg, "cpu")
    for _ in range(2):
        state, _ = draw_wave(cfg, wl, state, step, gen, r)
    with guarded(monkeypatch) as g:
        real = kb.Backend.apply_values

        def let_through(*a, **kw):
            g.paused += 1
            try:
                return real(*a, **kw)
            finally:
                g.paused -= 1
        monkeypatch.setattr(kb.Backend, "apply_values",
                            staticmethod(let_through))
        state, _ = draw_wave(cfg, wl, state, step, gen, r)
    assert int(state.wave) == 3 and float(state.store.values.abs().sum()) > 0
