"""The serial replay's order and index corners against the JAX package,
every float compared as its float32 bits, the ops called directly.

``apply_values_plain`` (kernels/apply_values.py) and the backend op on
the CPU against JAX ``engine.apply_values``, flat and into the version
ring, and the ring form with ``head_old`` (the copy-forward, then the
replay) against JAX ``mvstore.install_values``, on waves that reach
every corner of the reference's semantics:

- lanes in ascending *signed* int32 priority, stably: negative
  priorities, the int32 extremes and ties;
- columns from -C-1 to C: a column in [-C, 0) counts from the end once,
  -C-1 and C drop the op;
- ring slots (the new and the old heads) from -D-1 to D, wrapped the
  same way; a source slot outside the ring copies zeros, a target slot
  outside it copies nothing;
- keys -1 and N, uncommitted lanes, READs and NOPs.

Three small cases pin one corner each: the lane order of signed
priorities, a negative column, a negative ring slot.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from port_harness import f32_bits
from repro.core import engine as jengine
from repro.core import mvstore as jmv
from repro.core import types as jt
from repro_torch.core import backend as kb
from repro_torch.core import convert
from repro_torch.core import mvstore as pmv
from repro_torch.kernels.apply_values import (BLOCK_MAX_LANES,
                                              BLOCK_MAX_OPS,
                                              apply_values_plain, route)

N, D, C, T, K = 13, 3, 4, 7, 6


def _wave(seed):
    """One wave of ops over every corner, as numpy."""
    rng = np.random.default_rng(seed)
    hot = rng.integers(0, N, 3)
    key = rng.integers(0, N, (T, K))
    pick = rng.random((T, K))
    key = np.where(pick < 0.45, hot[rng.integers(0, 3, (T, K))], key)
    key = np.where(pick > 0.93, -1, key)
    key = np.where((pick > 0.87) & (pick <= 0.93), N, key)
    col = rng.integers(-C - 1, C + 1, (T, K))
    kind = rng.choice([jt.NOP, jt.READ, jt.WRITE, jt.ADD], (T, K),
                      p=[0.1, 0.15, 0.3, 0.45])
    val = (rng.standard_normal((T, K)) * 3.7).astype(np.float32)
    commit = rng.random(T) < 0.8
    commit[:2] = True
    prio = rng.integers(-3, 3, T).astype(np.int32)     # negatives, ties
    prio[rng.integers(0, T)] = np.iinfo(np.int32).min
    prio[rng.integers(0, T)] = np.iinfo(np.int32).max
    return dict(
        key=key.astype(np.int32), col=col.astype(np.int32),
        kind=kind.astype(np.int32), val=val, commit=commit, prio=prio,
        values=(rng.standard_normal((N, C)) * 0.3).astype(np.float32),
        ring=(rng.standard_normal((N, D, C)) * 0.3).astype(np.float32),
        head_new=rng.integers(-D - 1, D + 1, N).astype(np.int32),
        head_old=rng.integers(-D - 1, D + 1, N).astype(np.int32))


def _batches(w):
    fields = dict(op_key=w["key"], op_group=np.zeros_like(w["key"]),
                  op_col=w["col"], op_kind=w["kind"], op_val=w["val"],
                  txn_type=np.zeros(len(w["key"]), np.int32),
                  n_ops=np.full(len(w["key"]), w["key"].shape[1], np.int32))
    return (convert.batch_from_numpy(fields, "cpu"),
            jt.TxnBatch(**{k: jnp.asarray(v) for k, v in fields.items()}))


def _jax_replay(w, vals, slot_of=None):
    _, jb = _batches(w)
    return np.asarray(jengine.apply_values(
        jnp.asarray(vals), jb, jnp.asarray(w["commit"]),
        jnp.asarray(w["prio"]),
        None if slot_of is None else jnp.asarray(slot_of)))


def _port(fn, w, vals, **kw):
    pb, _ = _batches(w)
    out = torch.from_numpy(vals.copy())
    kw = {k: torch.from_numpy(v) for k, v in kw.items()}
    fn(out, pb, torch.from_numpy(w["commit"]), torch.from_numpy(w["prio"]),
       **kw)
    return out.numpy()


@pytest.mark.parametrize("fn", [apply_values_plain,
                                kb.BACKEND.apply_values],
                         ids=["plain", "backend"])
@pytest.mark.parametrize("ring", [False, True], ids=["flat", "ring"])
@pytest.mark.parametrize("seed", range(4))
def test_replay_matches_jax_on_every_corner(seed, ring, fn):
    w = _wave(seed)
    vals = w["ring"] if ring else w["values"]
    slot = {"slot_of": w["head_new"]} if ring else {}
    want = _jax_replay(w, vals, slot.get("slot_of"))
    got = _port(fn, w, vals, **slot)
    np.testing.assert_array_equal(f32_bits(got), f32_bits(want))
    assert not np.array_equal(f32_bits(got), f32_bits(vals))


def test_the_waves_reach_the_corners():
    """Over the seeds: committed writes of in-table keys whose column, and
    whose ring slot, lies in [-C, 0) and [-D, 0), and ties of priority
    among negative ones."""
    neg_col = neg_slot = tie = 0
    for seed in range(4):
        w = _wave(seed)
        live = (w["commit"][:, None] & (w["key"] >= 0) & (w["key"] < N)
                & np.isin(w["kind"], (jt.WRITE, jt.ADD)))
        neg_col += int((live & (w["col"] < 0) & (w["col"] >= -C)).sum())
        hn = w["head_new"][np.clip(w["key"], 0, N - 1)]
        neg_slot += int((live & (hn < 0) & (hn >= -D)).sum())
        p = w["prio"][w["prio"] < 0]
        tie += len(p) - len(np.unique(p))
    assert neg_col > 0 and neg_slot > 0 and tie > 0


@pytest.mark.parametrize("fn", ["plain", "mvstore"])
@pytest.mark.parametrize("seed", range(4))
def test_copy_forward_and_replay_match_jax_install_values(seed, fn):
    """The ring form with head_old (copy-forward, then the replay) against
    JAX ``mvstore.install_values``, heads from -D-1 to D."""
    w = _wave(seed)
    _, jb = _batches(w)
    want = np.asarray(jmv.install_values(
        jnp.asarray(w["ring"]), jnp.asarray(w["head_old"]),
        jnp.asarray(w["head_new"]), jb, jnp.asarray(w["commit"]),
        jnp.asarray(w["prio"])))
    if fn == "plain":
        got = _port(apply_values_plain, w, w["ring"],
                    slot_of=w["head_new"], head_old=w["head_old"])
    else:
        pb, _ = _batches(w)
        got = torch.from_numpy(w["ring"].copy())
        pmv.install_values(got, torch.from_numpy(w["head_old"]),
                           torch.from_numpy(w["head_new"]), pb,
                           torch.from_numpy(w["commit"]),
                           torch.from_numpy(w["prio"]))
        got = got.numpy()
    np.testing.assert_array_equal(f32_bits(got), f32_bits(want))
    # The copy moved rows the replay did not write: it reaches the case.
    replay_only = _port(apply_values_plain, w, w["ring"],
                        slot_of=w["head_new"])
    assert not np.array_equal(f32_bits(got), f32_bits(replay_only))


def _small(kind, val, prio, col=None, slot=None, n_cols=4, depth=3):
    """Committed lanes of one op each on record 0."""
    n = len(kind)
    w = dict(key=np.zeros((n, 1), np.int32),
             col=np.array(col if col is not None else [0] * n,
                          np.int32)[:, None],
             kind=np.array(kind, np.int32)[:, None],
             val=np.array(val, np.float32)[:, None],
             commit=np.ones(n, bool), prio=np.array(prio, np.int32))
    if slot is None:
        return w, np.zeros((1, n_cols), np.float32), {}
    return (w, np.zeros((1, depth, n_cols), np.float32),
            {"slot_of": np.array([slot], np.int32)})


@pytest.mark.parametrize("case", ["lane_order", "negative_col",
                                  "negative_slot"])
def test_small_corner_cases(case):
    """Lane order: prio 5, -3, 0; lane 0 WRITEs 1.5, lane 1 ADDs 1e8, lane
    2 reads: the reference stores 1.5 (the ADD goes first).  A column of
    -1 with C 4 writes column 3; a ring slot of -1 with D 3 writes slot
    2."""
    if case == "lane_order":
        w, vals, kw = _small([jt.WRITE, jt.ADD, jt.READ], [1.5, 1e8, 7.0],
                             [5, -3, 0])
        where = (0, 0)
    elif case == "negative_col":
        w, vals, kw = _small([jt.WRITE], [2.5], [0], col=[-1])
        where = (0, 3)
    else:
        w, vals, kw = _small([jt.ADD], [2.5], [0], col=[1], slot=-1)
        where = (0, 2, 1)
    want = _jax_replay(w, vals, kw.get("slot_of"))
    got = _port(apply_values_plain, w, vals, **kw)
    np.testing.assert_array_equal(f32_bits(got), f32_bits(want))
    expect = np.zeros_like(vals)
    expect[where] = 1.5 if case == "lane_order" else 2.5
    np.testing.assert_array_equal(f32_bits(got), f32_bits(expect))


def test_route_names_the_form_past_the_one_launch_limit():
    assert route(128, 64) == route(128, 16) == route(3, 1030) == "block"
    assert route(1, BLOCK_MAX_OPS) == "block"
    assert route(1, BLOCK_MAX_OPS + 1) == "grid"
    assert route(BLOCK_MAX_LANES + 1, 1) == "grid"
    assert route(512, 64) == "grid"


def test_head_old_needs_the_ring():
    w, vals, _ = _small([jt.WRITE], [1.0], [0])
    with pytest.raises(ValueError, match="head_old needs slot_of"):
        _port(apply_values_plain, w, vals, head_old=np.zeros(1, np.int32))
