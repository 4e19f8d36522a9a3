"""Shared helpers of the repro_torch parity tests (not a test module).

The JAX engine draws every wave's batch and lane permutation inside its
scan (``repro/core/engine.py`` make_wave_step); torch cannot reproduce
``jax.random``.  ``jax_draws`` replays those draws outside the engine,
exactly as the scan makes them, and ``port_replay`` feeds them into the
port's wave step on a store carried across from the JAX store.  The open
loop's scan splits its key four ways and adds a Poisson arrival count:
``jax_open_draws`` replays that, and ``port_open_replay`` feeds it into
the port's open-loop step.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.core import types as jt
from repro.core.engine import run as jax_run
from repro_torch.core import convert
from repro_torch.core import engine as pe


def jax_config(wl, cc: int, gran: int, lanes: int,
               fuse_wave: bool = True, **kw) -> jt.EngineConfig:
    """The JAX config of a run: the workload's max_extent, a ring of depth
    4 for the multi-version mechanisms, and ``kw`` (snapshot_age, ...)."""
    kw.setdefault("mv_depth", 4 if cc in jt.MV_CCS else 0)
    return jt.EngineConfig(
        cc=cc, lanes=lanes, slots=wl.slots, n_records=wl.n_records,
        n_groups=wl.n_groups, n_cols=wl.n_cols, n_txn_types=wl.n_txn_types,
        granularity=gran, n_rings=wl.n_rings, fuse_wave=fuse_wave,
        max_extent=wl.max_extent, **kw)


_GENS = {}


def _jit_gen(wl):
    """The workload's generator, jitted once per workload object."""
    if id(wl) not in _GENS:
        _GENS[id(wl)] = (wl, jax.jit(wl.gen, static_argnums=(2,)))
    return _GENS[id(wl)][1]


def jax_draws(wl, lanes: int, n_waves: int, seed: int = 0) -> list:
    """[(fresh batch fields, ring tails, perm)] per wave, as numpy: the
    split -> gen -> permutation chain of the JAX wave step, replayed."""
    gen = _jit_gen(wl)
    rng = jax.random.PRNGKey(seed)
    tails = jnp.zeros((wl.n_rings,), jnp.int32)
    out = []
    for w in range(n_waves):
        rng, rng_gen, rng_perm = jax.random.split(rng, 3)
        fresh, tails = gen(rng_gen, jnp.uint32(w), lanes, tails)
        perm = jax.random.permutation(rng_perm, lanes).astype(jnp.uint32)
        fields = {f.name: np.asarray(getattr(fresh, f.name))
                  for f in dataclasses.fields(fresh)}
        out.append((fields, np.asarray(tails), np.asarray(perm)))
    return out


#: Store fields compared bit for bit (the version ring included), and the
#: float heats compared to rtol 1e-6 (``decay ** dt`` is a float32 pow,
#: which CPU libraries may round an ulp apart).
EXACT_TABLES = ("wts", "rts", "claim_w", "claim_r", "ring_tails",
                "pess_mode", "fine_mode", "heat_wave", "mv_begin", "mv_head")
HEAT_TABLES = ("abort_heat", "false_heat")


def store_arrays(store) -> dict:
    return {k: np.asarray(getattr(store, k))
            for k in EXACT_TABLES + HEAT_TABLES}


class ReplayedWorkload:
    """The JAX workload ``wl`` whose ``gen`` returns recorded draws
    (``jax_draws`` or ``jax_open_draws`` of ``wl``) by wave index: JAX
    ``run`` on it makes the same waves as on ``wl`` with the same seed,
    without compiling the generator into its scan."""

    def __init__(self, wl, draws: list):
        self._wl = wl
        self._fields = {k: jnp.asarray(np.stack([d[0][k] for d in draws]))
                        for k in draws[0][0]}
        self._tails = jnp.asarray(np.stack([d[1] for d in draws]))

    def __getattr__(self, name):
        return getattr(self._wl, name)

    def gen(self, rng, wave, lanes: int, ring_tails):
        fresh = jt.TxnBatch(**{k: v[wave] for k, v in self._fields.items()})
        return fresh, self._tails[wave]


def jax_open_draws(wl, lanes: int, n_waves: int, rate: float,
                   seed: int = 0) -> list:
    """[(fresh batch fields, ring tails, perm, offered)] per wave, as
    numpy: the four-way split -> gen -> permutation -> Poisson chain of
    the JAX open-loop wave step, replayed."""
    from repro.workloads.arrivals import poisson_offered
    gen = _jit_gen(wl)
    rng = jax.random.PRNGKey(seed)
    tails = jnp.zeros((wl.n_rings,), jnp.int32)
    out = []
    for w in range(n_waves):
        rng, rng_gen, rng_perm, rng_arr = jax.random.split(rng, 4)
        fresh, tails = gen(rng_gen, jnp.uint32(w), lanes, tails)
        perm = jax.random.permutation(rng_perm, lanes).astype(jnp.uint32)
        offered = poisson_offered(rng_arr, rate, lanes)
        fields = {f.name: np.asarray(getattr(fresh, f.name))
                  for f in dataclasses.fields(fresh)}
        out.append((fields, np.asarray(tails), np.asarray(perm),
                    int(offered)))
    return out


def port_open_replay(cfg, store0: dict, draws: list, device="cpu",
                     active=None, timeline=None):
    """Run the port's open-loop step over ``jax_open_draws`` from the store
    ``store0``; returns the final EngineState.  ``active`` masks padding
    lanes as the sweep runner does; ``timeline`` (an ``engine.Timeline``
    of ``len(draws)`` waves from wave 0) records every wave's row."""
    from repro_torch.core.types import engine_state_init
    state = engine_state_init(cfg, convert.store_from_numpy(store0, device))
    step = pe.make_open_wave_step(cfg, active)
    for fresh, tails, perm, offered in draws:
        wave = state.wave
        state, row = step(state, convert.batch_from_numpy(fresh, device),
                          torch.from_numpy(tails.astype(np.int32)).to(device),
                          torch.from_numpy(perm.astype(np.int64)).to(device),
                          offered)
        if timeline is not None:
            timeline.record(wave, row)
    return state


def port_replay(cfg, store0: dict, draws: list, device="cpu", active=None,
                timeline=None):
    """Run the port's wave step over ``draws`` from the store ``store0``
    ({field: numpy array}); returns the final EngineState.  ``active``
    (bool[T] or None) masks padding lanes as the sweep runner does;
    ``timeline`` (an ``engine.Timeline`` of ``len(draws)`` waves from
    wave 0) records every wave's row."""
    from repro_torch.core.types import engine_state_init
    state = engine_state_init(cfg, convert.store_from_numpy(store0, device))
    step = pe.make_wave_step(cfg, active)
    for fresh, tails, perm in draws:
        wave = state.wave
        state, row = step(state, convert.batch_from_numpy(fresh, device),
                          torch.from_numpy(tails.astype(np.int32)).to(device),
                          torch.from_numpy(perm.astype(np.int64)).to(device))
        if timeline is not None:
            timeline.record(wave, row)
    return state


def initial_store(wl, jcfg) -> dict:
    """The JAX workload's fresh store, with the config's ring, as numpy."""
    return store_arrays(wl.init_store(False, mv_depth=jcfg.mv_depth))


def assert_engine_parity(wl, cc: int, gran: int, lanes: int, draws: list,
                         seed: int = 0, fuse_wave: bool = True, **kw):
    """The port's replay of the JAX draws equals JAX ``run``: integer state,
    version ring, mode bits and counters bit-identical, heats to rtol
    1e-6, lane_time and throughput to rtol 1e-5 (float32 sums reduced in
    another order).  ``kw`` goes to the config.  Returns the port's final
    EngineState."""
    jcfg = jax_config(wl, cc, gran, lanes, fuse_wave, **kw)
    n_waves = len(draws)
    ref = jax_run(jcfg, wl, n_waves=n_waves, seed=seed, keep_state=True)
    js = ref.final_state
    cfg = convert.config_from_fields(dataclasses.asdict(jcfg))
    state = port_replay(cfg, initial_store(wl, jcfg), draws)
    res = pe.summarize(cfg, state, n_waves)

    assert res.commits == ref.commits
    assert res.aborts == ref.aborts
    assert (res.ro_commits, res.ro_aborts) == (ref.ro_commits, ref.ro_aborts)
    assert res.abort_causes == ref.abort_causes
    assert res.commits_by_type == ref.commits_by_type
    assert res.ext_events == ref.ext_events
    assert sum(res.abort_causes) == res.aborts
    got = convert.store_to_numpy(state.store)
    for k in EXACT_TABLES:
        np.testing.assert_array_equal(got[k], np.asarray(getattr(js.store, k)),
                                      err_msg=k)
    for k in HEAT_TABLES:
        np.testing.assert_allclose(got[k], np.asarray(getattr(js.store, k)),
                                   rtol=1e-6, err_msg=k)
    np.testing.assert_array_equal(state.age.numpy(), np.asarray(js.age))
    np.testing.assert_array_equal(state.pending_live.numpy(),
                                  np.asarray(js.pending_live))
    np.testing.assert_allclose(state.lane_time.numpy(),
                               np.asarray(js.lane_time), rtol=1e-5)
    np.testing.assert_allclose(res.throughput, ref.throughput, rtol=1e-5)
    return state


def assert_routes_identical(wl, cc: int, draws: list) -> None:
    """The port's fused route (wave_commit) and unfused route (claim_probe
    + verdict + commit_install) end in bit-identical state on the same
    draws (coarse)."""
    states = []
    for fuse in (True, False):
        jcfg = jax_config(wl, cc, 0, len(draws[0][2]), fuse)
        cfg = convert.config_from_fields(dataclasses.asdict(jcfg))
        states.append(port_replay(cfg, initial_store(wl, jcfg), draws))
    a, b = states
    for f in ("commits", "aborts", "abort_causes", "commits_by_type",
              "ext_events", "age", "pending_live", "lane_time"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    for f in convert.store_to_numpy(a.store):
        assert torch.equal(getattr(a.store, f), getattr(b.store, f)), f
