"""The wave index on the device, held against the JAX package.

``EngineState.wave`` is a 0-d int64 tensor on the run's device: the step
advances it there and every wave kernel reads it (and the timestamps
derived from it) from device memory, so a wave never waits on the host.
Here, on the CPU:

- ``inv_wave``, ``hash01``, ``snapshot_ts`` (with ages past the wave) and
  ``install_ts`` equal the JAX functions at waves 0, 9, 65,535, 65,536
  and 2**32 - 1, given the wave as a tensor and as an int;
- ``touch_heat`` and the fixed-shape scatters of Adaptive's mode flip and
  AutoGran's promotion (``claims.sink_scatter``: masked ops write the
  tables' sink slot) equal the reference's drop-mode scatters on the same
  numpy inputs: duplicate keys with mixed masks, keys -1 and past the end,
  all-masked and all-live waves.  A live op never carries key -1 (the
  reference's scatter would wrap it to the last record; the port drops
  it), so the reference gets those ops masked, as tests/test_torch_claims
  does;
- every wave kernel's plain version, reached through its wrapper on CPU
  tensors, gives the same outputs and tables on a tensor wave as on the
  int wave;
- one wave of every mechanism (fused, unfused, with scans, open), draws
  included, runs under a dispatch mode that raises on a host read of a
  tensor (``aten._local_scalar_dense``), ``aten.nonzero`` and boolean-mask
  indexing; the backend ops are left out, since on the card their kernels
  run instead.  ``chip_smoke.sync_free_path`` checks the same waves on the
  card under ``torch.cuda.set_sync_debug_mode("error")`` and the profiler.

All comparisons are bit-identical but the heats' (rtol 1e-6, a float32
pow, as in tests/test_torch_claims.py).
"""
import contextlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import chip_smoke
from repro.core import claims as jcl
from repro.core import claimword as jcw
from repro.core import mvstore as jmv
from repro.core import types as jt
from repro_torch import kernels as K
from repro_torch.core import backend as kb
from repro_torch.core import claims as cl
from repro_torch.core import claimword as cw
from repro_torch.core import mvstore as mv
from repro_torch.core import types as pt
from repro_torch.core.engine import (arrival_rate, draw_wave,
                                     make_open_wave_step, make_wave_step)
from repro_torch.launch.txn_bench import make_config, make_workload

WAVES = (0, 9, 65_535, 65_536, 2 ** 32 - 1)
AGES = (0, 1, 8, 70_000)


def _forms(wave):
    """The wave as the run keeps it (a 0-d int64 tensor) and as an int."""
    return {"tensor": torch.tensor(wave, dtype=torch.int64), "int": wave}


def _value(x) -> int:
    if isinstance(x, torch.Tensor):
        assert x.dim() == 0 and x.dtype == torch.int64
        return int(x)
    return x


# ------------------------------------------------------------ wave stamps
@pytest.mark.parametrize("wave", WAVES)
def test_wave_stamps_match_jax(wave):
    ju = jnp.uint32(wave)
    ids = cl.lane_op_ids(8, 16)
    want_hash = np.asarray(jcl.hash01(ju, jcl.lane_op_ids(8, 16)))
    for form, w in _forms(wave).items():
        assert _value(cw.inv_wave(w)) == int(jcw.inv_wave(ju)), form
        np.testing.assert_array_equal(cl.hash01(w, ids).numpy(), want_hash,
                                      err_msg=form)
        assert _value(mv.install_ts(w)) == int(jmv.install_ts(ju)), form
        for age in AGES:
            assert (_value(mv.snapshot_ts(w, age))
                    == int(jmv.snapshot_ts(ju, age))), (form, age)


def test_a_run_keeps_its_wave_on_its_device():
    wl = make_workload("ycsb", n_keys=500)
    cfg = make_config(wl, "occ", 1, 8)
    state = pt.engine_state_init(cfg, wl.init_store("cpu"))
    assert state.wave.dim() == 0 and state.wave.dtype == torch.int64
    gen = torch.Generator()
    gen.manual_seed(0)
    state, _ = draw_wave(cfg, wl, state, make_wave_step(cfg), gen)
    assert state.wave.device == state.lane_time.device
    assert int(state.wave) == 1
    for k in pt.SINK_TABLES:
        assert getattr(state.store, k).shape == (cfg.n_records + pt.SINK,)


# ------------------------------------------------ heats and mode scatters
N = 40


def _heat_case(case: str, seed: int = 23):
    """Heats, heat waves and a wave of ops over N records: duplicate keys
    (one hot record), keys -1 and past the end, and a mask that is mixed,
    all False or all True."""
    rng = np.random.default_rng(seed)
    heat = (rng.random(N) * 3).astype(np.float32)
    heat_wave = rng.integers(0, 40, N).astype(np.int32)
    keys = rng.integers(0, N, (8, 12))
    keys[0, :5] = 7                                       # hot duplicates
    keys[1, 2:9:2] = 7
    keys[rng.random(keys.shape) < 0.1] = -1
    keys[rng.random(keys.shape) < 0.05] = N + 3           # past the end
    mask = {"mixed": rng.random(keys.shape) < 0.5,
            "all_masked": np.zeros(keys.shape, bool),
            "all_live": np.ones(keys.shape, bool)}[case]
    if case == "mixed":
        mask[0, :5] = [True, False, True, False, True]    # one key, both
    return heat, heat_wave, keys.astype(np.int32), mask


def _sink(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.append(a, np.zeros(pt.SINK, a.dtype)))


def _drop_set(table, keys, values, mask):
    """The reference's scatter: ``table.at[where(mask, keys,
    OOB_KEY)].set(values, mode="drop")`` (src/repro/core/cc/adaptive.py,
    src/repro/core/cc/autogran.py), with -1 keys masked (see above)."""
    k = jnp.where(jnp.asarray(mask & (keys >= 0)), jnp.asarray(keys),
                  jt.OOB_KEY).reshape(-1)
    return np.asarray(jnp.asarray(table).at[k].set(
        jnp.asarray(values).reshape(-1), mode="drop"))


@pytest.mark.parametrize("case", ["mixed", "all_masked", "all_live"])
@pytest.mark.parametrize("form", ["tensor", "int"])
def test_touch_heat_matches_jax(case, form):
    heat, heat_wave, keys, mask = _heat_case(case)
    add = np.ones(keys.shape, np.float32)
    want_h, want_w = jcl.touch_heat(
        jnp.asarray(heat), jnp.asarray(heat_wave), jnp.asarray(keys),
        jnp.asarray(add), jnp.uint32(41), 0.95,
        jnp.asarray(mask & (keys >= 0)))
    th, tw = _sink(heat), _sink(heat_wave)
    cl.touch_heat(th, tw, torch.from_numpy(keys), torch.from_numpy(add),
                  _forms(41)[form], 0.95, torch.from_numpy(mask))
    assert th[-1] == 0 and tw[-1] == 0
    np.testing.assert_allclose(th[:-1].numpy(), np.asarray(want_h),
                               rtol=1e-6)
    np.testing.assert_array_equal(tw[:-1].numpy(), np.asarray(want_w))
    got_cur = cl.lazy_decayed(th, tw, torch.from_numpy(keys),
                              _forms(41)[form], 0.95)
    want_cur = jcl.lazy_decayed(want_h, want_w, jnp.asarray(keys),
                                jnp.uint32(41), 0.95)
    np.testing.assert_allclose(got_cur.numpy(), np.asarray(want_cur),
                               rtol=1e-6)


@pytest.mark.parametrize("case", ["mixed", "all_masked", "all_live"])
def test_adaptive_mode_flip_matches_jax(case):
    """pess_mode.at[k].set(new_mode) at the accessed ops: the new mode
    depends on the key only, so duplicates agree, and a masked duplicate
    of a flipped key must not write the old mode back."""
    rng = np.random.default_rng(5)
    _, _, keys, acc = _heat_case(case)
    old = rng.random(N) < 0.5
    new_of_key = rng.random(N + 4) < 0.5
    new_mode = new_of_key[np.clip(keys, 0, N + 3)]
    got = _sink(old)
    cl.sink_scatter(got, torch.from_numpy(keys), torch.from_numpy(new_mode),
                    torch.from_numpy(acc))
    assert not got[-1]
    np.testing.assert_array_equal(got[:-1].numpy(),
                                  _drop_set(old, keys, new_mode, acc))
    if case == "mixed":
        hot = keys == 7
        assert (acc & hot).any() and (~acc & hot).any()


@pytest.mark.parametrize("case", ["mixed", "all_masked", "all_live"])
def test_autogran_promotion_matches_jax(case):
    """fine_mode.at[k].set(True) at the promoted ops."""
    rng = np.random.default_rng(6)
    _, _, keys, promote = _heat_case(case)
    old = rng.random(N) < 0.2
    got = _sink(old)
    p = torch.from_numpy(promote)
    cl.sink_scatter(got, torch.from_numpy(keys), p, p)
    assert not got[-1]
    np.testing.assert_array_equal(
        got[:-1].numpy(), _drop_set(old, keys, np.ones_like(promote),
                                    promote))


# ------------------------------------- plain versions: tensor = int wave
KW = dict(N=997, G=2, T=16, K=64)
PLAIN_WAVES = (9, chip_smoke.HIGH_WAVE, 65_536, 2 ** 32 - 1)


def _clone(x):
    return x.clone() if isinstance(x, torch.Tensor) else x


def _flat(out) -> list:
    if out is None:
        return []
    if isinstance(out, (tuple, list)):
        return [t for o in out for t in _flat(o)]
    return [out]


def _plain_calls(wave, seed):
    """name -> (wrapper, args, kwargs): every wave kernel's forms on one
    wave's tables and ops."""
    N, G, T, Kk = KW["N"], KW["G"], KW["T"], KW["K"]
    dev = torch.device("cpu")
    cw0, cr0, wts0, _ = chip_smoke.make_tables(N, G, wave, dev, seed)
    keys, groups, prio, masks, _ = chip_smoke.make_ops(N, G, T, Kk, dev,
                                                       seed)
    do_w, do_r, check_w, check_w2, check_r, extra = masks
    lane = prio[:, 0].contiguous()
    ext = chip_smoke.scan_extents(keys, N, 9, seed)[1]
    g = torch.Generator()
    g.manual_seed(seed)
    begin = torch.randint(0, 64, (N, 4, G), generator=g, dtype=torch.int32)
    begin[keys[0, 0].clamp(min=0), 2:] = -1               # empty slots
    head = torch.randint(0, 4, (N,), generator=g, dtype=torch.int32)
    words = torch.zeros((T, -(-Kk // 16)), dtype=torch.int32)
    snap = mv.snapshot_ts(wave, 3)
    stamp = mv.install_ts(wave) | (1 << 20)   # above every begin stamp
    return {
        "wave_commit": (K.wave_commit, (cw0, cr0, wts0, keys, groups, prio,
                                        do_w, do_r, check_w, check_w2,
                                        check_r, extra, wave, True, True,
                                        True), {}),
        "wave_commit_pack": (K.wave_commit, (cw0, None, None, keys, groups,
                                             prio, do_w, None, check_w,
                                             None, None, None, wave, False,
                                             False, False),
                             dict(pack=True)),
        "claim_probe": (K.claim_probe, (cw0, keys, groups, prio, wave, do_w,
                                        False), {}),
        "claim_probe_two": (K.claim_probe, (cw0, keys, groups, prio, wave,
                                            do_w, True),
                            dict(claim_r=cr0, mask_r=do_r)),
        "claim_probe_verdict_ring": (
            K.claim_probe, (cw0, keys, groups, prio, wave, do_w, True),
            dict(claim_r=cr0, mask_r=do_r, begin=begin, snap_ts=snap,
                 is_r=check_r, is_rp=check_w)),
        "probe": (K.probe, (cw0, keys, groups, wave, False), {}),
        "claim_scatter": (K.claim_scatter, (cw0, keys, groups, prio, wave,
                                            do_w), {}),
        "validate": (K.validate, (cw0, keys, groups, prio, check_w, wave,
                                  True), {}),
        "validate_install_ring": (
            K.validate, (cw0, keys, groups, lane, check_w, wave, False),
            dict(claim_r=cr0, check_r=check_r, install_w=do_w,
                 install_r=do_r, begin=begin, snap_ts=snap)),
        "validate_dual": (K.validate_dual, (cw0, keys, groups, prio,
                                            check_w, wave), {}),
        "validate_dual_install": (K.validate_dual, (cw0, keys, groups, lane,
                                                    check_w, wave),
                                  dict(install=do_w)),
        "iterate_validate": (K.iterate_validate, (cw0, keys, ext, groups,
                                                  prio, check_r, wave, False,
                                                  8, 9), {}),
        "iterate_validate_words": (K.iterate_validate, (
            cw0, keys, ext, groups, prio, check_r, wave, True, 8, 9),
            dict(words=words, bit=1)),
        "iterate_validate_bump": (K.iterate_validate, (
            cw0, keys, ext, groups, prio, check_r, wave, False, 8, 9),
            dict(point=extra, wts=wts0, do=do_w)),
        "mv_gather": (K.mv_gather, (begin, keys, groups, snap, False), {}),
        "mv_install": (K.mv_install, (begin, head, keys, groups, do_w,
                                      stamp), {}),
    }


@pytest.mark.parametrize("wave", PLAIN_WAVES)
def test_plain_versions_take_the_device_wave(wave):
    ints = _plain_calls(wave, seed=wave % 97)
    tensors = _plain_calls(torch.tensor(wave, dtype=torch.int64),
                           seed=wave % 97)
    for name, (fn, args, kw) in ints.items():
        _, t_args, t_kw = tensors[name]
        a = [_clone(x) for x in args]
        b = [_clone(x) for x in t_args]
        ka = {k: _clone(v) for k, v in kw.items()}
        kb_ = {k: _clone(v) for k, v in t_kw.items()}
        got_a, got_b = fn(*a, **ka), fn(*b, **kb_)
        # The outputs, then every table and op tensor (the ones updated in
        # place among them); not the 0-d wave and stamps.
        outs_a = _flat(got_a) + [x for x in a + list(ka.values())
                                 if isinstance(x, torch.Tensor) and x.dim()]
        outs_b = _flat(got_b) + [x for x in b + list(kb_.values())
                                 if isinstance(x, torch.Tensor) and x.dim()]
        assert len(outs_a) == len(outs_b), name
        for x, y in zip(outs_a, outs_b):
            assert torch.equal(x, y), name


# ------------------------------------------------ no host wait in a wave
class HostWaitGuard(TorchDispatchMode):
    """Raises on an op that makes the host wait for the device on a card:
    a host read of a tensor, ``nonzero`` and boolean-mask indexing (its
    hidden ``nonzero``).  ``paused`` lets the backend ops through."""
    SYNCS = {torch.ops.aten._local_scalar_dense.default,
             torch.ops.aten.nonzero.default,
             torch.ops.aten.nonzero_static.default,
             torch.ops.aten.masked_select.default}
    INDEX = {torch.ops.aten.index.Tensor, torch.ops.aten.index_put.default,
             torch.ops.aten.index_put_.default,
             torch.ops.aten._index_put_impl_.default}

    def __init__(self):
        super().__init__()
        self.paused = 0
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if not self.paused:
            if func in self.SYNCS:
                raise AssertionError(f"host wait: {func}")
            if func in self.INDEX and any(
                    isinstance(i, torch.Tensor) and i.dtype == torch.bool
                    for i in (args[1] or ())):
                raise AssertionError(f"boolean-mask index: {func}")
            self.seen.append(func)
        return func(*args, **(kwargs or {}))


@contextlib.contextmanager
def guarded(monkeypatch):
    """The guard, with every backend op of ``core/backend.py`` let
    through (on the card each is one kernel launch)."""
    guard = HostWaitGuard()

    def let_through(fn):
        def op(*a, **kw):
            guard.paused += 1
            try:
                return fn(*a, **kw)
            finally:
                guard.paused -= 1
        return staticmethod(op)
    for name in kb.SURFACE_OPS:
        monkeypatch.setattr(kb.Backend, name,
                            let_through(getattr(kb.Backend, name)))
    with guard:
        yield guard


def test_the_guard_catches_host_waits(monkeypatch):
    x = torch.arange(6)
    for bad in (lambda: int(x.sum()), lambda: x[x > 2],
                lambda: x.nonzero(), lambda: bool(x.any())):
        with pytest.raises(AssertionError):
            with guarded(monkeypatch):
                bad()
    with guarded(monkeypatch) as g:
        x[torch.tensor([1, 2])] = 0
        kb.BACKEND.segment_count(x.view(2, 3).int(), x.view(2, 3).int() * 0,
                                 1, x.view(2, 3) > 0)
    assert torch.ops.aten.index_put_.default in g.seen


_WL = {"tpcc": dict(scale=0.01), "tpcc_scans": dict(scale=0.01,
                                                    scan_len=16),
       "ycsb": dict(n_keys=400, theta=0.99),
       "ycsb_e": dict(n_keys=400, theta=0.99, scan_frac=0.9, scan_len=8)}
GUARD_CONFIGS = (
    [(w, cc, 1, True, 0.0) for w in ("tpcc", "ycsb")
     for cc in ("occ", "tictoc", "2pl", "swisstm", "adaptive", "autogran",
                "mvcc", "mvocc")]
    + [("tpcc_scans", cc, 0, True, 0.0)
       for cc in ("occ", "autogran", "mvcc", "mvocc", "adaptive")]
    + [("ycsb_e", "occ", 1, True, 0.0)]
    + [("tpcc", cc, 0, False, 0.0) for cc in ("occ", "2pl", "adaptive")]
    + [("ycsb", cc, 1, True, 12.0) for cc in ("occ", "mvcc")])


@pytest.mark.parametrize(
    "wl_name,cc,gran,fuse,rate", GUARD_CONFIGS,
    ids=[f"{w}-{cc}-{'fused' if f else 'unfused'}"
         + ("-open" if r else "") for w, cc, _, f, r in GUARD_CONFIGS])
def test_a_wave_never_waits_on_the_host(monkeypatch, wl_name, cc, gran,
                                        fuse, rate):
    """Two waves unguarded (heats, modes and claims warm), then one whole
    wave of ``run_waves`` (its draws and its step) under the guard."""
    wl = make_workload(wl_name.split("_")[0], **_WL[wl_name])
    cfg = make_config(wl, cc, gran, 16, fuse, arrival_rate=rate)
    state = pt.engine_state_init(cfg, wl.init_store("cpu", cfg.mv_depth))
    step = (make_open_wave_step if cfg.open_loop else make_wave_step)(cfg)
    gen = torch.Generator()
    gen.manual_seed(3)
    r = arrival_rate(cfg, "cpu")
    for _ in range(2):
        state, _ = draw_wave(cfg, wl, state, step, gen, r)
    K.reset_launches()
    with guarded(monkeypatch):
        state, _ = draw_wave(cfg, wl, state, step, gen, r)
    assert int(state.wave) == 3
    assert sum(K.call_counts().values()) > 0
