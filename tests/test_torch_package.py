"""Package rules of the port: imports, devices, dispatch, slice limits.

- no repro_torch module, nor chip_smoke.py, loads jax or the JAX package;
- entry points default to CUDA and raise without it;
- kernel wrappers take the plain version only for CPU tensors and count
  only kernel launches; ``kernel_coverage`` tells kernels, plain versions
  and ops that did not run apart;
- settings outside the slices raise NotImplementedError, and the ones
  the slices retired (scans, the version ring, MVCC/MV-OCC) build;
- the benchmark CLI runs on the CPU and writes the JSON row schema.
"""
import dataclasses
import json
import os
import pkgutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import repro_torch
from repro.core import backend as jbackend
from repro.core import types as jt
from repro_torch import kernels as K
from repro_torch.core import backend as pb
from repro_torch.core import types as pt
from repro_torch.core.cc import VALIDATORS
from repro_torch.core.engine import make_wave_step, run, run_waves
from repro_torch.kernels import build
from repro_torch.launch import txn_bench
from repro_torch.workloads import YCSBWorkload

ROOT = os.path.join(os.path.dirname(__file__), "..")


def _modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        repro_torch.__path__, "repro_torch."))


def test_no_module_loads_jax_or_the_jax_package():
    code = (
        "import importlib, sys\n"
        f"for m in {_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith(('jax.', 'jaxlib', 'repro.')) or m == 'repro')\n"
        "print(bad)\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(ROOT, "src"), ROOT]))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert len(_modules()) >= 20


def test_sources_name_no_jax_import():
    paths = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, files in os.walk(repro_torch.__path__[0]):
        paths += [os.path.join(dirpath, f) for f in files
                  if f.endswith(".py")]
    for p in paths:
        for line in open(p):
            s = line.strip()
            assert not s.startswith(("import jax", "from jax",
                                     "import repro.", "from repro.",
                                     "from repro import")), (p, s)


def test_run_defaults_to_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    wl = YCSBWorkload.make(n_keys=500)
    cfg = txn_bench.make_config(wl, "occ", 1, 4)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run(cfg, wl, 1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        wl.init_store()


def test_wrappers_take_plain_versions_on_cpu_and_count_no_launch():
    K.reset_launches()
    wl = YCSBWorkload.make(n_keys=500)
    for cc in ("occ", "tictoc", "autogran"):
        res = run(txn_bench.make_config(wl, cc, 1, 8), wl, 3, device="cpu")
        assert res.commits + res.aborts == 24
        assert res.device == "cpu"
    assert K.launch_counts() == {op: 0 for op in K.WRAPPERS}
    assert K.call_counts()["wave_commit"] == 6
    assert K.call_counts()["validate_dual"] == 3
    assert pb.kernel_coverage(pt.CC_TICTOC, K.launch_counts(),
                              K.call_counts()) == {
        "wave_commit": "torch", "iterate_validate": "not_run",
        "ts_gather": "torch", "ts_install_max": "torch",
        "segment_count": "torch"}
    assert pb.kernel_coverage(pt.CC_OCC, {"wave_commit": 3,
                                          "segment_count": 6},
                              {"wave_commit": 3, "segment_count": 6}) == {
        "wave_commit": "cuda", "iterate_validate": "not_run",
        "commit_install": "not_run", "segment_count": "cuda"}
    K.reset_launches()
    assert K.call_counts() == {op: 0 for op in K.WRAPPERS}


def test_kernel_coverage_tells_cuda_torch_and_not_run_apart():
    """A kernel that launched on every call is "cuda"; an op whose plain
    version ran even once is "torch"; an op never called is "not_run"
    (the unfused bump on the fused route) and never counts as either."""
    launches = {"wave_commit": 0, "commit_install": 5, "segment_count": 9}
    calls = {"wave_commit": 0, "commit_install": 5, "segment_count": 10}
    assert pb.kernel_coverage(pt.CC_2PL, launches, calls) == {
        "wave_commit": "not_run", "iterate_validate": "not_run",
        "commit_install": "cuda", "segment_count": "torch"}
    assert pb.kernel_coverage(pt.CC_AUTOGRAN, {}, {}) == {
        op: "not_run" for op in ("validate_dual", "iterate_validate",
                                 "claim_scatter", "commit_install",
                                 "segment_count")}


@pytest.mark.parametrize("cc", txn_bench.CCS)
def test_run_waves_continues_the_loop_of_run(cc):
    """Two run_waves calls of 2 and 3 waves on one generator end in the
    state that run reaches in 5 waves with the same seed."""
    wl = YCSBWorkload.make(n_keys=500)
    cfg = txn_bench.make_config(wl, cc, 1, 8)
    whole = run(cfg, wl, 5, seed=3, device="cpu", keep_state=True)
    gen = torch.Generator()
    gen.manual_seed(3)
    state = pt.engine_state_init(cfg, wl.init_store("cpu", cfg.mv_depth))
    step = make_wave_step(cfg)
    for n in (2, 3):
        state, wall_s = run_waves(cfg, wl, state, step, gen, n)
        assert wall_s >= 0.0
    want = whole.final_state
    assert state.wave == want.wave == 5
    for name in ("commits", "aborts", "abort_causes", "lane_time"):
        assert torch.equal(getattr(state, name), getattr(want, name)), name
    for name in ("wts", "rts", "claim_w", "claim_r", "ring_tails",
                 "pess_mode", "abort_heat", "fine_mode", "false_heat",
                 "heat_wave", "mv_begin", "mv_head"):
        assert torch.equal(getattr(state.store, name),
                           getattr(want.store, name)), name


def test_wrappers_refuse_devices_without_a_kernel():
    keys = torch.zeros((2, 2), dtype=torch.int32, device="meta")
    mask = torch.zeros((2, 2), dtype=torch.bool, device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        K.segment_count(keys, keys, 2, mask)
    with pytest.raises(ValueError, match="no kernel for device"):
        K.ts_gather(torch.zeros((4, 2), dtype=torch.int32, device="meta"),
                    keys, keys, True)
    table = torch.zeros((4, 2), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        K.commit_install(table, keys, keys, mask)
    with pytest.raises(ValueError, match="no kernel for device"):
        K.claim_probe(table, keys, keys, keys, 3, mask, True)
    with pytest.raises(ValueError, match="no kernel for device"):
        K.probe(table, keys, keys, 3, True)


def test_launch_checks_refuse_what_the_kernels_do_not_take():
    dev = torch.device("cpu")
    ok = torch.zeros((4, 2), dtype=torch.int32)
    build.check("t", ok, torch.int32, (4, 2), dev)
    with pytest.raises(TypeError, match="dtype"):
        build.check("t", ok.to(torch.int64), torch.int32, (4, 2), dev)
    with pytest.raises(ValueError, match="shape"):
        build.check("t", ok, torch.int32, (2, 4), dev)
    with pytest.raises(ValueError, match="contiguous"):
        build.check("t", torch.zeros((2, 4), dtype=torch.int32).t(),
                    torch.int32, (4, 2), dev)
    with pytest.raises(ValueError, match="is on meta"):
        build.check("t", ok.to("meta"), torch.int32, (4, 2), dev)
    with pytest.raises(TypeError, match="expected a tensor"):
        build.check("t", None, torch.int32, (4, 2), dev)
    with pytest.raises(RuntimeError, match="error code 700"):
        build.raise_on_error("wave_commit", 700)
    build.raise_on_error("wave_commit", 0)


def test_cuda_build_raises_without_nvcc(monkeypatch):
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setattr(build.shutil, "which", lambda _: None)
    real_exists = os.path.exists
    monkeypatch.setattr(build.os.path, "exists",
                        lambda p: False if str(p).endswith("nvcc")
                        else real_exists(p))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.nvcc_path()


def test_every_kernel_has_a_cuda_source_and_a_counter():
    for name in build.SOURCES:
        assert (build.CSRC / f"{name}.cu").exists()
        assert build.library_path(name).name.startswith(name + "-")
    assert set(K.WRAPPERS) == {"wave_commit", "segment_count", "ts_gather",
                               "ts_install_max", "commit_install",
                               "claim_scatter", "validate_dual",
                               "claim_probe", "probe", "validate",
                               "iterate_validate",
                               "mv_gather", "mv_install", "route_pack",
                               "verdict_pack", "verdict_unpack",
                               "flash_attention", "rglru", "rwkv6",
                               "apply_values", "flash_attention_backward",
                               "rglru_backward", "rwkv6_backward"}
    # validate and validate_dual share csrc/occ_validate.cu, verdict_pack
    # and verdict_unpack csrc/verdict_pack.cu, claim_probe and probe
    # csrc/claim_probe.cu; the backwards have their own
    # csrc/{flash_attention,rglru,rwkv6}_bwd.cu.
    assert len(build.SOURCES) == 20 and len(K.WRAPPERS) == 23
    for w in K.WRAPPERS.values():
        assert isinstance(w.launches, int) and isinstance(w.calls, int)


@pytest.mark.parametrize("q_shape,k_shape,dtype,route,numel", [
    ((1, 32, 4096, 128), (1, 4, 4096, 128), torch.bfloat16, True,
     32 * 4096 + 2 * 32 * 4096 * 128),
    ((2, 6, 7, 64), (2, 3, 9, 64), torch.bfloat16, True,
     84 + 2 * 2 * 6 * 9 * 64),
    ((2, 3, 7, 16), (2, 3, 9, 16), torch.bfloat16, True, 42),
    ((2, 6, 7, 256), (2, 3, 9, 256), torch.bfloat16, True,
     84 + 2 * 2 * 6 * 9 * 256),
    ((2, 6, 7, 128), (2, 3, 9, 128), torch.float32, False, 84),
], ids=["train-4k", "gqa-round-up", "rep1", "d256", "f32"])
def test_flash_backward_route_and_scratch(q_shape, k_shape, dtype, route,
                                          numel):
    """The backward's route (tensor cores for bf16 at every D) and its
    float32 scratch: Di of every row, then, on that route with GQA, from
    the next multiple of 4, the dK and dV partials of every query head,
    as csrc/flash_attention_bwd.cu lays them out."""
    import importlib
    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    assert fa.tensor_core_backward(dtype, q_shape[3]) is route
    assert fa.bwd_scratch_numel(q_shape, k_shape, dtype) == numel


def test_surface_matches_the_jax_package():
    assert pb.SURFACE_OPS == jbackend.SURFACE_OPS
    assert pb.N_OPS == jbackend.N_OPS == 16
    assert pb.CC_OPS == jbackend.CC_OPS
    for op in pb.SURFACE_OPS:
        assert hasattr(pb.BACKEND, op), op
    # Every op of the surface is ported: none waits on queue B.
    assert set(pb.SURFACE_OPS) <= set(K.WRAPPERS)


def _cfg(**kw):
    base = dict(cc=pt.CC_OCC, lanes=4, slots=4, n_records=64, n_groups=2,
                n_cols=0, n_txn_types=1)
    base.update(kw)
    return pt.EngineConfig(**base)


@pytest.mark.parametrize("kw", [
    dict(track_values=True),
], ids=["values"])
def test_settings_outside_the_slice_raise(kw):
    """Tracked values are ported (ROADMAP A.4), and a tracked wave on a
    device with no kernel raises rather than run the plain replay: the
    CPU alone takes the plain version."""
    cfg = _cfg(**kw)
    store = pt.store_init(cfg.n_records, cfg.n_groups, device="cpu",
                          n_cols=3)
    batch = pt.txn_batch_zeros(cfg.lanes, cfg.slots, "meta")
    with pytest.raises(ValueError, match="no kernel for device meta"):
        K.WRAPPERS["apply_values"](
            store.values.to("meta"), batch,
            torch.ones(cfg.lanes, dtype=torch.bool, device="meta"),
            torch.zeros(cfg.lanes, dtype=torch.int32, device="meta"))


@pytest.mark.parametrize("kw", [
    dict(max_extent=4), dict(mv_depth=2), dict(cc=pt.CC_MVCC, mv_depth=4),
    dict(cc=pt.CC_MVOCC, mv_depth=1, max_extent=8),
    dict(cc=pt.CC_MVCC, mv_depth=4, snapshot_age=8),
    dict(arrival_rate=2.0, queue_cap=8),
], ids=["scans", "mv", "mvcc", "mvocc-scans", "mvcc-aged", "open-loop"])
def test_settings_of_the_slices_build(kw):
    """Scans, the version ring, the multi-version mechanisms and the open
    loop build a config whose mechanism resolves and runs one wave on the
    CPU."""
    cfg = _cfg(**kw)
    validator = VALIDATORS[cfg.cc]
    store = pt.store_init(cfg.n_records, cfg.n_groups, device="cpu",
                          mv_depth=cfg.mv_depth)
    assert store.mv_depth == max(cfg.mv_depth, 1)
    batch = pt.txn_batch_zeros(cfg.lanes, cfg.slots, "cpu")
    batch.op_key[:, 0] = torch.arange(cfg.lanes, dtype=torch.int32)
    batch.op_kind[:, 0] = pt.READ
    batch.op_extent[:, 0] = cfg.max_extent
    prio = torch.arange(cfg.lanes, dtype=torch.int32)
    _, res = validator(store, batch, prio, 1, cfg)
    assert bool(res.commit.all())


@pytest.mark.parametrize("kw", [
    dict(mv_depth=-1), dict(cc=pt.CC_MVCC), dict(snapshot_age=2),
    dict(queue_cap=4), dict(max_extent=0), dict(bucket_size=0),
    dict(arrival_rate=-1.0), dict(max_extent=1000),
])
def test_config_validation_matches_jax(kw):
    with pytest.raises(ValueError):
        _cfg(**kw)
    with pytest.raises(ValueError):
        jt.EngineConfig(**{**dict(cc=jt.CC_OCC, lanes=4, slots=4,
                                  n_records=64, n_groups=2, n_cols=0,
                                  n_txn_types=1), **kw})


@pytest.mark.parametrize("cc", [pt.CC_MVCC, pt.CC_MVOCC],
                         ids=["mvcc", "mvocc"])
def test_multi_version_mechanisms_resolve(cc):
    """Every mechanism of the JAX package has a validator in the port."""
    assert set(VALIDATORS) == set(jt.CC_NAMES)
    assert VALIDATORS[cc].__module__ == (
        f"repro_torch.core.cc.{pt.CC_NAMES[cc]}")


def test_config_carried_across_from_jax_fields():
    from repro_torch.core.convert import config_from_fields
    jcfg = jt.EngineConfig(cc=jt.CC_TICTOC, lanes=8, slots=16,
                           n_records=100, n_groups=2, n_cols=10,
                           n_txn_types=1, granularity=0, backend="pallas",
                           fuse_wave=False)
    cfg = config_from_fields(dataclasses.asdict(jcfg))
    assert (cfg.cc, cfg.lanes, cfg.granularity) == (jt.CC_TICTOC, 8, 0)
    assert cfg.fuse_wave is False
    assert dataclasses.asdict(cfg.cost) == dataclasses.asdict(jcfg.cost)


def test_store_round_trips_uint32_bit_patterns():
    from repro_torch.core.convert import store_from_numpy, store_to_numpy
    rng = np.random.default_rng(0)
    arrays = {k: rng.integers(0, 1 << 32, (5, 2), dtype=np.uint64).astype(
        np.uint32) for k in ("wts", "rts", "claim_w", "claim_r")}
    arrays["ring_tails"] = np.arange(3, dtype=np.int32)
    arrays["pess_mode"] = np.array([True, False, False, True, False])
    arrays["fine_mode"] = ~arrays["pess_mode"]
    arrays["abort_heat"] = rng.random(5).astype(np.float32)
    arrays["false_heat"] = rng.random(5).astype(np.float32)
    arrays["heat_wave"] = np.arange(5, dtype=np.int32) * 7
    arrays["mv_begin"] = rng.integers(0, 1 << 32, (5, 3, 2),
                                      dtype=np.uint64).astype(np.uint32)
    arrays["mv_begin"][0, 1:] = 0xFFFFFFFF  # empty slots
    arrays["mv_head"] = np.array([0, 2, 1, 0, 2], dtype=np.int32)
    back = store_to_numpy(store_from_numpy(arrays, "cpu"))
    assert set(back) == set(arrays)
    for k, v in arrays.items():
        assert back[k].dtype == v.dtype, k
        np.testing.assert_array_equal(back[k], v)


def test_txn_bench_cli_on_cpu(tmp_path, capsys):
    out = tmp_path / "rows.json"
    txn_bench.main(["--workload", "ycsb", "--cc", "occ", "tictoc",
                    "--granularity", "both", "--lanes", "8", "--waves", "3",
                    "--n-keys", "2000", "--device", "cpu",
                    "--json", str(out)])
    rows = json.loads(out.read_text())
    assert len(rows) == 4
    for r in rows:
        assert r["commits"] + r["aborts"] == 24
        assert sum(r["abort_causes"].values()) == r["aborts"]
        assert r["backend"] == "cpu" and r["device_name"] == "cpu"
        assert r["kernel_ops"]["wave_commit"] == "torch"
        assert set(r["kernel_ops"].values()) <= {"torch", "not_run"}
        for key in ("workload", "cc", "granularity", "lanes", "waves",
                    "abort_rate", "ro_commits", "ro_aborts", "throughput",
                    "ext_events", "wall_s", "max_extent"):
            assert key in r
    assert "waves/s" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        txn_bench.main(["--workload", "tpcc", "--theta", "0.5"])


@pytest.mark.parametrize("fuse", [True, False], ids=["fused", "unfused"])
def test_txn_bench_runs_every_mechanism_on_cpu(fuse):
    """The grid runner takes all eight mechanisms on either route; the
    fused route never calls commit_install for the probe family, the
    unfused route never calls wave_commit; without scans no mechanism
    calls iterate_validate; MVCC and MV-OCC never call claim_scatter or
    mv_gather, and AutoGran never calls claim_scatter."""
    rows = txn_bench.run_grid("ycsb", list(txn_bench.CCS), (0,), [8], 3,
                              n_keys=2000, device="cpu", fuse_wave=fuse)
    assert [r["cc"] for r in rows] == list(txn_bench.CCS)
    for r in rows:
        assert r["commits"] + r["aborts"] == 24
        assert sum(r["abort_causes"].values()) == r["aborts"]
        ops = dict(r["kernel_ops"])
        assert "cuda" not in ops.values()
        assert ops.pop("iterate_validate", "not_run") == "not_run"
        if r["cc"] in ("mvcc", "mvocc"):
            # Both claim installs and the ring read ride the wave's one
            # validate call.
            assert ops.pop("claim_scatter") == "not_run"
            assert ops.pop("mv_gather") == "not_run"
        if r["cc"] == "autogran":
            # Its write claims ride its one validate_dual call.
            assert ops.pop("claim_scatter") == "not_run"
        if r["cc"] in ("autogran", "mvcc", "mvocc"):
            assert set(ops.values()) == {"torch"}
            continue
        if r["cc"] != "tictoc":
            assert ops["commit_install"] == ("not_run" if fuse else "torch")
        assert ops["wave_commit"] == ("torch" if fuse else "not_run")
