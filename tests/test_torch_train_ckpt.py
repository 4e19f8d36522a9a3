"""The port's training plumbing on the CPU: ``data.make_batch``,
``checkpoint.store``, ``ft.failures`` and ``launch.train``, as
tests/test_checkpoint.py holds the JAX package's.

- make_batch: a pure function of (seed, step[, host]): the same step
  draws the same tokens, another step others; host slices are B / count
  rows each, different per host, and the stubs' patches and frames;
- the store: a roundtrip with float32, bfloat16 (stored as uint16) and
  nested lists, bit for bit; the fingerprint refusal; async saves with
  retention; a restore onto meta-shaped trees, onto the named device;
- 3 steps, checkpoint, restore, 3 steps = 6 straight steps, bit for bit;
- the supervisor surviving two injected failures ends with the
  no-failure run's parameters exactly;
- the launcher: ``--device cpu`` runs; ``--data``/``--model`` above 1
  raise naming ROADMAP A.12.3c; CUDA asked for and absent raises;
- rglru and rwkv6 refuse a device without a kernel (meta tensors stand
  in for the card's here) under autograd as without grad: the autograd
  call goes through RGLRUFn / RWKV6Fn to the same launch checks, and so
  do their backward wrappers.
"""
import dataclasses
import os

import pytest
import torch

from repro_torch import configs
from repro_torch.checkpoint import (CheckpointManager, latest_step, restore,
                                    save)
from repro_torch.configs.base import ShapeSpec
from repro_torch.data import make_batch
from repro_torch.ft import FailureInjector
from repro_torch.kernels.rglru import rglru, rglru_backward
from repro_torch.kernels.rwkv6 import rwkv6, rwkv6_backward
from repro_torch.launch import train as train_mod
from repro_torch.launch.train import TrainRun, run_supervised
from repro_torch.models import model as M
from repro_torch.models import steps
from repro_torch.models.common import flatten, tree_map
from repro_torch.optim import AdamW


@pytest.fixture
def one_thread():
    """The smoke models train faster on one intra-op thread, and stay
    fast when parallel test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tree():
    return {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "b": {"c": torch.randn(4, generator=torch.Generator()
                                   .manual_seed(0)).to(torch.bfloat16)},
            "layers": [{"w": torch.full((2,), 0.5)},
                       {"w": torch.zeros(())}]}


def _equal(x, y):
    fx, fy = flatten(x), flatten(y)
    assert [p for p, _ in fx] == [p for p, _ in fy]
    for (p, a), (_, b) in zip(fx, fy):
        assert a.dtype == b.dtype, p
        assert torch.equal(a, b), p


def test_make_batch_is_a_function_of_the_step():
    cfg = configs.get_smoke("qwen2-7b")
    shape = ShapeSpec("t", "train", 16, 4)
    a, b = make_batch(cfg, shape, 3), make_batch(cfg, shape, 3)
    assert a["tokens"].shape == (4, 17) and a["tokens"].dtype == torch.int64
    assert torch.equal(a["tokens"], b["tokens"])
    assert not torch.equal(a["tokens"], make_batch(cfg, shape, 4)["tokens"])
    assert int(a["tokens"].min()) >= 0
    assert int(a["tokens"].max()) < cfg.vocab
    serve = make_batch(cfg, ShapeSpec("t", "prefill", 16, 4), 3,
                       train=False)
    assert serve["tokens"].shape == (4, 16)


def test_make_batch_host_slices():
    cfg = configs.get_smoke("qwen2-7b")
    shape = ShapeSpec("t", "train", 16, 8)
    parts = [make_batch(cfg, shape, 5, host_slice=(i, 4))["tokens"]
             for i in range(4)]
    assert all(p.shape == (2, 17) for p in parts)
    assert not torch.equal(parts[0], parts[1])
    again = make_batch(cfg, shape, 5, host_slice=(2, 4))["tokens"]
    assert torch.equal(parts[2], again)
    with pytest.raises(AssertionError):
        make_batch(cfg, shape, 5, host_slice=(0, 3))


def test_make_batch_frontend_stubs():
    cfg = dataclasses.replace(configs.get_smoke("qwen2-7b"), n_patches=4,
                              n_frames=6)
    b = make_batch(cfg, ShapeSpec("t", "train", 16, 2), 0)
    assert b["tokens"].shape == (2, 13)
    assert b["patches"].shape == (2, 4, cfg.d_model)
    assert b["frames"].shape == (2, 6, cfg.d_model)
    assert b["patches"].dtype == b["frames"].dtype == torch.bfloat16


def test_roundtrip(tmp_path):
    d = str(tmp_path)
    save(d, 3, tree(), fingerprint="fp", extra={"cursor": 7})
    got, manifest = restore(d, 3, tree(), fingerprint="fp")
    _equal(got, tree())
    assert manifest["step"] == 3 and manifest["extra"] == {"cursor": 7}
    assert manifest["leaves"]["['b']['c']"]["dtype"] == "bfloat16"
    # A like tree of meta tensors: shapes and dtypes only.
    like = tree_map(lambda t: t.to("meta"), tree())
    got, _ = restore(d, 3, like, device="cpu")
    _equal(got, tree())


def test_fingerprint_mismatch_refuses(tmp_path):
    d = str(tmp_path)
    save(d, 1, tree(), fingerprint="qwen3-32b")
    with pytest.raises(ValueError, match="fingerprint"):
        restore(d, 1, tree(), fingerprint="rwkv6-3b")


def test_shape_mismatch_refuses(tmp_path):
    d = str(tmp_path)
    save(d, 1, tree())
    bad = tree()
    bad["a"] = torch.zeros(3, 2)
    with pytest.raises(ValueError, match="saved"):
        restore(d, 1, bad)


def test_async_save_and_retention(tmp_path):
    d = str(tmp_path)
    t = tree()
    handles = [save(d, s, t, blocking=False, keep=2) for s in (1, 2, 3)]
    t["a"].add_(100.0)          # after the snapshot: not in the files
    for h in handles:
        h.join()
    on_disk = [s for s in sorted(os.listdir(d)) if s.startswith("step_")]
    assert len(on_disk) <= 2 and not any(s.endswith(".tmp")
                                         for s in on_disk)
    assert latest_step(d) == 3
    got, _ = restore(d, 3, tree())
    _equal(got, tree())


def _run_steps(cfg, opt, shape, params, state, lo, hi):
    ts = steps.build_train_step(cfg, opt)
    for s in range(lo, hi):
        params, state, _ = ts(params, state, make_batch(cfg, shape, s), s)
    return params, state


def _clone(x):
    return tree_map(lambda t: t.detach().clone(), x)


def test_restart_continuation_is_exact(tmp_path, one_thread):
    """6 straight steps against 3 + checkpoint + restore + 3: the same
    parameters and optimizer state, bit for bit."""
    cfg = configs.get_smoke("qwen2-7b")
    shape = ShapeSpec("t", "train", 16, 2)
    opt = AdamW.from_config(cfg, total_steps=6, warmup_steps=1)
    p0 = M.init_params(cfg, 0, "cpu")
    o0 = opt.init(p0)
    p6, o6 = _run_steps(cfg, opt, shape, _clone(p0), _clone(o0), 0, 6)

    p3, o3 = _run_steps(cfg, opt, shape, _clone(p0), _clone(o0), 0, 3)
    d = str(tmp_path)
    save(d, 3, {"params": p3, "opt": o3})
    got, manifest = restore(d, 3, {"params": p3, "opt": o3})
    pr, orr = _run_steps(cfg, opt, shape, got["params"], got["opt"],
                         manifest["step"], 6)
    _equal(pr, p6)
    _equal(orr, o6)


def _build_run(cfg, ckdir, inject):
    return TrainRun(
        cfg=cfg, optimizer=AdamW.from_config(cfg, total_steps=8,
                                             warmup_steps=1),
        shape=ShapeSpec("t", "train", 16, 2),
        ckpt=CheckpointManager(ckdir, interval=2, fingerprint="t"),
        injector=FailureInjector(at_steps=inject), log_every=100,
        device="cpu")


def test_supervisor_survives_injected_failures(tmp_path, one_thread):
    """Two injected failures: the run reaches its step and ends with the
    no-failure run's parameters exactly; its last checkpoint restores
    them bit for bit."""
    cfg = configs.get_smoke("starcoder2-3b")
    p_fail, o_fail, _, restarts = run_supervised(
        _build_run(cfg, str(tmp_path / "a"), (3, 5)), 8)
    assert restarts == 2
    p_ok, _, _, r0 = run_supervised(_build_run(cfg, str(tmp_path / "b"),
                                               ()), 8)
    assert r0 == 0
    _equal(p_fail, p_ok)
    ck = CheckpointManager(str(tmp_path / "a"), fingerprint="t")
    assert ck.latest() == 8
    got, _ = ck.restore_latest({"params": p_fail, "opt": o_fail})
    _equal(got["params"], p_fail)
    _equal(got["opt"], o_fail)


def test_launcher_runs_on_the_cpu(tmp_path, capsys, one_thread):
    losses, restarts = train_mod.main(
        ["--arch", "qwen2-7b", "--smoke", "--device", "cpu", "--steps", "4",
         "--batch", "2", "--seq", "16", "--ckpt-dir", str(tmp_path),
         "--ckpt-every", "2", "--fail-at", "2"])
    assert restarts == 1 and losses[-1][0] == 4
    assert latest_step(str(tmp_path)) == 4
    assert "[train] done: 4 steps" in capsys.readouterr().out


@pytest.mark.parametrize("flag", ["--data", "--model"])
def test_launcher_refuses_more_than_one_card(flag):
    with pytest.raises(NotImplementedError, match="A.12.3c"):
        train_mod.main(["--arch", "qwen2-7b", "--smoke", flag, "2"])


def test_launcher_refuses_a_missing_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_mod.main(["--arch", "qwen2-7b", "--smoke", "--steps", "1",
                        "--ckpt-dir", str(tmp_path)])


def test_recurrent_kernels_refuse_autograd_off_the_cpu():
    m = torch.device("meta")
    log_a = torch.zeros(1, 4, 8, device=m)
    x = torch.zeros(1, 4, 8, device=m, requires_grad=True)
    r = torch.zeros(1, 2, 4, 16, device=m, requires_grad=True)
    w = torch.zeros(1, 2, 4, 16, device=m)
    u = torch.zeros(2, 16, device=m)
    for grad in (True, False):  # through RGLRUFn / RWKV6Fn, and without
        with torch.set_grad_enabled(grad):
            with pytest.raises(ValueError, match="no kernel for device meta"):
                rglru(log_a, x)
            with pytest.raises(ValueError, match="no kernel for device meta"):
                rwkv6(r, r, r, w, u)
    with pytest.raises(ValueError, match="no kernel for device meta"):
        rglru_backward(log_a, x, None, x)
    with pytest.raises(ValueError, match="no kernel for device meta"):
        rwkv6_backward(r, r, r, w, u, None, r)
