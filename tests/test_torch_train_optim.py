"""The port's AdamW (src/repro_torch/optim/adamw.py) against the JAX
package's, on tests/test_optim.py's cases: the warmup-cosine schedule,
global-norm clipping, the float32 master copy of bfloat16 parameters, the
moment dtype and a quadratic descent.  The same numpy parameters and
gradients go to both; parameters, m, v, master, gnorm and lr after each
step must agree within rtol 1e-5 / atol 1e-7 in float32 (the same
float32 operations, a sum in another order), and bfloat16 leaves bit for
bit."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import AdamW as JAdamW
from repro_torch.optim import AdamW


def _t(a) -> torch.Tensor:
    a = jnp.asarray(a)
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(np.array(a.astype(jnp.float32))).to(
            torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _same(port: torch.Tensor, want, what: str):
    want = _t(want)
    assert port.dtype == want.dtype, (what, port.dtype, want.dtype)
    if port.dtype == torch.bfloat16:
        assert torch.equal(port, want), what
    else:
        torch.testing.assert_close(port, want, rtol=1e-5, atol=1e-7,
                                   msg=lambda m: f"{what}: {m}")


def _run(kw, p0: dict, grads, n_steps: int):
    """Both optimizers from ``p0`` (numpy) for ``n_steps``; ``grads(step,
    params)`` gives numpy gradients from the JAX run's parameters."""
    jopt, topt = JAdamW(**kw), AdamW(**kw)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    tp = {k: _t(v) for k, v in jp.items()}
    js, ts = jopt.init(jp), topt.init(tp)
    for k in jp:
        _same(ts["m"][k], js["m"][k], f"m0 {k}")
        if "master" in js:
            _same(ts["master"][k], js["master"][k], f"master0 {k}")
    for i in range(n_steps):
        g = grads(i, jp)
        jp, js, jm = jopt.update({k: jnp.asarray(v) for k, v in g.items()},
                                 js, jp, jnp.int32(i))
        tp, ts, tm = topt.update({k: _t(v) for k, v in g.items()}, ts, tp,
                                 i)
        _same(tm["gnorm"], jm["gnorm"], f"gnorm {i}")
        _same(tm["lr"], jm["lr"], f"lr {i}")
        for k in jp:
            _same(tp[k], jp[k], f"param {k} step {i}")
            for s in js:
                _same(ts[s][k], js[s][k], f"{s} {k} step {i}")
    return tp, ts


def test_schedule_warmup_then_cosine():
    kw = dict(peak_lr=1.0, warmup_steps=10, total_steps=110,
              min_lr_frac=0.1)
    for s in (0, 1, 5, 9, 10, 11, 37, 60, 109, 110, 200):
        _same(AdamW(**kw).lr(s), JAdamW(**kw).lr(jnp.int32(s)), f"lr {s}")
    assert float(AdamW(**kw).lr(5)) == pytest.approx(0.5)
    assert float(AdamW(**kw).lr(110)) == pytest.approx(0.1)


def test_clipping_bounds_update():
    kw = dict(peak_lr=1e-1, warmup_steps=0, total_steps=10, clip_norm=1.0,
              weight_decay=0.0)
    tp, _ = _run(kw, {"w": np.zeros(4, np.float32)},
                 lambda i, p: {"w": np.full(4, 100.0, np.float32)}, 2)
    assert float(tp["w"].abs().max()) < 1.0


def test_master_weights_accumulate_small_updates():
    kw = dict(peak_lr=1e-5, warmup_steps=0, total_steps=1000,
              weight_decay=0.0, master_f32=True)
    p0 = {"w": np.asarray(jnp.ones((1,), jnp.bfloat16)),
          "b": np.asarray([0.5, -0.25], np.float32)}

    def grads(i, p):
        return {"w": np.asarray(jnp.full((1,), 1e-3, jnp.bfloat16)),
                "b": np.asarray([0.1, -0.3], np.float32)}
    tp, ts = _run(kw, p0, grads, 5)
    assert float(ts["master"]["w"][0]) != 1.0
    assert ts["master"]["b"].shape == ()       # float32: a placeholder


def test_moment_dtype_honored():
    kw = dict(moment_dtype="bfloat16", warmup_steps=0, total_steps=10)
    rng = np.random.default_rng(0)
    p0 = {"w": rng.standard_normal((3, 5)).astype(np.float32)}
    _, ts = _run(kw, p0, lambda i, p: {"w": rng.standard_normal(
        (3, 5)).astype(np.float32)}, 3)
    assert ts["m"]["w"].dtype == torch.bfloat16


def test_descends_quadratic():
    kw = dict(peak_lr=0.1, warmup_steps=2, total_steps=120,
              weight_decay=0.0)
    tp, _ = _run(kw, {"w": np.asarray([3.0, -2.0], np.float32)},
                 lambda i, p: {"w": 2 * np.asarray(p["w"])}, 120)
    assert float(tp["w"].abs().max()) < 0.5


def test_weight_decay_and_bf16_params_with_master():
    """Decay on a bf16 parameter with its f32 master, clipped gradients
    and the warmup: the path the full-width models train on."""
    kw = dict(peak_lr=3e-3, warmup_steps=2, total_steps=8, clip_norm=0.5,
              weight_decay=0.1)
    rng = np.random.default_rng(3)
    p0 = {"w": np.asarray(jnp.asarray(rng.standard_normal((4, 6)),
                                      jnp.bfloat16)),
          "n": np.zeros(6, np.float32)}

    def grads(i, p):
        return {"w": np.asarray(jnp.asarray(rng.standard_normal((4, 6)),
                                            jnp.bfloat16)),
                "n": rng.standard_normal(6).astype(np.float32)}
    _run(kw, p0, grads, 6)
