"""The port's serving entry point (repro_torch.launch.serve) on the CPU.

- ``serve`` on a numpy prompt, with one JAX ``init_params`` draw carried
  across, gives the JAX prefill/decode path's greedy tokens;
- the CLI (``--device cpu --smoke``) draws its own weights and prompt;
  the same weights and prompt, carried to the JAX package, give the JAX
  path's greedy tokens;
- on the CPU no kernel launches, and every wrapper call is the plain
  version: rglru once per RG-LRU layer per step, flash_attention once per
  attention layer in the prefill only, rwkv6 once per RWKV layer per step;
- without CUDA the default device raises; families outside the slice
  raise NotImplementedError naming ROADMAP A.12.
"""
import numpy as np
import pytest
import torch

from lm_harness import jax_generate, jax_init, params_to_jax, top2_gaps
from repro import configs as jconfigs
from repro_torch import configs
from repro_torch import kernels as K
from repro_torch.core.convert import lm_params_from_jax
from repro_torch.launch import serve as serve_mod
from repro_torch.models import model as pm


@pytest.mark.parametrize("arch", ["recurrentgemma-9b", "rwkv6-3b"])
def test_serve_gives_the_jax_greedy_tokens(arch):
    jcfg, cfg = jconfigs.get_smoke(arch), configs.get_smoke(arch)
    jp, npp = jax_init(jcfg, seed=2)
    prompt = np.random.default_rng(5).integers(
        0, cfg.vocab, (3, 36)).astype(np.int32)
    want, logits, _ = jax_generate(jcfg, jp, prompt, 6)
    print(arch, "smallest top-2 gap per step",
          [float(top2_gaps(x).min()) for x in logits])
    K.reset_launches()
    res = serve_mod.serve(cfg, n_requests=3, prompt_len=36, gen=6,
                          device="cpu", tokens=prompt,
                          params=lm_params_from_jax(cfg, npp))
    np.testing.assert_array_equal(res.tokens, want)
    assert res.tokens.dtype == np.int64 and res.tokens.shape == (3, 6)
    assert res.device == "cpu" and res.peak_bytes == 0
    assert res.prefill_logits.shape == (3, cfg.vocab)
    assert res.decode_logits.shape == (3, cfg.vocab)
    # Launch log: one entry per step, all zero on the CPU.
    assert len(res.launches) == 6
    assert all(n == 0 for step in res.launches for n in step.values())
    types = cfg.layer_types()
    calls = K.call_counts()
    assert calls["rglru"] == 6 * types.count("rec")
    assert calls["rwkv6"] == 6 * types.count("rwkv")
    assert calls["flash_attention"] == types.count("attn")
    K.reset_launches()


def test_cli_on_cpu_gives_the_jax_greedy_tokens(capsys):
    """The CLI's own draw (weights from --seed, prompt from seed + 1),
    carried to the JAX package, decodes to the same tokens there."""
    res = serve_mod.main(["--arch", "qwen3-32b", "--smoke", "--device",
                          "cpu", "--requests", "2", "--prompt-len", "20",
                          "--gen", "5", "--seed", "3"])
    out = capsys.readouterr().out
    assert "prefill" in out and "tok/s" in out and "on cpu" in out
    cfg, jcfg = configs.get_smoke("qwen3-32b"), jconfigs.get_smoke(
        "qwen3-32b")
    params = pm.init_params(cfg, 3, "cpu")
    gen = torch.Generator()
    gen.manual_seed(4)
    from repro_torch.data.pipeline import tokens
    prompt = tokens(gen, (2, 20), cfg.vocab).numpy().astype(np.int32)
    want, _, _ = jax_generate(jcfg, params_to_jax(cfg, params), prompt, 5)
    np.testing.assert_array_equal(res.tokens, want)


def test_prompt_tokens_follow_the_zipf_flavoured_draw():
    from repro_torch.data.pipeline import tokens
    gen = torch.Generator()
    gen.manual_seed(0)
    t = tokens(gen, (64, 512), 1000)
    assert t.dtype == torch.int64 and int(t.min()) >= 0
    assert int(t.max()) <= 999
    # P(token < vocab / 16) = P(u < 1/2) = 1/2 for u**4 * vocab.
    assert 0.47 < float((t < 1000 / 16).float().mean()) < 0.53


def test_serve_defaults_to_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = configs.get_smoke("rwkv6-3b")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve_mod.serve(cfg, n_requests=1, prompt_len=4, gen=2)
    # The full-width model is never built on the CPU.
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve_mod.main(["--arch", "recurrentgemma-9b"])


@pytest.mark.parametrize("arch", ["mixtral-8x22b", "llama4-maverick-400b-a17b",
                                  "whisper-medium", "llava-next-34b"])
def test_families_outside_the_slice_raise(arch):
    cfg = configs.get_smoke(arch)
    with pytest.raises(NotImplementedError, match="ROADMAP A.12"):
        pm.init_params(cfg, 0, "cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP A.12"):
        pm.init_cache(cfg, 1, 8, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP A.12"):
        serve_mod.serve(cfg, n_requests=1, prompt_len=4, gen=2,
                        device="cpu")


def test_configs_are_the_jax_package_configs():
    """The port's registry is a copy: every field and derived size of
    every config and smoke config equals the JAX package's."""
    import dataclasses
    assert set(configs.ARCHS) == set(jconfigs.ARCHS)
    for name in configs.ARCHS:
        for get in ("get", "get_smoke"):
            a = getattr(configs, get)(name)
            b = getattr(jconfigs, get)(name)
            assert dataclasses.asdict(a) == dataclasses.asdict(b), name
            assert (a.n_heads, a.vocab, a.d_lru, a.layer_types(),
                    a.stage_split(), a.param_count()) == (
                b.n_heads, b.vocab, b.d_lru, b.layer_types(),
                b.stage_split(), b.param_count()), name
    assert set(configs.SHAPES) == set(jconfigs.SHAPES)
