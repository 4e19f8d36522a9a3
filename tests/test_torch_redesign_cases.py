"""The yardsticks of the card's edge cases, held against the JAX oracles.

``chip_smoke.py`` holds the CUDA ``segment_count`` (shared-memory hash
and all-pairs paths) and the bfloat16 tensor-core ``flash_attention``
against their plain versions on the edge cases of
``chip_smoke.segment_count_cases`` and ``chip_smoke.FLASH_BF16_EDGE_CASES``.
Here, on the CPU, the plain versions meet ``ref.segment_count`` and
``ref.attention`` (JAX) on exactly those cases, made with numpy from a
seed, so the card compares against a yardstick that is itself right.

Tolerances (tests/lm_harness.py): counts exact; attention float32 rtol
1e-5 / atol 1e-5, bfloat16 within 2 bf16 ulps.  ``ref.attention`` has no
``sq_valid``/``sk_valid``: it runs on the valid slices, which it end-aligns
as the port does; a row that sees no key is 0 in the port and the mean of
v in the oracle (ROADMAP C.2), so such rows are checked to be 0.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from lm_harness import assert_bf16_close, assert_close
from repro.kernels import ref
from repro_torch import kernels as K
from repro_torch.kernels.flash_attention import attention_mask
from repro_torch.kernels.flash_attention import flash_attention_plain
from repro_torch.kernels.segment_count import HASH_MAX_OPS
from repro_torch.kernels.segment_count import segment_count_plain

SEGMENT_CASES = chip_smoke.segment_count_cases()
FLASH_CASES = chip_smoke.FLASH_BF16_EDGE_CASES


@pytest.mark.parametrize("case", SEGMENT_CASES,
                         ids=[c[0] for c in SEGMENT_CASES])
def test_segment_count_plain_matches_ref_on_card_cases(case):
    _, keys, groups, G, mask = case
    want = np.asarray(ref.segment_count(jnp.asarray(keys),
                                        jnp.asarray(groups), G,
                                        jnp.asarray(mask)))
    t = [torch.from_numpy(x) for x in (keys, groups, mask)]
    got = segment_count_plain(t[0], t[1], G, t[2])
    assert got.dtype == torch.float32 and got.shape == keys.shape
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(K.segment_count(t[0], t[1], G, t[2]), got)


def test_segment_count_cases_reach_both_kernels():
    """The cases reach both sides of the wrapper's size switch, at its
    edge: n = 1, n = HASH_MAX_OPS and n = HASH_MAX_OPS + 1."""
    sizes = {c[1].size for c in SEGMENT_CASES}
    assert {1, HASH_MAX_OPS, HASH_MAX_OPS + 1} <= sizes
    assert max(sizes) > 2 * HASH_MAX_OPS


def _pair(x: np.ndarray, dt: str):
    """The same values as a JAX array and a torch tensor (bf16 rounded
    once, in JAX, and carried bit for bit)."""
    j = jnp.asarray(x, jnp.float32)
    if dt == "bf16":
        j = j.astype(jnp.bfloat16)
    t = torch.from_numpy(np.array(j.astype(jnp.float32)))
    return j, t.to(torch.bfloat16) if dt == "bf16" else t


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("case", FLASH_CASES,
                         ids=[c[0] for c in FLASH_CASES])
def test_flash_attention_plain_matches_ref_on_card_cases(case, dt):
    label, s, _ = case
    B, Hq, Hkv, Sq, Sk, D = (s[k] for k in ("B", "Hq", "Hkv", "Sq", "Sk",
                                            "D"))
    sq_valid = s.get("sq_valid") or Sq
    sk_valid = s.get("sk_valid") or Sk
    rng = np.random.default_rng(FLASH_CASES.index(case))
    qj, qt = _pair(rng.standard_normal((B, Hq, Sq, D)) * D ** -0.25, dt)
    kj, kt = _pair(rng.standard_normal((B, Hkv, Sk, D)) * D ** -0.25, dt)
    vj, vt = _pair(rng.standard_normal((B, Hkv, Sk, D)), dt)
    kw = dict(causal=s["causal"], window=s["window"])
    port = flash_attention_plain(qt, kt, vt, sq_valid=s.get("sq_valid"),
                                 sk_valid=s.get("sk_valid"), **kw)
    assert port.dtype == qt.dtype and port.shape == qt.shape
    want = ref.attention(qj[:, :, :sq_valid], kj[:, :, :sk_valid],
                         vj[:, :, :sk_valid], **kw)
    want = torch.from_numpy(np.array(want.astype(jnp.float32)))
    sees = attention_mask(Sq, Sk, sq_valid=sq_valid, sk_valid=sk_valid,
                          **kw)[:sq_valid].any(-1)
    got = port[:, :, :sq_valid]
    assert torch.equal(got[:, :, ~sees].float(),
                       torch.zeros_like(want[:, :, ~sees]))
    what = f"{label} {dt} vs ref.attention"
    if dt == "bf16":
        assert_bf16_close(got[:, :, sees], want[:, :, sees], ulps=2,
                          atol=1e-5, what=what)
    else:
        assert_close(got[:, :, sees], want[:, :, sees], 1e-5, 1e-5, what)


def test_flash_edge_cases_are_card_cases():
    """Every edge case is bfloat16 (the tensor-core kernel's dtype) and is
    among chip_smoke's kernel cases, whose first stays the timed prefill
    shape."""
    assert all(c[2] == torch.bfloat16 for c in FLASH_CASES)
    assert all(c in chip_smoke.FLASH_CASES for c in FLASH_CASES)
    assert chip_smoke.FLASH_CASES[0][0] == "rg9b-prefill"
    assert {c[1]["D"] for c in FLASH_CASES} >= {16, 32, 256}
