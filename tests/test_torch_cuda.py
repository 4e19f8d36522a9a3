"""The port's CUDA kernels against their plain versions, on the card.

Imports neither JAX nor the JAX package, so it runs on a GPU host that
has only PyTorch and the CUDA toolkit:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py

Every test is marked ``cuda`` and skips where torch.cuda.is_available()
is False (CUDA kernels have no CPU mode).
"""
import pytest
import torch

import chip_smoke


def _cuda() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(997, 2, 16, 64), (4096, 2, 128, 16),
                                   (50, 1, 3, 5)],
                         ids=["tpcc-like", "ycsb-like", "ragged"])
def test_kernels_bit_identical_to_plain_versions(shape):
    """All eight kernels, every flag combination, hot/duplicate/masked
    ops, stale claim tags: chip_smoke's kernel phase raises on any
    difference."""
    checks, _ = chip_smoke.kernel_phase(_cuda(), {"case": shape})
    assert set(checks) == set(chip_smoke.KERNEL_META)
    for c in checks.values():
        assert c.equal and c.max_err == 0.0 and c.cases > 0, c.name


@pytest.mark.cuda
def test_wave_step_identical_on_card_and_cpu():
    """Every mechanism and the unfused route, heats and mode bits too."""
    chip_smoke.cross_device(_cuda(), waves=5, scale=0.01)


@pytest.mark.cuda
def test_fused_and_unfused_routes_identical_on_card():
    """claim_probe + commit_install against wave_commit, on one mechanism
    that runs both claim tables and bumps."""
    chip_smoke.fused_unfused(_cuda(), waves=5, scale=0.01,
                             ccs=(("adaptive", 0),))
