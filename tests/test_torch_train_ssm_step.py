"""The port's training step against the JAX package's on the smoke
configuration of rwkv6-3b (the ssm family; rwkv6 through RWKV6Fn, its
plain forward and backward): one AdamW step, n_micro 1 and 2. The checks
and their tolerances are in tests/train_harness.py."""
import pytest

import train_harness as th

ARCH = "rwkv6-3b"


@pytest.mark.parametrize("n_micro", (1, 2))
def test_one_adamw_step_matches_jax(n_micro):
    th.check_adamw_step(ARCH, n_micro)
