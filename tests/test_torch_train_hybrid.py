"""The port's training step against the JAX package's on the smoke
configuration of recurrentgemma-9b (the hybrid family: RG-LRU and local
attention; rglru through RGLRUFn, its plain forward and backward): the
loss and every gradient, and remat on = remat off, bit for bit. The
checks and their tolerances are in tests/train_harness.py."""
import train_harness as th

ARCH = "recurrentgemma-9b"


def test_loss_and_grads_match_jax():
    th.check_loss_and_grads(ARCH)


def test_remat_gives_the_same_bits():
    th.check_remat(ARCH)
