"""PyTorch + CUDA port of the wave-based transaction engine.

The JAX package ``repro`` is the reference; this package reimplements its
main path (the closed-loop wave engine with OCC and TicToc over TPC-C and
YCSB) in PyTorch, with every TPU kernel of that path rewritten as a CUDA
kernel for Hopper (``csrc/``).  Nothing here imports ``jax`` or ``repro``.

Entry points default to ``device="cuda"`` and raise when CUDA is absent;
pass ``device="cpu"`` to run the plain PyTorch versions of the kernels.
"""
