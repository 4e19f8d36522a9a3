"""PyTorch + CUDA port of the wave-based transaction engine.

The JAX package ``repro`` is the reference; this package reimplements its
closed-loop wave engine (all eight mechanisms, scans and the
multi-version ring, over TPC-C and YCSB) in PyTorch, with every TPU
kernel of that path rewritten as a CUDA kernel for Hopper (``csrc/``).  Nothing here imports ``jax`` or ``repro``.

Entry points default to ``device="cuda"`` and raise when CUDA is absent;
pass ``device="cpu"`` to run the plain PyTorch versions of the kernels.
"""
