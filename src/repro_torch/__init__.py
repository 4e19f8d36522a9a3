"""PyTorch + CUDA port of the wave-based transaction engine and of the
language-model serving path.

The JAX package ``repro`` is the reference.  This package reimplements
its closed-loop wave engine (all eight mechanisms, scans and the
multi-version ring, over TPC-C and YCSB), its synchronous sharded wave on
``torch.distributed``, and LM serving (``configs/``, ``models/``,
``launch/serve.py``: the dense, hybrid and ssm decoder families, batched
prefill and greedy decode with caches) in PyTorch, with every TPU kernel
of those paths rewritten as a CUDA kernel for Hopper (``csrc/``).
Nothing here imports ``jax`` or ``repro``.

Entry points default to ``device="cuda"`` and raise when CUDA is absent;
pass ``device="cpu"`` to run the plain PyTorch versions of the kernels.
"""
