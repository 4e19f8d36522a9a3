"""Same-cell op counts within one wave.

Replaces the TPU kernel ``segment_count_pallas``
(src/repro/kernels/segment_count.py); the semantics are the JAX oracle
``ref.segment_count`` (= ``claims.cell_counts``): per op, the number of
masked ops of the wave whose cell ``key * G + group`` equals its own, as
float32, 0 where the op is masked.  TicToc's rts-extension and install
chains and the engine's install-contention cost model read it.

CUDA tensors launch ``csrc/segment_count.cu``, whose kernel is chosen by
the wave's size n.  Up to ``HASH_MAX_OPS`` (8,192) ops, every wave the
engines run: 16 blocks of 1,024 threads, each counting the cells whose
hash falls in its sixteenth, through an open-addressing hash table in
shared memory (4 slots an op up to 16,384; 224 KB with the list of the
block's ops).  Above: the all-pairs count over a grid of 256-op blocks x
1,024-op chunks, partial counts added with atomics.  CPU tensors take
``segment_count_plain``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIG = {"repro_segment_count_hash": [_P] * 4 + [_I] * 2 + [_P],
        "repro_segment_count_pairs": [_P] * 4 + [_I] * 2 + [_P]}
#: Largest wave the shared-memory hash kernel takes; larger waves take the
#: all-pairs kernel.
HASH_MAX_OPS = 8192

# Cell id of masked ops; no real key * G + group reaches it.
_MASKED_CELL = -(1 << 62)


def segment_count_plain(keys: torch.Tensor, groups: torch.Tensor, G: int,
                        mask: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: a unique-with-counts over the wave's cells."""
    cell = torch.where(mask, keys.to(torch.int64) * G + groups.to(torch.int64),
                       _MASKED_CELL)
    _, inv, cnt = torch.unique(cell.reshape(-1), return_inverse=True,
                               return_counts=True)
    out = torch.where(mask.reshape(-1), cnt[inv], 0)
    return out.reshape(keys.shape).to(torch.float32)


def segment_count(keys: torch.Tensor, groups: torch.Tensor, G: int,
                  mask: torch.Tensor) -> torch.Tensor:
    """float32[T, K] same-cell op counts (0 where masked)."""
    segment_count.calls += 1
    if keys.device.type == "cpu":
        return segment_count_plain(keys, groups, G, mask)
    dev = build.launch_device(keys)
    shape = tuple(keys.shape)
    build.check("keys", keys, torch.int32, shape, dev)
    build.check("groups", groups, torch.int32, shape, dev)
    build.check("mask", mask, torch.bool, shape, dev)
    out = torch.empty(shape, dtype=torch.float32, device=dev)
    lib = build.load("segment_count", _SIG)
    n = keys.numel()
    fn = (lib.repro_segment_count_hash if n <= HASH_MAX_OPS
          else lib.repro_segment_count_pairs)
    with torch.cuda.device(dev):
        rc = fn(build.ptr(keys), build.ptr(groups), build.ptr(mask),
                build.ptr(out), n, int(G), build.stream(dev))
    build.raise_on_error("segment_count", rc)
    segment_count.launches += 1
    return out


segment_count.launches = 0
segment_count.calls = 0
