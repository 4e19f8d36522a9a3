"""Wave-scoped claim helpers (the port of ``repro/core/claims.py``).

Claim tables are reset-free thanks to the monotone wave tag of
``core/claimword.py``; installing and probing them is the job of the
backend ops (``core/backend.py``).  What stays here is the per-wave
arithmetic the mechanisms share: priorities, the stateless hash behind the
overlap thinning, same-cell counts and first-conflict indices.  uint32
arithmetic is done in int64 and masked to 32 bits.
"""
from __future__ import annotations

import torch

from repro_torch.core.claimword import U32_MASK
from repro_torch.core.types import PRIO_LANE_BITS
from repro_torch.kernels.segment_count import segment_count_plain


def prio16(age: torch.Tensor, lane_rank: torch.Tensor,
           use_age: bool = False) -> torch.Tensor:
    """In-wave priority as int32; lower wins.  ``use_age`` enables the
    SwissTM-style contention manager (older transactions win claims)."""
    max_age = (1 << (16 - PRIO_LANE_BITS)) - 1  # 63
    if use_age:
        inv_age = max_age - torch.clamp(age.to(torch.int64), 0, max_age)
    else:
        inv_age = torch.full_like(age, max_age, dtype=torch.int64)
    rank = lane_rank.to(torch.int64) & ((1 << PRIO_LANE_BITS) - 1)
    return ((inv_age << PRIO_LANE_BITS) | rank).to(torch.int32)


def hash01(wave: int, lane_op_ids: torch.Tensor) -> torch.Tensor:
    """Deterministic per-(wave, lane, op) uniform float32 in [0, 1).

    The JAX version multiplies uint32s with wraparound; here the products
    run in int64, where the first may wrap past 2**63 — its low 32 bits,
    the only ones kept, survive the wrap."""
    h = ((lane_op_ids.to(torch.int64) & U32_MASK) * 0x9E3779B9
         + ((int(wave) & U32_MASK) * 0x85EBCA6B & U32_MASK)) & U32_MASK
    h = h ^ (h >> 16)
    h = (h * 0x45D9F3B) & U32_MASK
    h = h ^ (h >> 16)
    return h.to(torch.float32) / 4294967296.0


def lane_op_ids(T: int, K: int, device=None) -> torch.Tensor:
    return torch.arange(T * K, dtype=torch.int64, device=device).view(T, K)


#: #ops in this wave hitting the same (record, group), per op (0 where
#: masked), float32: the plain version of the ``segment_count`` kernel.
cell_counts = segment_count_plain


def first_true_index(flags: torch.Tensor, size: int) -> torch.Tensor:
    """Index of the first True along the last axis (int32), or ``size`` if
    none."""
    idx = torch.arange(size, dtype=torch.int32, device=flags.device)
    return torch.where(flags, idx, size).min(dim=-1).values
