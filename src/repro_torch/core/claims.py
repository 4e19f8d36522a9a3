"""Wave-scoped claim helpers (the port of ``repro/core/claims.py``).

Claim tables are reset-free thanks to the monotone wave tag of
``core/claimword.py``; installing and probing them is the job of the
backend ops (``core/backend.py``).  What stays here is the per-wave
arithmetic the mechanisms share: priorities, the stateless hash behind the
overlap thinning, same-cell counts, first-conflict indices and the lazily
decayed per-record heats of Adaptive and AutoGran.  uint32 arithmetic is
done in int64 and masked to 32 bits.  ``wave`` is the run's 0-d int64
tensor (an int gives the same values): nothing here reads it on the host,
and the heat updates are fixed-shape scatters into the tables' sink slot
(``core/types.SINK``), so no helper makes the host wait for the card.
"""
from __future__ import annotations

import torch

from repro_torch.core.claimword import U32_MASK
from repro_torch.core.types import PRIO_LANE_BITS, SINK
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


def hash01(wave, lane_op_ids: torch.Tensor) -> torch.Tensor:
    """Deterministic per-(wave, lane, op) uniform float32 in [0, 1).

    The JAX version multiplies uint32s with wraparound; here the products
    run in int64, where the first may wrap past 2**63 — its low 32 bits,
    the only ones kept, survive the wrap."""
    h = ((lane_op_ids.to(torch.int64) & U32_MASK) * 0x9E3779B9
         + ((wave & U32_MASK) * 0x85EBCA6B & U32_MASK)) & U32_MASK
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
    return torch.where(flags, idx, size).amin(dim=-1)


def record_index(keys: torch.Tensor, n: int):
    """(index int64, valid bool) for per-record gathers and scatters:
    keys outside [0, n) are masked (torch wraps negative indices and
    raises on large ones, where the JAX package fills or drops)."""
    valid = (keys >= 0) & (keys < n)
    return torch.where(valid, keys, 0).to(torch.int64), valid


def lazy_decayed(heat: torch.Tensor, heat_wave: torch.Tensor,
                 keys: torch.Tensor, wave, decay: float) -> torch.Tensor:
    """heat[keys] with the decay of the waves since its last touch applied,
    heat * decay ** (wave - heat_wave), in float32; 0 for masked keys.
    The tables carry the sink slot (``SINK``), which no key reads."""
    k, valid = record_index(keys, heat.shape[0] - SINK)
    h = torch.where(valid, heat[k], 0.0)
    lw = torch.where(valid, heat_wave[k], 0)
    dt = torch.clamp(wave - lw, min=0).to(torch.float32)
    return h * torch.full_like(dt, decay).pow(dt)


def touch_heat(heat: torch.Tensor, heat_wave: torch.Tensor,
               keys: torch.Tensor, add: torch.Tensor, wave,
               decay: float, mask: torch.Tensor) -> None:
    """In place, for the masked ops' records: heat = decayed heat + the
    sum of the ops' ``add``, heat_wave = wave.

    As in the JAX package, the decayed base is set first (duplicate keys
    write the same value) and the adds accumulate on it; adds of equal
    values give the same float32 sums in any order.  Every op takes part
    in each scatter, so no shape depends on the mask: a masked op (or a
    key outside the records) writes 0 into the sink slot past the last
    record, which keeps it from racing an unmasked duplicate of its key,
    as a write of the record's own value would.  The adds are atomic
    (``index_add_``): ``index_put_``'s accumulating form sorts the
    indices and walks each run of equal ones in one thread, and the
    sink's run is most of the wave."""
    n = heat.shape[0] - SINK
    k, valid = record_index(keys, n)
    ok = mask & valid
    idx = torch.where(ok, k, n).reshape(-1)
    decayed = lazy_decayed(heat, heat_wave, keys, wave, decay)
    heat.index_put_((idx,), torch.where(ok, decayed, 0.0).reshape(-1))
    heat.index_add_(0, idx, torch.where(ok, add.to(heat.dtype),
                                        0.0).reshape(-1))
    heat_wave.index_put_((idx,), torch.where(ok, wave, 0).to(
        heat_wave.dtype).reshape(-1))


def sink_scatter(table: torch.Tensor, keys: torch.Tensor,
                 values: torch.Tensor, mask: torch.Tensor) -> None:
    """In place, ``table[keys] = values`` at the masked ops, as a
    fixed-shape scatter: the other ops (and keys outside the records)
    write 0 into the sink slot.  Duplicate masked keys must carry the same
    value (the write order is unspecified)."""
    n = table.shape[0] - SINK
    k, valid = record_index(keys, n)
    ok = mask & valid
    table.index_put_((torch.where(ok, k, n).reshape(-1),),
                     torch.where(ok, values, 0).to(table.dtype).reshape(-1))
