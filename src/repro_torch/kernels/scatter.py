"""Row gathers and unsigned scatters shared by the plain kernel versions.

The JAX oracles use ``mode="drop"``/``mode="fill"`` with an out-of-bounds
key; torch raises on out-of-range indices and wraps negative ones, so the
plain versions mask explicitly: an op whose key lies outside ``[0, N)``
(or whose group lies outside ``[0, G)`` where one cell is addressed)
installs nothing and reads the fill value.  Table words are uint32 bit
patterns in int32 tensors, widened to int64 for arithmetic.  Duplicate
cells are combined before the write, so every write to a cell carries its
final value.
"""
from __future__ import annotations

import torch

from repro_torch.core.claimword import to_i32, u32


def gather_rows(table: torch.Tensor, keys: torch.Tensor):
    """(rows int64[..., G] as unsigned values, valid bool[...]); rows of
    invalid keys read row 0 and must be masked by the caller."""
    N = table.shape[0]
    valid = (keys >= 0) & (keys < N)
    k = torch.where(valid, keys, 0).to(torch.int64)
    return u32(table[k]), valid


def pick_group(rows: torch.Tensor, groups: torch.Tensor, fill: int):
    """rows[..., group] per op, ``fill`` where the group is out of range."""
    G = rows.shape[-1]
    gv = (groups >= 0) & (groups < G)
    g = torch.where(gv, groups, 0).to(torch.int64)
    v = rows.gather(-1, g.unsqueeze(-1)).squeeze(-1)
    return torch.where(gv, v, fill)


def scatter_u32(table: torch.Tensor, keys: torch.Tensor,
                groups: torch.Tensor, vals: torch.Tensor, mask: torch.Tensor,
                reduce: str, whole_row: bool = False) -> torch.Tensor:
    """In place: table[key, group] = reduce(table[key, group], vals) over the
    masked ops, with uint32 semantics.  ``reduce`` is "amin", "amax" or
    "sum" (wrapping add); ``whole_row`` applies each op to every group of
    its record.  Returns ``table``."""
    N, G = table.shape
    ok = mask & (keys >= 0) & (keys < N)
    if not whole_row:
        ok = ok & (groups >= 0) & (groups < G)
    k = keys[ok].to(torch.int64)
    v = vals[ok].to(torch.int64)
    if whole_row:
        cells = (k[:, None] * G
                 + torch.arange(G, device=k.device)[None, :]).reshape(-1)
        v = v.repeat_interleave(G)
    else:
        cells = k * G + groups[ok].to(torch.int64)
    if cells.numel() == 0:
        return table
    uniq, inv = torch.unique(cells, return_inverse=True)
    flat = table.view(-1)
    old = u32(flat[uniq])
    if reduce == "sum":
        agg = torch.zeros_like(old).index_add_(0, inv, v)
        new = old + agg
    else:
        agg = torch.zeros_like(old).scatter_reduce_(0, inv, v, reduce,
                                                    include_self=False)
        new = torch.minimum(old, agg) if reduce == "amin" else \
            torch.maximum(old, agg)
    flat[uniq] = to_i32(new)
    return table
