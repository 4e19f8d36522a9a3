"""The multi-version record store: a fixed-depth ring of versions per
record (port of ``repro/core/mvstore.py``).

Each record owns a ring of D version slots:

    mv_begin int32[n_records, D, G]  begin timestamp per slot and group
                                     (uint32 bit patterns)
    mv_head  int32[n_records]        index of the newest slot

A committed write that touches group g publishes ``begin[g] =
install_ts`` in a new slot and carries the other groups' begins forward.
A fine snapshot read of group g takes the newest slot whose ``begin[g]``
fits under its snapshot; a coarse read takes the slot's max over groups
(one timestamp per record), so a group-g update hides the slot from
coarse readers of every group.  Timestamps come from the wave: a wave-w
transaction reads at ``snapshot_ts(w) = w`` and installs at
``install_ts(w) = w + 1``.  Installing into a full ring overwrites the
oldest slot; a snapshot older than every retained slot gets ``ok = False``
from the ``mv_gather`` op and aborts.  Empty slots hold ``MV_EMPTY`` and
are visible to no snapshot.

The ring's values (``mv_vals``, ``install_values``) wait for ROADMAP A.4:
``mv_vals`` is always the [1, 1, 1] placeholder here.
"""
from __future__ import annotations

import torch

#: Begin value of a never-installed ring slot (uint32); its int32 bit
#: pattern is -1.
MV_EMPTY = 0xFFFFFFFF

_U32 = 0xFFFFFFFF


def snapshot_ts(wave, age: int = 0):
    """Snapshot timestamp of a wave-w transaction: installs of waves < w
    are visible.  ``age`` pins the snapshot that many waves further back,
    saturating at 0.  ``wave`` is an int or a 0-d int64 tensor (the run's
    wave, read on its device: the saturation is a clamp there)."""
    w = wave & _U32
    if not age:
        return w
    if isinstance(w, torch.Tensor):
        return torch.clamp(w - int(age), min=0)
    return w - min(w, int(age))


def install_ts(wave):
    """Begin timestamp of versions committed in wave w (uint32); an int or
    a 0-d int64 tensor, as ``wave`` is."""
    return (wave + 1) & _U32


def mv_init(n_records: int, depth: int, n_groups: int, device):
    """Fresh ring tables: slot 0 holds the initial version (begin 0 in every
    group), the other D-1 slots are empty.  Returns (begin, head, vals);
    ``vals`` is the [1, 1, 1] placeholder."""
    begin = torch.full((n_records, depth, n_groups), -1, dtype=torch.int32,
                       device=device)
    begin[:, 0, :] = 0
    head = torch.zeros((n_records,), dtype=torch.int32, device=device)
    return begin, head, mv_placeholder(device)[2]


def mv_placeholder(device):
    """Stand-ins for runs without a ring (mv_depth = 0): (begin [1, 1, 1],
    head [1], vals [1, 1, 1])."""
    return (torch.zeros((1, 1, 1), dtype=torch.int32, device=device),
            torch.zeros((1,), dtype=torch.int32, device=device),
            torch.zeros((1, 1, 1), dtype=torch.float32, device=device))
