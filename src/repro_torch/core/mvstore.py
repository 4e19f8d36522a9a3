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

With tracked values (``EngineConfig.track_values``) the ring also holds
each version's values, ``mv_vals`` f32[n_records, D, n_cols]:
``install_values`` materializes the wave's new slots and
``snapshot_values`` reads a snapshot's value through the ``mv_gather``
op.  Without them ``mv_vals`` is the [1, 1, 1] placeholder.
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


def mv_init(n_records: int, depth: int, n_groups: int, device,
            n_cols: int = 0, values=None):
    """Fresh ring tables: slot 0 holds the initial version (begin 0 in every
    group), the other D-1 slots are empty.  Returns (begin, head, vals);
    ``vals`` is f32[n_records, D, n_cols] when ``n_cols > 0``, slot 0
    holding ``values`` (zeros when None), else the [1, 1, 1]
    placeholder."""
    begin = torch.full((n_records, depth, n_groups), -1, dtype=torch.int32,
                       device=device)
    begin[:, 0, :] = 0
    head = torch.zeros((n_records,), dtype=torch.int32, device=device)
    if n_cols <= 0:
        return begin, head, mv_placeholder(device)[2]
    vals = torch.zeros((n_records, depth, n_cols), dtype=torch.float32,
                       device=device)
    if values is not None:
        vals[:, 0, :] = values
    return begin, head, vals


def mv_placeholder(device):
    """Stand-ins for runs without a ring (mv_depth = 0): (begin [1, 1, 1],
    head [1], vals [1, 1, 1])."""
    return (torch.zeros((1, 1, 1), dtype=torch.int32, device=device),
            torch.zeros((1,), dtype=torch.int32, device=device),
            torch.zeros((1, 1, 1), dtype=torch.float32, device=device))


def install_values(vals: torch.Tensor, head_old: torch.Tensor,
                   head_new: torch.Tensor, batch, commit: torch.Tensor,
                   prio: torch.Tensor) -> torch.Tensor:
    """Materialize the wave's new ring slots (tracked values), in place.

    Two steps, as the begin-table install of ``mv_install``: every slot
    the wave installed is first copied from its record's previous newest
    slot, all columns (the unwritten columns carry forward), then the
    committed writes are replayed into the new slots in serial order.
    Both are one call of the ``apply_values`` op (``slot_of=head_new``,
    ``head_old=head_old``), the one definition of the serial replay: on
    the card one launch that copies each record's row before replaying
    its writes.  ``head_old`` is the ring's heads before the wave's
    ``mv_install`` (which updates ``mv_head`` in place), ``head_new``
    after it.  Every writer of a row copies the same bytes, so the copy
    is deterministic on every device."""
    from repro_torch.core import backend as kb
    return kb.BACKEND.apply_values(vals, batch, commit, prio,
                                   slot_of=head_new, head_old=head_old)


def snapshot_values(vals: torch.Tensor, begin: torch.Tensor,
                    keys: torch.Tensor, groups: torch.Tensor,
                    cols: torch.Tensor, ts, fine: bool):
    """Snapshot value read (tests and demos): ``(value f32, ok bool)`` per
    op, through the ``mv_gather`` op's slot select.  ``ok`` is False where
    the snapshot's version was reclaimed or the op is masked (key outside
    ``[0, n_records)``), and the value is then 0."""
    from repro_torch.core import backend as kb
    from repro_torch.core.claims import record_index
    N, D, C = vals.shape
    slot, ok = kb.BACKEND.mv_gather(begin, keys, groups, ts, fine)
    k, valid = record_index(keys, N)
    c, cvalid = record_index(cols, C)
    v = vals.view(-1).index_select(
        0, ((k * D + slot.to(torch.int64)) * C + c).reshape(-1))
    return torch.where(ok & valid & cvalid, v.view(keys.shape), 0.0), ok
