"""Claim install + post-install strongest-claimant probe on one claim
table or on two, and the probe alone.

``claim_probe`` replaces the TPU kernel ``claim_probe_fused_pallas``
(src/repro/kernels/claim_probe.py); the semantics are the JAX oracle
``ref.claim_probe_fused``:

  1. min-install the claim word ``(inv_wave << 16) | prio16`` of every
     masked op whose cell lies inside the table;
  2. return, for EVERY op, the strongest live claimant prio16 of the
     post-install table: the op's own cell (fine) or the min over its row
     (coarse), NO_PRIO where unclaimed or where the key is masked.

An out-of-range group probes NO_PRIO on the fine side, where the oracle's
``take_along_axis`` fill reads 0xFFFFFFFF; both mean no claimant, and the
engine never makes such a group.  The table is updated in place; the
wrapper returns ``wprio`` int32[T, K] (values up to 0xFFFF).  With a
second table ``claim_r`` and its mask ``mask_r`` one call does the same on
both tables, on the same keys, groups and priorities, and returns
``(wprio, rprio)``: the JAX package's two ``claim_probe_fused`` calls of
the dual unfused wave.

The verdict form is the sharded owner's claim step (core/distributed.py):
``keys`` is [D, M], one row of ops a source shard, and with the
point-read mask ``is_rp`` (and with two tables the read mask ``is_r``)
the call returns the owner's verdicts packed in the wire format of
kernels/verdict_pack.py, int32[D, ceil(M/16)], in place of the answers.
With two tables it also reads the version ring (``begin`` int32[N, D, G],
the snapshot ``snap_ts``): ``ok`` below is ``mv_gather(begin, keys,
groups, snap_ts, fine)[1]``, the owner's snapshot read on the same ops,
and the ring is taken in this form only:

- one table (OCC): bit 0 = ``is_rp & (wprio < prio)``;
- two tables and the ring (MVCC/MV-OCC; ``mask`` every write, ``mask_r``
  the plain WRITEs): bit 0 = ``(mask_r & (wprio < prio)) | (mask & ~mask_r
  & (rprio < prio)) | (is_r & ~ok)``, bit 1 = ``is_rp & (wprio < prio)``.

Its plain version, ``claim_probe_verdict_plain``, is the chain it
replaces: the plain probes, those compares and ``verdict_pack_plain``.

CUDA tensors launch ``csrc/claim_probe.cu``: one cooperative launch
(the atomicMin installs into one or both tables and the ring reads, a
grid barrier, the probes; the verdict form zeroes its words before the
barrier and ORs each op's field in after it); CPU tensors take
``claim_probe_plain``, once per table (and the verdict form
``claim_probe_verdict_plain``).

``probe`` (the backend op ``probe``) replaces the TPU kernel
``claim_probe_pallas`` (src/repro/kernels/occ_validate.py); its semantics
are step 2 alone, the JAX oracle ``ref.claim_probe``, on a table it does
not change.  CUDA tensors launch the same source's probe launch alone
(``repro_probe``, one thread per op); CPU tensors take ``probe_plain``.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.core.claimword import claim_word, inv_wave
from repro_torch.kernels import build
from repro_torch.kernels.mv_gather import mv_gather_plain
from repro_torch.kernels.scatter import scatter_u32
from repro_torch.kernels.verdict_pack import n_words, verdict_pack_plain
from repro_torch.kernels.wave_commit import probe_plain

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIG = {"repro_claim_probe_coop": [_P] * 15 + [_I] * 7 + [_P],
        "repro_probe": [_P] * 5 + [_I] * 4 + [_P]}


def claim_probe_plain(table: torch.Tensor, keys: torch.Tensor,
                      groups: torch.Tensor, prio: torch.Tensor, wave,
                      mask: torch.Tensor, fine: bool) -> torch.Tensor:
    scatter_u32(table, keys, groups, claim_word(wave, prio), mask, "amin")
    return probe_plain(table, keys, groups, inv_wave(wave),
                       fine).to(torch.int32)


def claim_probe_verdict_plain(table, keys, groups, prio, wave, mask, fine,
                              claim_r, mask_r, begin, snap_ts, is_r, is_rp
                              ) -> torch.Tensor:
    """The verdict form's chain in plain ops: the probes (and the ring's
    ok), the owner's verdict bits, ``verdict_pack_plain``."""
    wprio = claim_probe_plain(table, keys, groups, prio, wave, mask, fine)
    if claim_r is None:
        return verdict_pack_plain((is_rp & (wprio < prio)).to(torch.int8))
    rprio = claim_probe_plain(claim_r, keys, groups, prio, wave, mask_r,
                              fine)
    ok = mv_gather_plain(begin, keys, groups, snap_ts, fine)[1]
    uncond = ((mask_r & (wprio < prio)) | (mask & ~mask_r & (rprio < prio))
              | (is_r & ~ok))
    rdval = is_rp & (wprio < prio)
    return verdict_pack_plain(uncond.to(torch.int8)
                              | (rdval.to(torch.int8) << 1))


def claim_probe(table: torch.Tensor, keys: torch.Tensor,
                groups: torch.Tensor, prio: torch.Tensor, wave,
                mask: torch.Tensor, fine: bool, *,
                claim_r: Optional[torch.Tensor] = None,
                mask_r: Optional[torch.Tensor] = None,
                begin: Optional[torch.Tensor] = None,
                snap_ts=None,
                is_r: Optional[torch.Tensor] = None,
                is_rp: Optional[torch.Tensor] = None):
    """Install the masked ops' claims in place; returns wprio int32[T, K],
    or with ``claim_r`` and ``mask_r`` (wprio, rprio), one per table.
    With ``is_rp`` (one table) or ``is_r``, ``is_rp`` and the ring
    ``begin``, ``snap_ts`` (two tables) it returns the packed verdict
    words int32[D, ceil(M/16)] of keys [D, M] instead.  ``wave`` and
    ``snap_ts`` are 0-d int64 tensors (or ints); the kernel reads them on
    the device."""
    claim_probe.calls += 1
    if (claim_r is None) != (mask_r is None):
        raise ValueError("claim_probe: claim_r and mask_r come together")
    ring = begin is not None
    verdict = is_rp is not None
    if ring != (snap_ts is not None) or (ring and (claim_r is None
                                                   or not verdict)):
        raise ValueError("claim_probe: begin and snap_ts come together, "
                         "with claim_r, mask_r and the verdict form's is_r "
                         "and is_rp")
    if verdict and ((is_r is not None) != ring
                    or (claim_r is not None) != ring):
        raise ValueError("claim_probe: the verdict form takes is_rp on one "
                         "table, is_r and is_rp on two tables with the ring")
    if (is_r is not None and not verdict) or (verdict and keys.dim() != 2):
        raise ValueError("claim_probe: the verdict form takes is_rp and "
                         "keys [D, M]")
    if verdict and keys.device.type == "cpu":
        return claim_probe_verdict_plain(table, keys, groups, prio, wave,
                                         mask, fine, claim_r, mask_r, begin,
                                         snap_ts, is_r, is_rp)
    if keys.device.type == "cpu":
        wprio = claim_probe_plain(table, keys, groups, prio, wave, mask,
                                  fine)
        if claim_r is None:
            return wprio
        return wprio, claim_probe_plain(claim_r, keys, groups, prio, wave,
                                        mask_r, fine)
    dev = build.launch_device(keys)
    N, G = table.shape
    shape = tuple(keys.shape)
    build.check("table", table, torch.int32, (N, G), dev)
    build.check("keys", keys, torch.int32, shape, dev)
    build.check("groups", groups, torch.int32, shape, dev)
    build.check("prio", prio, torch.int32, shape, dev)
    build.check("mask", mask, torch.bool, shape, dev)
    out = out_r = words = None
    D = row = W = 0
    if claim_r is not None:
        build.check("claim_r", claim_r, torch.int32, (N, G), dev)
        build.check("mask_r", mask_r, torch.bool, shape, dev)
    if ring:
        _, D, _ = begin.shape
        build.check("begin", begin, torch.int32, (N, D, G), dev)
    if verdict:
        build.check("is_rp", is_rp, torch.bool, shape, dev)
        if ring:
            build.check("is_r", is_r, torch.bool, shape, dev)
        row, W = shape[1], n_words(shape[1])
        words = torch.empty((shape[0], W), dtype=torch.int32, device=dev)
    else:
        out = torch.empty(shape, dtype=torch.int32, device=dev)
        if claim_r is not None:
            out_r = torch.empty(shape, dtype=torch.int32, device=dev)
    w = build.scalar("wave", wave, dev)
    ts = build.scalar("snap_ts", snap_ts, dev) if ring else None
    lib = build.load("claim_probe", _SIG)
    with torch.cuda.device(dev):
        rc = lib.repro_claim_probe_coop(
            build.ptr(table), build.ptr(claim_r), build.ptr(keys),
            build.ptr(groups), build.ptr(prio), build.ptr(mask),
            build.ptr(mask_r), build.ptr(out), build.ptr(out_r),
            build.ptr(begin), build.ptr(is_r), build.ptr(is_rp),
            build.ptr(words), build.ptr(w), build.ptr(ts), keys.numel(), N,
            G, D, row, W, int(bool(fine)), build.stream(dev))
    build.raise_on_error("claim_probe", rc)
    claim_probe.launches += 1
    if verdict:
        return words
    if claim_r is None:
        return out
    return out, out_r


claim_probe.launches = 0
claim_probe.calls = 0


def probe(table: torch.Tensor, keys: torch.Tensor, groups: torch.Tensor,
          wave, fine: bool) -> torch.Tensor:
    """Strongest live claimant prio16 per op of ``table`` at ``wave``:
    int32[T, K], NO_PRIO where unclaimed or where the key is masked."""
    probe.calls += 1
    if keys.device.type == "cpu":
        return probe_plain(table, keys, groups, inv_wave(wave),
                           fine).to(torch.int32)
    dev = build.launch_device(keys)
    N, G = table.shape
    shape = tuple(keys.shape)
    build.check("table", table, torch.int32, (N, G), dev)
    build.check("keys", keys, torch.int32, shape, dev)
    build.check("groups", groups, torch.int32, shape, dev)
    out = torch.empty(shape, dtype=torch.int32, device=dev)
    w = build.scalar("wave", wave, dev)
    lib = build.load("claim_probe", _SIG)
    with torch.cuda.device(dev):
        rc = lib.repro_probe(
            build.ptr(table), build.ptr(keys), build.ptr(groups),
            build.ptr(out), build.ptr(w), keys.numel(), N, G, int(fine),
            build.stream(dev))
    build.raise_on_error("probe", rc)
    probe.launches += 1
    return out


probe.launches = 0
probe.calls = 0
