"""Claim install + post-install strongest-claimant probe on one table.

Replaces the TPU kernel ``claim_probe_fused_pallas``
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
wrapper returns ``wprio`` int32[T, K] (values up to 0xFFFF).

CUDA tensors launch ``csrc/claim_probe.cu`` (an atomicMin install launch,
then a probe launch); CPU tensors take ``claim_probe_plain``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.claimword import claim_word, inv_wave
from repro_torch.kernels import build
from repro_torch.kernels.scatter import scatter_u32
from repro_torch.kernels.wave_commit import probe_plain

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIG = {"repro_claim_probe": [_P] * 6 + [_I] * 5 + [_P]}


def claim_probe_plain(table: torch.Tensor, keys: torch.Tensor,
                      groups: torch.Tensor, prio: torch.Tensor, wave: int,
                      mask: torch.Tensor, fine: bool) -> torch.Tensor:
    scatter_u32(table, keys, groups, claim_word(wave, prio), mask, "amin")
    return probe_plain(table, keys, groups, inv_wave(wave),
                       fine).to(torch.int32)


def claim_probe(table: torch.Tensor, keys: torch.Tensor,
                groups: torch.Tensor, prio: torch.Tensor, wave: int,
                mask: torch.Tensor, fine: bool) -> torch.Tensor:
    """Install the masked ops' claims in place; returns wprio int32[T, K]."""
    claim_probe.calls += 1
    if keys.device.type == "cpu":
        return claim_probe_plain(table, keys, groups, prio, wave, mask, fine)
    dev = build.launch_device(keys)
    N, G = table.shape
    shape = tuple(keys.shape)
    build.check("table", table, torch.int32, (N, G), dev)
    build.check("keys", keys, torch.int32, shape, dev)
    build.check("groups", groups, torch.int32, shape, dev)
    build.check("prio", prio, torch.int32, shape, dev)
    build.check("mask", mask, torch.bool, shape, dev)
    out = torch.empty(shape, dtype=torch.int32, device=dev)
    lib = build.load("claim_probe", _SIG)
    with torch.cuda.device(dev):
        rc = lib.repro_claim_probe(
            build.ptr(table), build.ptr(keys), build.ptr(groups),
            build.ptr(prio), build.ptr(mask), build.ptr(out), keys.numel(),
            N, G, inv_wave(wave), int(fine), build.stream(dev))
    build.raise_on_error("claim_probe", rc)
    claim_probe.launches += 1
    return out


claim_probe.launches = 0
claim_probe.calls = 0
