"""The probe-family wave: claim install + probe + lane verdicts + bumps.

Replaces the TPU kernel ``wave_commit_pallas``
(src/repro/kernels/wave_commit.py); the semantics are the JAX oracle
``ref.wave_commit``:

  1. min-install the claim word ``(inv_wave << 16) | prio16`` of every
     ``do_w`` op into ``claim_w`` (and of every ``do_r`` op into
     ``claim_r`` when ``dual``);
  2. probe the post-install tables: the strongest live claimant prio16 of
     the op's cell (fine) or row (coarse), NO_PRIO when unclaimed/masked;
  3. conflict = check_w  & (wprio < prio)
              | check_w2 & (wprio != NO_PRIO) & (wprio != prio)
              | check_r  & (rprio < prio)                   (dual only)
              | extra
     (``check_w2``/``check_r``/``extra`` may be None);
  4. commit = ~conflict.any(lane);
  5. ``bump``: +1 on ``wts`` per committed ``do_w`` op.

The tables are updated in place; the wrapper returns ``(conflict bool[T, K],
commit bool[T])``.  With ``pack=True`` it returns ``(words int32[T,
ceil(K/16)], commit)`` instead: each lane's conflicts packed in the
sharded wave's verdict wire format (kernels/verdict_pack.py), op k's
conflict at bit ``2*(k % 16)`` of word ``k // 16`` and the other bits 0;
the sharded owner calls it so, with one row of ops a source shard, and
the conflict bytes never reach global memory.  CUDA tensors launch
``csrc/wave_commit.cu``: one
cooperative launch whose blocks atomicMin-install, meet at a grid barrier,
then probe, reduce each lane's verdict and bump (a lane wider than 1,024
ops spread over several blocks, with a second barrier before its bumps);
CPU tensors take ``wave_commit_plain``.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.core.claimword import NO_PRIO, claim_word, inv_wave, \
    live_prio, u32
from repro_torch.kernels import build
from repro_torch.kernels.scatter import gather_rows, pick_group, scatter_u32
from repro_torch.kernels.verdict_pack import n_words, verdict_pack_plain

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIG = {"repro_wave_commit": [_P] * 16 + [_I] * 7 + [_P]}


def probe_plain(table: torch.Tensor, keys: torch.Tensor,
                groups: torch.Tensor, ivw, fine: bool) -> torch.Tensor:
    """Strongest live claimant prio16 per op (int64), NO_PRIO when
    unclaimed or masked (the JAX oracle ``ref.claim_probe``)."""
    rows, valid = gather_rows(table, keys)
    pr = live_prio(rows, ivw)
    wp = pick_group(pr, groups, NO_PRIO) if fine else pr.amin(dim=-1)
    return torch.where(valid, wp, NO_PRIO)


def wave_commit_plain(claim_w, claim_r, wts, keys, groups, prio, do_w, do_r,
                      check_w, check_w2, check_r, extra, wave,
                      fine: bool, dual: bool, bump: bool, pack: bool = False):
    """Plain PyTorch version of the kernel (see the module docstring);
    ``pack`` packs the conflicts as ``verdict_pack`` does."""
    ivw = inv_wave(wave)
    words = claim_word(wave, prio)
    p = u32(prio)
    scatter_u32(claim_w, keys, groups, words, do_w, "amin")
    wprio = probe_plain(claim_w, keys, groups, ivw, fine)
    conflict = check_w & (wprio < p)
    if check_w2 is not None:
        conflict = conflict | (check_w2 & (wprio != NO_PRIO) & (wprio != p))
    if dual:
        scatter_u32(claim_r, keys, groups, words, do_r, "amin")
        if check_r is not None:
            rprio = probe_plain(claim_r, keys, groups, ivw, fine)
            conflict = conflict | (check_r & (rprio < p))
    if extra is not None:
        conflict = conflict | extra
    commit = ~conflict.any(dim=1)
    if bump:
        scatter_u32(wts, keys, groups, torch.ones_like(p),
                    do_w & commit[:, None], "sum")
    if pack:
        return verdict_pack_plain(conflict.to(torch.int8)), commit
    return conflict, commit


def wave_commit(claim_w: torch.Tensor, claim_r: Optional[torch.Tensor],
                wts: Optional[torch.Tensor], keys: torch.Tensor,
                groups: torch.Tensor, prio: torch.Tensor,
                do_w: torch.Tensor, do_r: Optional[torch.Tensor],
                check_w: torch.Tensor, check_w2: Optional[torch.Tensor],
                check_r: Optional[torch.Tensor],
                extra: Optional[torch.Tensor], wave, fine: bool,
                dual: bool, bump: bool, *, pack: bool = False):
    """The fused probe-family wave; returns (conflict, commit), or with
    ``pack`` (verdict words, commit), and updates ``claim_w`` (``claim_r``
    when dual, ``wts`` when bump) in place.  ``wave`` is the run's 0-d
    int64 tensor (or an int), which the kernel reads on the device."""
    wave_commit.calls += 1
    if keys.device.type == "cpu":
        return wave_commit_plain(claim_w, claim_r, wts, keys, groups, prio,
                                 do_w, do_r, check_w, check_w2, check_r,
                                 extra, wave, fine, dual, bump, pack)
    dev = build.launch_device(keys)
    T, K = keys.shape
    N, G = claim_w.shape
    build.check("claim_w", claim_w, torch.int32, (N, G), dev)
    if dual:
        build.check("claim_r", claim_r, torch.int32, (N, G), dev)
        build.check("do_r", do_r, torch.bool, (T, K), dev)
    if bump:
        build.check("wts", wts, torch.int32, (N, G), dev)
    build.check("keys", keys, torch.int32, (T, K), dev)
    build.check("groups", groups, torch.int32, (T, K), dev)
    build.check("prio", prio, torch.int32, (T, K), dev)
    build.check("do_w", do_w, torch.bool, (T, K), dev)
    build.check("check_w", check_w, torch.bool, (T, K), dev)
    for name, m in (("check_w2", check_w2), ("check_r", check_r),
                    ("extra", extra)):
        if m is not None:
            build.check(name, m, torch.bool, (T, K), dev)
    conflict = words = None
    if pack:
        words = torch.empty((T, n_words(K)), dtype=torch.int32, device=dev)
    else:
        conflict = torch.empty((T, K), dtype=torch.bool, device=dev)
    commit = torch.empty((T,), dtype=torch.bool, device=dev)
    w = build.scalar("wave", wave, dev)
    lib = build.load("wave_commit", _SIG)
    with torch.cuda.device(dev):
        rc = lib.repro_wave_commit(
            build.ptr(claim_w), build.ptr(claim_r if dual else None),
            build.ptr(wts if bump else None), build.ptr(keys),
            build.ptr(groups), build.ptr(prio), build.ptr(do_w),
            build.ptr(do_r if dual else None), build.ptr(check_w),
            build.ptr(check_w2), build.ptr(check_r if dual else None),
            build.ptr(extra), build.ptr(conflict), build.ptr(words),
            build.ptr(commit), build.ptr(w), T, K, N, G, int(fine),
            int(dual), int(bump), build.stream(dev))
    build.raise_on_error("wave_commit", rc)
    wave_commit.launches += 1
    return (words if pack else conflict), commit


wave_commit.launches = 0
wave_commit.calls = 0
