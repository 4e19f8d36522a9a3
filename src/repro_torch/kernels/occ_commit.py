"""Commit install: +1 version bump per committed write op.

Replaces the TPU kernel ``occ_commit_pallas``
(src/repro/kernels/occ_commit.py); the semantics are the JAX oracle
``ref.occ_commit``: for every op with ``do`` set and a cell inside the
table, ``wts[key, group] += 1`` with uint32 wraparound.  ``wts`` is
updated in place.

With ``words`` (int32[D, ceil(M/16)] in the wire format of
kernels/verdict_pack.py, for keys [D, M]) an op bumps only where ``do``
is set AND its 2-bit field is non-zero: the sharded owner's install,
which passes the arrived commit words and its write mask, so the
owner's ``verdict_unpack``, compare and mask run inside this launch.
The plain version of that form is that chain: ``verdict_unpack_plain``,
``> 0``, ``&``, then ``commit_install_plain``.

CUDA tensors launch ``csrc/occ_commit.cu`` (one thread per op,
``atomicAdd``); CPU tensors take ``commit_install_plain``.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.scatter import scatter_u32
from repro_torch.kernels.verdict_pack import check_words, \
    verdict_unpack_plain

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIG = {"repro_commit_install": [_P] * 5 + [_I] * 5 + [_P]}


def commit_install_plain(wts: torch.Tensor, keys: torch.Tensor,
                         groups: torch.Tensor, do: torch.Tensor,
                         words: Optional[torch.Tensor] = None) -> None:
    if words is not None:
        do = do & (verdict_unpack_plain(words, keys.shape[1]) > 0)
    scatter_u32(wts, keys, groups, torch.ones_like(keys), do, "sum")


def commit_install(wts: torch.Tensor, keys: torch.Tensor,
                   groups: torch.Tensor, do: torch.Tensor, *,
                   words: Optional[torch.Tensor] = None) -> None:
    """In-place +1 on ``wts`` per ``do`` op (with ``words``, per ``do``
    op whose packed field is non-zero)."""
    commit_install.calls += 1
    row, W = check_words("commit_install", words, keys)
    if keys.device.type == "cpu":
        return commit_install_plain(wts, keys, groups, do, words)
    dev = build.launch_device(keys)
    N, G = wts.shape
    shape = tuple(keys.shape)
    build.check("wts", wts, torch.int32, (N, G), dev)
    build.check("keys", keys, torch.int32, shape, dev)
    build.check("groups", groups, torch.int32, shape, dev)
    build.check("do", do, torch.bool, shape, dev)
    lib = build.load("occ_commit", _SIG)
    with torch.cuda.device(dev):
        rc = lib.repro_commit_install(
            build.ptr(wts), build.ptr(keys), build.ptr(groups), build.ptr(do),
            build.ptr(words), keys.numel(), N, G, row, W, build.stream(dev))
    build.raise_on_error("commit_install", rc)
    commit_install.launches += 1


commit_install.launches = 0
commit_install.calls = 0
