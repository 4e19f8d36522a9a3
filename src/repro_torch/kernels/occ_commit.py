"""Commit install: +1 version bump per committed write op.

Replaces the TPU kernel ``occ_commit_pallas``
(src/repro/kernels/occ_commit.py); the semantics are the JAX oracle
``ref.occ_commit``: for every op with ``do`` set and a cell inside the
table, ``wts[key, group] += 1`` with uint32 wraparound.  ``wts`` is
updated in place.

CUDA tensors launch ``csrc/occ_commit.cu`` (one thread per op,
``atomicAdd``); CPU tensors take ``commit_install_plain``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.scatter import scatter_u32

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIG = {"repro_commit_install": [_P] * 4 + [_I] * 3 + [_P]}


def commit_install_plain(wts: torch.Tensor, keys: torch.Tensor,
                         groups: torch.Tensor, do: torch.Tensor) -> None:
    scatter_u32(wts, keys, groups, torch.ones_like(keys), do, "sum")


def commit_install(wts: torch.Tensor, keys: torch.Tensor,
                   groups: torch.Tensor, do: torch.Tensor) -> None:
    """In-place +1 on ``wts`` per ``do`` op."""
    commit_install.calls += 1
    if keys.device.type == "cpu":
        return commit_install_plain(wts, keys, groups, do)
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
            keys.numel(), N, G, build.stream(dev))
    build.raise_on_error("commit_install", rc)
    commit_install.launches += 1


commit_install.launches = 0
commit_install.calls = 0
