"""The sharded wave's verdict wire format: 2 bits per op, 16 ops a word.

Replaces the TPU kernels ``verdict_pack_pallas`` and
``verdict_unpack_pallas`` (src/repro/kernels/verdict_pack.py); the
semantics are the JAX oracles ``ref.verdict_pack`` / ``ref.verdict_unpack``:

- ``verdict_pack(v int8[D, M]) -> int32[D, ceil(M/16)]``: op j's low two
  bits land at bits ``2*(j % 16)`` and ``2*(j % 16) + 1`` of word
  ``j // 16``; the last word's unused fields are zero.
- ``verdict_unpack(words int32[D, W], n) -> int8[D, n]``: the inverse, the
  two bits of each op in the low bits of its byte (``W * 16 >= n``).

Words are uint32 bit patterns in int32 tensors (bit 31 set makes a word
negative); the plain versions widen to int64 before shifting.  CUDA
tensors launch ``csrc/verdict_pack.cu`` (one thread per output word or
byte); CPU tensors take the plain versions.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.claimword import to_i32, u32
from repro_torch.kernels import build

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIG = {"repro_verdict_pack": [_P] * 2 + [_I] * 3 + [_P],
        "repro_verdict_unpack": [_P] * 2 + [_I] * 3 + [_P]}


def n_words(n_ops: int) -> int:
    """int32 words per row of ``n_ops`` verdicts."""
    return -(-n_ops // 16)


def verdict_pack_plain(v: torch.Tensor) -> torch.Tensor:
    D, M = v.shape
    W = n_words(M)
    vv = v.to(torch.int64) & 3
    vv = torch.nn.functional.pad(vv, (0, W * 16 - M)).view(D, W, 16)
    shifts = 2 * torch.arange(16, dtype=torch.int64, device=v.device)
    # Disjoint fields: the sum is the OR of the shifted ops.
    return to_i32((vv << shifts).sum(dim=-1))


def verdict_unpack_plain(words: torch.Tensor, n: int) -> torch.Tensor:
    j = torch.arange(n, dtype=torch.int64, device=words.device)
    w = u32(words)[:, j // 16]
    return ((w >> (2 * (j % 16))) & 3).to(torch.int8)


def verdict_pack(v: torch.Tensor) -> torch.Tensor:
    """int8[D, M] verdict bytes -> int32[D, ceil(M/16)] wire words."""
    verdict_pack.calls += 1
    if v.device.type == "cpu":
        return verdict_pack_plain(v)
    dev = build.launch_device(v)
    D, M = v.shape
    W = n_words(M)
    build.check("v", v, torch.int8, (D, M), dev)
    words = torch.empty((D, W), dtype=torch.int32, device=dev)
    lib = build.load("verdict_pack", _SIG)
    with torch.cuda.device(dev):
        rc = lib.repro_verdict_pack(build.ptr(v), build.ptr(words), D, M, W,
                                    build.stream(dev))
    build.raise_on_error("verdict_pack", rc)
    verdict_pack.launches += 1
    return words


def verdict_unpack(words: torch.Tensor, n: int) -> torch.Tensor:
    """int32[D, W] wire words -> int8[D, n] verdict bytes."""
    verdict_unpack.calls += 1
    D, W = words.shape
    if W * 16 < n:
        raise ValueError(f"verdict_unpack: {W} words per row hold "
                         f"{W * 16} ops, fewer than n={n}")
    if words.device.type == "cpu":
        return verdict_unpack_plain(words, n)
    dev = build.launch_device(words)
    build.check("words", words, torch.int32, (D, W), dev)
    out = torch.empty((D, n), dtype=torch.int8, device=dev)
    lib = build.load("verdict_pack", _SIG)
    with torch.cuda.device(dev):
        rc = lib.repro_verdict_unpack(build.ptr(words), build.ptr(out), D, W,
                                      n, build.stream(dev))
    build.raise_on_error("verdict_unpack", rc)
    verdict_unpack.launches += 1
    return out


verdict_pack.launches = 0
verdict_pack.calls = 0
verdict_unpack.launches = 0
verdict_unpack.calls = 0
