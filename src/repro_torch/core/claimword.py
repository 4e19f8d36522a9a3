"""The packed claim-word layout (a copy of ``repro/core/claimword.py``).

A claim table cell is one 32-bit word:

    word = (inv_wave << WAVE_SHIFT) | prio16
    inv_wave = MAX_WAVE - (wave & MAX_WAVE)      (monotone decreasing)
    prio16   = (inv_age << PRIO_LANE_BITS) | lane_rank   (lower wins)

Tables hold the uint32 bit pattern in ``torch.int32`` tensors (PyTorch's
uint32 lacks shifts, compares and scatters on the CPU).  The plain
versions widen words to int64 with ``u32`` before any arithmetic and
narrow them back with ``to_i32``; the CUDA kernels read the same bytes as
``unsigned int``.  The wave number is a 0-d int64 tensor on the run's
device (``EngineState.wave``), so ``inv_wave`` and ``claim_word`` compute
on it there; a Python int (the kernel cases and the tests) gives the same
values as plain arithmetic.
"""
from __future__ import annotations

import functools

import torch

WAVE_SHIFT = 16                 # wave tag occupies the high 16 bits
MAX_WAVE = 0xFFFF
PRIO16_MASK = 0xFFFF
NO_PRIO = 0xFFFF                # probe result when nobody claims
EMPTY_WORD = 0xFFFFFFFF         # fill value for absent/masked cells
U32_MASK = 0xFFFFFFFF


def inv_wave(wave):
    """Monotone-decreasing wave tag: the current wave's claims are
    numerically smaller than every stale wave's, so scatter-min never needs
    a reset.  ``wave`` is an int or a 0-d int64 tensor; so is the tag."""
    return MAX_WAVE - (wave & MAX_WAVE)


def device_scalar(x, device) -> torch.Tensor:
    """``x`` as the 0-d int64 tensor on ``device`` that a kernel reads the
    wave (or a timestamp derived from it) from.  A tensor passes as it is;
    an int (the kernel cases and the tests: a run keeps its wave on the
    device) is copied there once per value and device, and the copy is
    shared: nothing may write to it."""
    if isinstance(x, torch.Tensor):
        return x
    return _scalar(int(x), torch.device(device))


@functools.lru_cache(maxsize=256)
def _scalar(x: int, device: torch.device) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.int64, device=device)


def u32(x: torch.Tensor) -> torch.Tensor:
    """int32 bit pattern (or any integer tensor) -> its uint32 value in
    int64."""
    return x.to(torch.int64) & U32_MASK


def to_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 value -> the int32 tensor holding its low 32 bits."""
    return (((x & U32_MASK) ^ 0x80000000) - 0x80000000).to(torch.int32)


def claim_word(wave, prio: torch.Tensor) -> torch.Tensor:
    """Pack (wave, prio16) into one claim word (int64 value)."""
    return (inv_wave(wave) << WAVE_SHIFT) | (u32(prio) & PRIO16_MASK)


def live_prio(words: torch.Tensor, ivw) -> torch.Tensor:
    """Unpack claim words (int64 values): prio16 where the wave tag matches
    ``ivw``, NO_PRIO where the claim is stale or absent."""
    live = (words >> WAVE_SHIFT) == ivw
    return torch.where(live, words & PRIO16_MASK,
                       torch.full_like(words, NO_PRIO))
