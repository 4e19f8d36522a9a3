"""Synthetic token streams (port of ``repro/data/pipeline.py::_tokens``).

A skewed unigram draw (Zipf-flavoured over the vocabulary), so that
prompts look more like text than uniform noise.  The draw comes from an
explicit ``torch.Generator``; it does not reproduce the JAX package's
numbers.
"""
from __future__ import annotations

import torch


def tokens(gen: torch.Generator, shape, vocab: int) -> torch.Tensor:
    """int64 token ids of ``shape`` in [0, vocab), on ``gen``'s device:
    u^4 concentrates mass on low ids."""
    u = torch.rand(shape, generator=gen, device=gen.device)
    return torch.clamp((u ** 4 * vocab).to(torch.int64), max=vocab - 1)
