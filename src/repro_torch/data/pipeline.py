"""Synthetic token streams and training batches (port of
``repro/data/pipeline.py``).

``tokens`` is a skewed unigram draw (Zipf-flavoured over the
vocabulary), so that prompts and batches look more like text than
uniform noise.  ``make_batch(cfg, shape, step)`` is a pure function of
the step: no cursor, no files, so a run restored from a checkpoint at
step k replays batch k, and ``host_slice`` (index, count) gives one
host's share of the global batch.  Draws come from explicit
``torch.Generator``s seeded from (seed, step[, host index]); they do not
reproduce the JAX package's numbers, and a generator on the card draws
other numbers than one on the CPU.
"""
from __future__ import annotations

import numpy as np
import torch


def tokens(gen: torch.Generator, shape, vocab: int) -> torch.Tensor:
    """int64 token ids of ``shape`` in [0, vocab), on ``gen``'s device:
    u^4 concentrates mass on low ids."""
    u = torch.rand(shape, generator=gen, device=gen.device)
    return torch.clamp((u ** 4 * vocab).to(torch.int64), max=vocab - 1)


def _generator(device, *key: int) -> torch.Generator:
    """A generator on ``device`` seeded from the integers ``key``."""
    seed = int(np.random.SeedSequence(list(key)).generate_state(
        1, np.uint64)[0] >> 1)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return gen


def make_batch(cfg, shape, step: int, *, train: bool = True,
               host_slice=None, seed: int = 1234, device="cpu") -> dict:
    """The batch of (cfg, shape) at ``step``: {"tokens": int64 [B, S
    (+1 when ``train``)]}, plus the frontend stubs' bf16 embeddings
    ("patches" [B, n_patches, D], "frames" [B, n_frames, D]) where the
    config has them; on ``device``.  ``host_slice`` = (index, count)
    draws host ``index``'s B / count rows."""
    B, S = shape.global_batch, shape.seq_len
    key = (seed, int(step))
    if host_slice is not None:
        idx, count = host_slice
        assert B % count == 0
        B = B // count
        key += (int(idx),)
    extra = 1 if train else 0
    batch = {}
    s_text = S
    if cfg.n_patches:
        s_text = S - cfg.n_patches
        g = _generator(device, *key, 1)
        batch["patches"] = (torch.randn(
            (B, cfg.n_patches, cfg.d_model), generator=g, device=device)
            * 0.02).to(torch.bfloat16)
    if cfg.n_frames:
        g = _generator(device, *key, 2)
        batch["frames"] = (torch.randn(
            (B, cfg.n_frames, cfg.d_model), generator=g, device=device)
            * 0.02).to(torch.bfloat16)
    batch["tokens"] = tokens(_generator(device, *key, 0),
                             (B, s_text + extra), cfg.vocab)
    return batch
