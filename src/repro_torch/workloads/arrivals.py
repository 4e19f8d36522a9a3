"""Poisson arrival schedules for the open-loop traffic front-end (port of
``repro/workloads/arrivals.py``).

An open-loop benchmark decouples transaction *arrival* from transaction
*service*: clients submit on their own clock (a Poisson process of
``rate`` expected transactions per wave) and the engine admits from the
queue (core/admission.py).  Two seeded streams:

- ``poisson_offered`` — the local engine's per-wave draw: one
  ``torch.poisson`` sample on an explicit ``torch.Generator``, capped at
  the lane-grid width (the front-end materializes at most T fresh
  transactions per wave, so size rates accordingly).  It is the port's
  own stream: it does not reproduce ``jax.random.poisson``.
- ``PoissonArrivals`` — a host-side schedule (NumPy ``default_rng``),
  copied as it is: ``counts(n_waves, max_per_wave)`` yields capped
  per-wave arrival counts, reproducibly from ``seed``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


def poisson_offered(gen: torch.Generator, rate: float,
                    max_n: int) -> torch.Tensor:
    """One wave's arrival count: min(Poisson(rate), max_n), an int64
    scalar tensor on the generator's device."""
    lam = torch.tensor(float(rate), dtype=torch.float32, device=gen.device)
    draw = torch.poisson(lam, generator=gen)
    return torch.clamp(draw, max=max_n).to(torch.int64)


@dataclasses.dataclass(frozen=True)
class PoissonArrivals:
    """Seeded host-side arrival schedule."""
    rate: float          # expected arrivals per wave
    seed: int = 0

    def counts(self, n_waves: int, max_per_wave: int) -> np.ndarray:
        """int32[n_waves] per-wave arrival counts, capped at the
        front-end's per-wave generation width."""
        rng = np.random.default_rng(self.seed)
        return np.minimum(rng.poisson(self.rate, n_waves),
                          max_per_wave).astype(np.int32)

    def shard_counts(self, n_waves: int, n_shards: int,
                     max_per_shard: int) -> np.ndarray:
        """int32[n_waves, n_shards]: each shard's admission queue runs its
        own thinned Poisson stream (rate / n_shards), capped at the
        shard's lane width."""
        rng = np.random.default_rng(self.seed)
        return np.minimum(
            rng.poisson(self.rate / max(n_shards, 1),
                        (n_waves, n_shards)),
            max_per_shard).astype(np.int32)
