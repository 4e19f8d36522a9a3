"""Scrambled-Zipfian key sampler and TPC-C NURand, as torch generators
(port of ``repro/workloads/zipf.py``).

Gray et al.'s inverse-CDF construction, as YCSB's ZipfianGenerator uses
it: ranks follow P(i) ~ 1/i^theta and are hash-scrambled so hot keys are
not neighbours.  zeta(n, theta) is computed once on the host in float64;
sampling runs on the generator's device.  The streams differ from
``jax.random``'s, so the tests compare distributions.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.claimword import U32_MASK


@dataclasses.dataclass(frozen=True)
class ZipfSampler:
    n: int
    theta: float
    zetan: float
    eta: float
    alpha: float

    @staticmethod
    def make(n: int, theta: float = 0.9) -> "ZipfSampler":
        i = np.arange(1, n + 1, dtype=np.float64)
        zetan = float(np.sum(1.0 / i ** theta))
        zeta2 = 1.0 + 0.5 ** theta
        eta = (1.0 - (2.0 / n) ** (1.0 - theta)) / (1.0 - zeta2 / zetan)
        return ZipfSampler(n=n, theta=theta, zetan=zetan, eta=eta,
                           alpha=1.0 / (1.0 - theta))

    def ranks(self, gen: torch.Generator, shape, device) -> torch.Tensor:
        """Zipfian ranks in [0, n) (int32): rank 0 is the hottest."""
        u = torch.rand(shape, generator=gen, device=device) \
            * (1.0 - 1e-7) + 1e-7
        uz = u * self.zetan
        tail = (self.n * torch.pow(self.eta * u - self.eta + 1.0,
                                   self.alpha)).to(torch.int32)
        r = torch.where(uz < 1.0, 0,
                        torch.where(uz < 1.0 + 0.5 ** self.theta, 1, tail))
        return torch.clamp(r, 0, self.n - 1).to(torch.int32)

    def sample(self, gen: torch.Generator, shape, device) -> torch.Tensor:
        """Scrambled-Zipfian keys in [0, n) (int32)."""
        return scramble(self.ranks(gen, shape, device), self.n)


def scramble(x: torch.Tensor, n: int) -> torch.Tensor:
    """Murmur3-finalizer integer hash, mod n (uint32 arithmetic in int64)."""
    h = x.to(torch.int64) & U32_MASK
    h = h ^ (h >> 16)
    h = (h * 0x85EBCA6B) & U32_MASK
    h = h ^ (h >> 13)
    h = (h * 0xC2B2AE35) & U32_MASK
    h = h ^ (h >> 16)
    return (h % n).to(torch.int32)


def nurand(gen: torch.Generator, A: int, x: int, y: int, C: int, shape,
           device) -> torch.Tensor:
    """TPC-C NURand(A, x, y): non-uniform customer/item id selection."""
    a = torch.randint(0, A + 1, shape, generator=gen, device=device)
    b = torch.randint(x, y + 1, shape, generator=gen, device=device)
    return (((a | b) + C) % (y - x + 1)) + x
