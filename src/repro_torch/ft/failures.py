"""Failure injection for the fault-tolerance path (port of
``repro/ft/failures.py``).

``FailureInjector`` raises ``SimulatedFailure`` at configured steps (or at
a seeded random rate) after the step's computation, modelling a node lost
mid-run.  The trainer's supervisor loop (``launch/train.run_supervised``)
catches it, drops the state in memory and resumes from the last durable
checkpoint.
"""
from __future__ import annotations

import dataclasses
import random


class SimulatedFailure(RuntimeError):
    pass


@dataclasses.dataclass
class FailureInjector:
    at_steps: tuple = ()            # deterministic failures
    rate: float = 0.0               # plus Bernoulli(rate) per step
    seed: int = 0
    max_failures: int = 10 ** 9

    def __post_init__(self):
        self._rng = random.Random(self.seed)
        self._fired = 0
        self._tripped = set()

    def maybe_fail(self, step: int):
        if self._fired >= self.max_failures:
            return
        hit = (step in self.at_steps and step not in self._tripped) \
            or (self.rate > 0 and self._rng.random() < self.rate)
        if hit:
            self._tripped.add(step)
            self._fired += 1
            raise SimulatedFailure(f"injected node failure at step {step}")
