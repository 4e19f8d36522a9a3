"""Named ranges of the wave's phases for ``torch.profiler``.

The JAX package names its phases with ``jax.named_scope("repro:<name>")``
(validate, cost, claim, wave_commit, install, iterate_validate,
mv_install; route, claim, commit, install in the sharded wave).  The port
opens a ``torch.profiler.record_function`` range of the same name, so a
profile of the card groups each phase's host ops and the device time of
the kernels they launch under it (``launch/wave_profile.py`` reads them).
A range is opened only while a profiler runs: outside one, a
``record_function`` costs ~15 µs of host time for nothing.
"""
from __future__ import annotations

import contextlib
import functools

import torch


def named_range(name: str):
    """``record_function("repro:" + name)`` while a profiler runs, else a
    context that does nothing."""
    if torch._C._autograd._profiler_enabled():
        return torch.profiler.record_function("repro:" + name)
    return contextlib.nullcontext()


def in_range(name: str):
    """Decorator: the call runs inside ``named_range(name)``."""
    def wrap(fn):
        @functools.wraps(fn)
        def ranged(*args, **kwargs):
            with named_range(name):
                return fn(*args, **kwargs)
        return ranged
    return wrap
