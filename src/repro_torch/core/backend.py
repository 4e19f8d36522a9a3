"""The backend surface every CC mechanism calls (port of
``repro/core/backend.py``).

The JAX package names ``N_OPS`` surface ops and keeps two backends behind
them (XLA gather/scatter and Pallas).  The port keeps the same op names
and one backend whose ops dispatch on the device of their tensors: CPU
tensors run the plain PyTorch version, CUDA tensors launch the hand
kernel (kernels/).  Ops that this port does not run yet raise
``NotImplementedError`` naming the ROADMAP item they wait for.

All word tables are updated in place, so ops that install return only
their per-op outputs (see each kernel module).
"""
from __future__ import annotations

from repro_torch import kernels
from repro_torch.core import types as t

#: The canonical backend surface, in the JAX package's order.
SURFACE_OPS = ("validate", "validate_dual", "probe", "claim_probe",
               "wave_commit", "iterate_validate", "ts_gather",
               "claim_scatter", "commit_install", "ts_install_max",
               "segment_count", "route_pack", "mv_gather", "mv_install",
               "verdict_pack", "verdict_unpack")

#: Op count of the backend surface.
N_OPS = len(SURFACE_OPS)

#: The surface ops each mechanism's wave routes through the backend in
#: the JAX package.  In this port OCC and TicToc run fused point waves,
#: so ``iterate_validate`` (scans) and ``commit_install`` (the unfused
#: bump) are not reached.
CC_OPS = {
    t.CC_OCC: ("wave_commit", "iterate_validate", "commit_install",
               "segment_count"),
    t.CC_TICTOC: ("wave_commit", "iterate_validate", "ts_gather",
                  "ts_install_max", "segment_count"),
    t.CC_2PL: ("wave_commit", "iterate_validate", "commit_install",
               "segment_count"),
    t.CC_SWISS: ("wave_commit", "iterate_validate", "commit_install",
                 "segment_count"),
    t.CC_ADAPTIVE: ("wave_commit", "iterate_validate", "commit_install",
                    "segment_count"),
    t.CC_AUTOGRAN: ("validate_dual", "iterate_validate", "claim_scatter",
                    "commit_install", "segment_count"),
    t.CC_MVCC: ("validate", "claim_scatter", "mv_gather", "mv_install",
                "segment_count"),
    t.CC_MVOCC: ("validate", "iterate_validate", "claim_scatter",
                 "mv_gather", "mv_install", "segment_count"),
}

#: Where each op without a port waits (ROADMAP queue B).
_WAITS = {
    "commit_install": "ROADMAP B.5 (occ_commit)",
    "claim_probe": "ROADMAP B.6 (claim_probe_fused)",
    "validate": "ROADMAP B.7 (occ_validate)",
    "validate_dual": "ROADMAP B.7 (occ_validate_dual)",
    "probe": "ROADMAP B.7 (claim_probe)",
    "claim_scatter": "ROADMAP B.8 (claim_scatter)",
    "iterate_validate": "ROADMAP B.9 (iterate_validate)",
    "mv_gather": "ROADMAP B.10 (mv_gather)",
    "mv_install": "ROADMAP B.11 (mv_install)",
    "route_pack": "ROADMAP B.12 (route_pack)",
    "verdict_pack": "ROADMAP B.13 (verdict_pack)",
    "verdict_unpack": "ROADMAP B.13 (verdict_unpack)",
}


def _waiting(op: str):
    def missing(*args, **kwargs):
        raise NotImplementedError(
            f"backend op {op!r} is not ported to repro_torch yet: it waits "
            f"for {_WAITS[op]}")
    missing.__name__ = op
    return missing


class Backend:
    """Device-dispatching backend: each op runs where its tensors are."""
    wave_commit = staticmethod(kernels.wave_commit)
    segment_count = staticmethod(kernels.segment_count)
    ts_gather = staticmethod(kernels.ts_gather)
    ts_install_max = staticmethod(kernels.ts_install_max)


for _op in _WAITS:
    setattr(Backend, _op, staticmethod(_waiting(_op)))

#: The one backend: every config uses it; the tensors' device picks the
#: route.
BACKEND = Backend()


def kernel_coverage(cc: int, launches: dict) -> dict:
    """{op: "cuda" | "torch"} for the ported ops of mechanism ``cc``:
    "cuda" where ``launches`` (a delta of ``kernels.launch_counts()``
    over the run) shows the op's kernel launched, "torch" where it ran as
    its plain version."""
    return {op: "cuda" if launches.get(op, 0) > 0 else "torch"
            for op in CC_OPS[cc] if op in kernels.WRAPPERS}
