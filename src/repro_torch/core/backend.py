"""The backend surface every CC mechanism calls (port of
``repro/core/backend.py``).

The JAX package names ``N_OPS`` surface ops and keeps two backends behind
them (XLA gather/scatter and Pallas).  The port keeps the same op names
and one backend whose ops dispatch on the device of their tensors: CPU
tensors run the plain PyTorch version, CUDA tensors launch the hand
kernel (kernels/).  Every op of the surface is ported; ``probe`` has no
caller in either package's engine, and ``claim_scatter`` none in the
port's (its work rides other ops' calls); ``mv_gather``'s one caller is
``mvstore.snapshot_values``.  One op is the port's own:
``apply_values``, the tracked values' serial replay (and, for the
version ring, its copy-forward), one launch a call on the card.

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
#: the JAX package.  The probe family's fused route (``fuse_wave=True``)
#: runs its bumps inside ``wave_commit``, so ``commit_install`` is reached
#: only by AutoGran and by the unfused route, which also runs
#: ``claim_probe`` (listed for no mechanism, as in the JAX package).
#: ``iterate_validate`` runs only where the config admits scans
#: (``max_extent > 1``), and with scans the JAX package's fused route
#: moves its bumps to ``commit_install``.  The lists stay the JAX
#: package's; where the port folds an op into another op's call,
#: ``kernel_coverage`` reports it "not_run".  With scans the port's
#: fused route and AutoGran bump inside the phantom pass's one
#: ``iterate_validate`` call (its bump form), so ``commit_install`` is
#: "not_run" there; AutoGran installs its write claims inside its one
#: ``validate_dual`` call, so ``claim_scatter`` is "not_run" for it.
#: MVCC and MV-OCC install both claim channels and read
#: the version ring inside their one ``validate`` call a wave, so the
#: port reports ``claim_scatter`` and ``mv_gather`` as "not_run" for them
#: (the JAX package's waves call ``claim_scatter`` twice and
#: ``mv_gather`` once); no engine path calls ``claim_scatter``.  The
#: port's TicToc reads both timestamp tables and derives ``commit_ts`` in
#: one ``ts_gather`` call a wave (JAX: two) and makes its three timestamp
#: installs in one ``ts_install_max`` call; the unfused route's dual
#: waves (2PL, Adaptive) probe both claim tables in one ``claim_probe``
#: call (the JAX package calls each table's).
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

#: The surface ops one shard-local wave of the sharded engine
#: (core/distributed.py) routes through the backend, per mechanism: the
#: stable exchange pack, the verdict bit-pack/unpack pair of the verdict
#: and commit return trips, and the owner-side claim step with its
#: install.  OCC claims through the fused ``wave_commit`` (through
#: ``claim_probe`` when ``fuse_wave`` is off) and bumps through
#: ``commit_install``; MVCC/MV-OCC claim two channels and read the ring
#: through one ``claim_probe`` call and publish through ``mv_install``
#: (the JAX package's wave reads the ring through ``mv_gather``).  Scan
#: fragments validate through ``iterate_validate`` on their owner shard,
#: except under MVCC, whose scans never re-validate.  The owner's claim
#: call writes the packed verdict words itself (``wave_commit(...,
#: pack=True)``, ``claim_probe(..., is_rp=)``), ``iterate_validate``
#: ORs into them (``words=``) and the install reads the commit words
#: (``words=``), so only the sender calls ``verdict_unpack`` and
#: ``verdict_pack``, once a wave each, in their gather forms (the JAX
#: package's wave calls each twice).
DIST_OPS = ("route_pack", "verdict_pack", "verdict_unpack", "wave_commit",
            "iterate_validate", "commit_install")
DIST_MV_OPS = ("route_pack", "verdict_pack", "verdict_unpack",
               "claim_probe", "mv_install")
DIST_MVOCC_OPS = DIST_MV_OPS + ("iterate_validate",)


class Backend:
    """Device-dispatching backend: each op runs where its tensors are.

    Signatures follow the JAX backend's argument order, with optional
    keywords that fold several of its calls into one: ``validate`` takes
    the multi-version waves' claim installs and their version ring
    (``begin``, ``snap_ts``), ``validate_dual`` AutoGran's write-claim
    install (``install``, with the lane priority int32[T]),
    ``iterate_validate`` a scan wave's version bumps (``point``,
    ``wts``, ``do``), ``claim_probe`` a second claim table
    (``claim_r``, ``mask_r``), ``ts_gather`` TicToc's second table, masks
    and extents (``rts``, ``rd``, ``wr``, ``extent``) and
    ``ts_install_max`` TicToc's second table, its extension mask and the
    stamps' inputs (``rts``, ``ext``, ``commit_ts``, ``n_chain``).  The
    sharded wave's forms take the verdict wire format
    (kernels/verdict_pack.py) into the launch beside it: ``wave_commit``
    ``pack=True`` and ``claim_probe`` ``is_rp`` (and on two tables
    ``is_r`` with the ring) return the packed verdict words,
    ``iterate_validate`` ``words=``/``bit=`` ORs into them,
    ``commit_install`` and ``mv_install`` ``words=`` read commit words,
    and ``verdict_unpack`` ``owner``/``pos``/``took`` and ``verdict_pack``
    ``lane`` gather at the routing coordinates.  Tables are updated in
    place, so ``commit_install``, ``claim_scatter`` and ``mv_install``
    return None, ``claim_probe`` and ``probe`` return wprio int32[T, K]
    (with ``claim_r``, (wprio, rprio)), ``validate`` returns conflict
    flags (with the ring, (conflict, ok)), ``ts_gather`` timestamps
    (TicToc's form, (commit_ts, ext_need)), ``validate_dual`` returns
    (fine, coarse) and ``mv_gather`` returns (slot, ok)."""


for _op in SURFACE_OPS:
    setattr(Backend, _op, staticmethod(kernels.WRAPPERS[_op]))

#: The port's own op beside the surface: the tracked values' serial replay
#: and the ring's copy-forward (kernels/apply_values.py), which the JAX
#: package computes with a ``lax.scan`` in its engine and two index ops in
#: ``mvstore.install_values`` rather than through its backend.
Backend.apply_values = staticmethod(kernels.WRAPPERS["apply_values"])

#: The one backend: every config uses it; the tensors' device picks the
#: route.
BACKEND = Backend()


def _coverage(ops, launches: dict, calls: dict) -> dict:
    out = {}
    for op in ops:
        n = calls.get(op, 0)
        out[op] = ("not_run" if n == 0 else
                   "cuda" if launches.get(op, 0) == n else "torch")
    return out


def kernel_coverage(cc: int, launches: dict, calls: dict) -> dict:
    """{op: "cuda" | "torch" | "not_run"} for the ported ops of mechanism
    ``cc``, from the deltas of ``kernels.launch_counts()`` and
    ``kernels.call_counts()`` over a run: "cuda" where every call launched
    the op's kernel, "torch" where a call ran its plain version, "not_run"
    where the run never called it (``commit_install`` on the fused
    route and, with scans, in AutoGran, ``iterate_validate`` without
    scans, ``claim_scatter`` under MVCC, MV-OCC and AutoGran,
    ``mv_gather`` under MVCC and MV-OCC)."""
    return _coverage(CC_OPS[cc], launches, calls)


def dist_kernel_coverage(cc: str, launches: dict, calls: dict,
                         fuse_wave: bool = True) -> dict:
    """The same attribution for the sharded wave's ops of mechanism ``cc``
    ("occ", "mvcc" or "mvocc"): OCC's unfused route claims through
    ``claim_probe`` in place of ``wave_commit``, and "not_run" marks
    ``iterate_validate`` without scans."""
    ops = {"mvcc": DIST_MV_OPS, "mvocc": DIST_MVOCC_OPS}.get(cc, DIST_OPS)
    if cc == "occ" and not fuse_wave:
        ops = tuple("claim_probe" if op == "wave_commit" else op
                    for op in ops)
    return _coverage(ops, launches, calls)
