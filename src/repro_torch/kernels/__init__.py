"""Hand-written CUDA kernels of the port, each beside its plain version.

Every module holds a kernel's plain PyTorch version, its wrapper and the
wrapper's two counters.  A wrapper runs the plain version for CPU tensors
and launches the kernel (``csrc/<name>.cu``, built by ``build.py``) for
CUDA tensors; it never falls back.  ``calls`` grows by one per wrapper
call; ``launches`` grows by one per call that launched the kernel, and
nowhere else.
"""
from repro_torch.kernels.claim_probe import claim_probe, probe
from repro_torch.kernels.claim_scatter import claim_scatter
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.iterate_validate import iterate_validate
from repro_torch.kernels.mv_gather import mv_gather
from repro_torch.kernels.mv_install import mv_install
from repro_torch.kernels.occ_commit import commit_install
from repro_torch.kernels.occ_validate import validate, validate_dual
from repro_torch.kernels.rglru import rglru
from repro_torch.kernels.route_pack import route_pack
from repro_torch.kernels.rwkv6 import rwkv6
from repro_torch.kernels.segment_count import segment_count
from repro_torch.kernels.ts_gather import ts_gather
from repro_torch.kernels.ts_install import ts_install_max
from repro_torch.kernels.verdict_pack import verdict_pack, verdict_unpack
from repro_torch.kernels.wave_commit import wave_commit

#: Op -> kernel wrapper: the backend surface's ops, then the language
#: models' (flash_attention, rglru, rwkv6).
WRAPPERS = {
    "wave_commit": wave_commit,
    "segment_count": segment_count,
    "ts_gather": ts_gather,
    "ts_install_max": ts_install_max,
    "commit_install": commit_install,
    "claim_scatter": claim_scatter,
    "validate_dual": validate_dual,
    "claim_probe": claim_probe,
    "probe": probe,
    "validate": validate,
    "iterate_validate": iterate_validate,
    "mv_gather": mv_gather,
    "mv_install": mv_install,
    "route_pack": route_pack,
    "verdict_pack": verdict_pack,
    "verdict_unpack": verdict_unpack,
    "flash_attention": flash_attention,
    "rglru": rglru,
    "rwkv6": rwkv6,
}


def launch_counts() -> dict:
    """{op: kernel launches so far} for every ported op."""
    return {op: w.launches for op, w in WRAPPERS.items()}


def call_counts() -> dict:
    """{op: wrapper calls so far, plain or kernel} for every ported op."""
    return {op: w.calls for op, w in WRAPPERS.items()}


def reset_launches() -> None:
    """Set every wrapper's ``launches`` and ``calls`` to 0."""
    for w in WRAPPERS.values():
        w.launches = 0
        w.calls = 0
