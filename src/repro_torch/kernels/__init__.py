"""Hand-written CUDA kernels of the port, each beside its plain version.

Every module holds a kernel's plain PyTorch version, its wrapper and the
wrapper's ``launches`` counter.  A wrapper runs the plain version for CPU
tensors and launches the kernel (``csrc/<name>.cu``, built by
``build.py``) for CUDA tensors; it never falls back.  ``launches`` grows by
one per wrapper call that launched its kernel, and nowhere else.
"""
from repro_torch.kernels.segment_count import segment_count
from repro_torch.kernels.ts_gather import ts_gather
from repro_torch.kernels.ts_install import ts_install_max
from repro_torch.kernels.wave_commit import wave_commit

#: Backend surface op -> kernel wrapper.
WRAPPERS = {
    "wave_commit": wave_commit,
    "segment_count": segment_count,
    "ts_gather": ts_gather,
    "ts_install_max": ts_install_max,
}


def launch_counts() -> dict:
    """{op: kernel launches so far} for every ported op."""
    return {op: w.launches for op, w in WRAPPERS.items()}


def reset_launches() -> None:
    for w in WRAPPERS.values():
        w.launches = 0
