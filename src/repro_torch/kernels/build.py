"""Build and bind the CUDA kernels of ``csrc/``.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc``
into its own shared library, loaded with ``ctypes``:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o build/repro_torch/<name>-<hash>.so csrc/<name>.cu

Libraries land in ``build/repro_torch/`` at the repository root, named by a
hash of their source, the shared headers of ``csrc/`` and the flags, so an
edited source or header rebuilds on first use.
``build`` starts one ``nvcc`` per missing library, all at once, and waits
for every one of them.  Without ``nvcc`` a CUDA call raises.

The wrappers in the kernel modules share the argument checks below: every
tensor must be on the launch device, of the expected dtype and shape, and
contiguous; the C function returns ``cudaGetLastError()`` after its
launches, and a non-zero code raises.  The wave index, and a timestamp
derived from it, reach a kernel as a pointer to a 0-d int64 tensor on the
launch device (``scalar``), never by value: a launch argument that a
captured graph would freeze.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional, Sequence

import torch

from repro_torch.core.claimword import device_scalar

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = ("wave_commit", "segment_count", "ts_gather", "ts_install",
           "occ_commit", "claim_scatter", "occ_validate", "claim_probe",
           "iterate_validate", "mv_gather", "mv_install", "route_pack",
           "verdict_pack", "flash_attention", "flash_attention_bwd",
           "rglru", "rglru_bwd", "rwkv6", "rwkv6_bwd", "apply_values")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: dict = {}


def nvcc_path() -> str:
    """The CUDA compiler: $CUDA_HOME/bin/nvcc, nvcc on PATH, or the
    toolkit's default location."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    cands += [shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH): the CUDA "
        "kernels of repro_torch are built from csrc/ on first use")


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    src += b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def build(names: Sequence[str] = SOURCES) -> dict:
    """Compile every library of ``names`` that is missing, one ``nvcc``
    process each, all started together.  Returns {name: compiler log}
    for the libraries built now (ptxas' register and shared-memory
    report)."""
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return {}
    nvcc = nvcc_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for n in todo:
        out = library_path(n)
        tmp = out.with_name(f".{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True),
                    tmp, out)
    logs, failed = {}, []
    for n, (p, tmp, out) in procs.items():
        log, _ = p.communicate()
        logs[n] = log
        if p.returncode != 0:
            failed.append(n)
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(logs[n] for n in failed))
    return logs


def load(name: str, signatures: dict) -> ctypes.CDLL:
    """The loaded library of kernel ``name`` (built if missing), with
    ``signatures`` ({function: argtypes}) declared; every function
    returns a C int (the CUDA error code)."""
    lib = _LIBS.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        for fn, argtypes in signatures.items():
            f = getattr(lib, fn)
            f.argtypes = argtypes
            f.restype = ctypes.c_int
        _LIBS[name] = lib
    return lib


# ------------------------------------------------------------ launch helpers
def check(name: str, t: torch.Tensor, dtype: torch.dtype, shape,
          device: torch.device) -> None:
    """Raise unless ``t`` is a contiguous ``dtype`` tensor of ``shape`` on
    ``device`` — what the kernels take."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def scalar(name: str, x, device: torch.device) -> torch.Tensor:
    """The 0-d int64 tensor on ``device`` that a kernel reads ``x`` (the
    wave, or a timestamp derived from it) from: a tensor is checked and
    passed as it is, an int copied there (``claimword.device_scalar``)."""
    t = device_scalar(x, device)
    check(name, t, torch.int64, (), device)
    return t


def ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    """Device pointer of ``t`` (None -> NULL)."""
    return None if t is None else t.data_ptr()


def stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def raise_on_error(kernel: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{kernel}: CUDA launch failed with error code "
                           f"{rc}")


def launch_device(t: torch.Tensor) -> torch.device:
    """The device a wrapper launches on: CUDA tensors launch the kernel;
    any device but the CPU and CUDA is refused."""
    if t.device.type != "cuda":
        raise ValueError(f"no kernel for device {t.device}")
    return t.device
