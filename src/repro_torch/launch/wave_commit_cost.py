"""Where wave_commit's time goes on the card: the kernel against copies of
its source with the grid barriers taken out and with an empty body.

    PYTHONPATH=src python -m repro_torch.launch.wave_commit_cost

``csrc/wave_commit.cu`` is one cooperative launch with a grid barrier
between the claim installs and the probes (two on a lane wider than a
block when it bumps).  This script builds two more copies of that source
into ``build/wave_commit_cost/``: ``no_barrier`` (every ``grid.sync()``
removed: the probes may miss installs, so its answers are not used) and
``empty`` (the kernel returns at once: a cooperative launch that does
nothing), binds each with the same C signature and times the wrapper
``kernels.wave_commit`` with each library in turn, on the same inputs:
the main path's OCC-fine call at TPC-C (T 128 x K 64) and YCSB (K 16)
shapes, and the sharded owner's row [1, 16384] with and without bump.
Times are the median of ``--n`` calls queued behind a device sleep (CUDA
events).  Prints the card's name and power limit and one JSON line per
shape; needs a CUDA device and nvcc.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess

import numpy as np
import torch

from repro_torch import kernels as K
from repro_torch.kernels import build
from repro_torch.kernels.wave_commit import _SIG

#: name -> (text in csrc/wave_commit.cu, its replacement, times found).
VARIANTS = {
    "no_barrier": ("  grid.sync();\n", "\n", 2),
    "empty": ("  cg::grid_group grid = cg::this_grid();\n",
              "  if (a.T > 0) return;\n"
              "  cg::grid_group grid = cg::this_grid();\n", 1),
}
#: label -> (N records, T lanes, K slots, bump): the timed calls.
SHAPES = {"tpcc": (2_450_808, 128, 64, True),
          "ycsb": (10_000_000, 128, 16, True),
          "wide [1, 16384]": (10_000_000, 1, 16384, False),
          "wide [1, 16384] bump": (10_000_000, 1, 16384, True)}


def variant_libs() -> dict:
    """{name: loaded library} of each variant, built in parallel."""
    src = (build.CSRC / "wave_commit.cu").read_text()
    out = build.BUILD_DIR.parent / "wave_commit_cost"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, (old, new, count) in VARIANTS.items():
        if src.count(old) != count:
            raise RuntimeError(f"{name}: csrc/wave_commit.cu no longer has "
                               f"{count} x {old!r}")
        cu = out / f"{name}.cu"
        cu.write_text(src.replace(old, new))
        procs[name] = subprocess.Popen(
            [build.nvcc_path(), *build.NVCC_FLAGS, "-I", str(build.CSRC),
             "-o", str(out / f"{name}.so"), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, p in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        lib = ctypes.CDLL(str(out / f"{name}.so"))
        f = lib.repro_wave_commit
        f.argtypes = _SIG["repro_wave_commit"]
        f.restype = ctypes.c_int
        libs[name] = lib
    return libs


def time_ms(fn, n: int) -> float:
    """Median ms of one call: warm-up, then ``n`` calls behind a device
    sleep, each between two CUDA events."""
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(n)]
    torch.cuda._sleep(50_000_000)
    for a, b in ev:
        a.record()
        fn()
        b.record()
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in ev)


def inputs(N, T, Kk, dev, seed=0):
    """A wave of OCC-fine's call: claim words of this wave (9) and of
    earlier ones, hot and masked keys, half the ops writing and checking,
    a prio per lane (per op on a wide row)."""
    rng = np.random.default_rng(seed)
    wave, G = 9, 2
    old = (0xFFFF - (wave - rng.integers(1, 4, (N, G)))) << 16
    live = rng.random((N, G)) < 0.3
    words = np.where(live, (0xFFFF - wave) << 16, old) | rng.integers(
        0, 1 << 16, (N, G))
    keys = rng.integers(0, N, (T, Kk))
    keys = np.where(rng.random((T, Kk)) < 0.3,
                    rng.integers(0, N, 8)[rng.integers(0, 8, (T, Kk))], keys)
    keys[rng.random((T, Kk)) < 0.1] = -1
    prio = rng.integers(0, 0xFFFF, (T, Kk) if Kk > 1024 else (T, 1))

    def d(x, dt=torch.int32):
        return torch.from_numpy(np.array(x)).to(dev, dt)
    return dict(claim_w=d(words.astype(np.uint32).view(np.int32)),
                wts=d(rng.integers(0, 1 << 31, (N, G))),
                keys=d(keys), groups=d(rng.integers(0, G, (T, Kk))),
                prio=d(np.broadcast_to(prio, (T, Kk))),
                do_w=d(rng.random((T, Kk)) < 0.5, torch.bool),
                check_w=d(rng.random((T, Kk)) < 0.5, torch.bool),
                wave=wave)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=30)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("wave_commit_cost needs a CUDA device")
    dev = torch.device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    build.load("wave_commit", _SIG)
    libs = {"kernel": build._LIBS["wave_commit"], **variant_libs()}
    for label, (N, T, Kk, bump) in SHAPES.items():
        x = inputs(N, T, Kk, dev)

        def call():
            return K.wave_commit(
                x["claim_w"], None, x["wts"] if bump else None, x["keys"],
                x["groups"], x["prio"], x["do_w"], None, x["check_w"], None,
                None, None, x["wave"], True, False, bump)
        row = {"shape": label, "T": T, "K": Kk, "bump": bump}
        for rnd in range(2):            # in turns: k, nb, e, e, nb, k
            names = list(libs) if rnd == 0 else list(libs)[::-1]
            for name in names:
                # The wrapper loads its library from build's cache: point
                # the cache at this variant for the timed calls.
                build._LIBS["wave_commit"] = libs[name]
                row.setdefault(f"{name}_ms", []).append(
                    time_ms(call, args.n))
        build._LIBS["wave_commit"] = libs["kernel"]
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
