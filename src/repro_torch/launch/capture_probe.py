"""Whether a CUDA graph captures the port's cooperative wave launches.

    PYTHONPATH=src python -m repro_torch.launch.capture_probe

Six wave kernels launch cooperatively (``cudaLaunchCooperativeKernel``,
a grid barrier inside): ``wave_commit``, ``claim_probe`` (two claim
tables), ``validate``'s install form with the version ring,
``validate_dual``'s install form, ``mv_install`` and ``route_pack``.  For
each, and for ``segment_count`` (a plain launch, the control), this
script captures one wrapper call alone into a ``torch.cuda.CUDAGraph``
(``torch.cuda.graph`` captures on a side stream), then replays the graph
twice.  Before each replay it sets the captured wave scalar (a 0-d int64
tensor, as ``EngineState.wave`` is) to the next wave on the device, and
it holds the replay's outputs and tables against an eager call on that
next wave's scalar from the same tables.  The ring stamps are derived
from the wave inside the captured call (``mvstore.snapshot_ts`` /
``install_ts``), as the engine derives them.  The inputs are one TPC-C
sized wave (T 128 x K 64 over 2,450,808 records, two groups), made from
a seed with numpy.

Prints the card's name and power limit, then one JSON line per kernel:
``captured`` (or ``error``, the CUDA error the capture raised), and for a
captured launch ``replays_identical`` (both replays equal to the eager
calls, bit for bit) and the replays' wrapper ``launches`` delta (0: a
replay does not call the wrapper, so its counter does not move).  Needs
a CUDA device; exits 1 when a kernel's eager call fails.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys

import numpy as np
import torch

#: The first wave of the probe: its replays run waves 65,535 and 65,536,
#: across the claim tag's wrap.
WAVE0 = 65_534
N, G, T, K = 2_450_808, 2, 128, 64


def _inputs(dev, seed: int = 0) -> dict:
    """One wave's tables and ops: claim words of this and older waves,
    hot and masked keys, half the ops writing and checking."""
    rng = np.random.default_rng(seed)
    old = (0xFFFF - ((WAVE0 - rng.integers(0, 4, (N, G))) & 0xFFFF)) << 16
    words = (old | rng.integers(0, 1 << 16, (N, G))).astype(np.uint32)
    keys = rng.integers(0, N, (T, K))
    hot = rng.integers(0, N, 8)
    keys = np.where(rng.random((T, K)) < 0.3, hot[rng.integers(0, 8, (T, K))],
                    keys)
    keys[rng.random((T, K)) < 0.1] = -1
    prio = (63 << 10) | rng.permutation(T)

    def d(x, dt=torch.int32):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev, dt)

    def mask(p):
        return d(rng.random((T, K)) < p, torch.bool)
    return dict(
        claim_w=d(words.view(np.int32)),
        claim_r=d(np.roll(words, 1, axis=0).view(np.int32)),
        wts=d(rng.integers(0, 1 << 31, (N, G))),
        keys=d(keys), groups=d(rng.integers(0, G, (T, K))),
        prio=d(np.broadcast_to(prio[:, None], (T, K))), lane=d(prio),
        do_w=mask(0.5), do_r=mask(0.5), check_w=mask(0.5),
        check_r=mask(0.3))


def _ring(x: dict, dev):
    """A version ring with a few waves of installs below WAVE0."""
    from repro_torch.core.mvstore import mv_init
    from repro_torch.kernels.mv_install import mv_install_plain
    begin, head, _ = mv_init(N, 4, G, dev)
    for w in range(3):
        mv_install_plain(begin, head, torch.roll(x["keys"], w), x["groups"],
                         x["do_w"], WAVE0 - 3 + w)
    return begin, head


def cases(dev) -> dict:
    """name -> (state {tensor}, call(state, wave) -> outputs, wrapper
    name): one wrapper call each, reading every input from ``state``."""
    from repro_torch import kernels as Kn
    from repro_torch.core import mvstore
    from repro_torch.core.distributed import LANE_FILL, META_FILL, NO_OP
    x = _inputs(dev)
    begin, head = _ring(x, dev)
    rng = np.random.default_rng(1)
    M = T * K
    route = dict(owner=torch.from_numpy(rng.integers(-1, 8, M).astype(
                     np.int32)).to(dev),
                 vals=torch.from_numpy(rng.integers(0, 1 << 30, (3, M))
                                       .astype(np.int32)).to(dev))
    ops = ("keys", "groups")
    out = {
        "wave_commit": (dict(x), lambda s, w: Kn.wave_commit(
            s["claim_w"], None, s["wts"], *(s[k] for k in ops), s["prio"],
            s["do_w"], None, s["check_w"], None, None, None, w, True,
            False, True), "wave_commit"),
        "claim_probe": (dict(x), lambda s, w: Kn.claim_probe(
            s["claim_w"], *(s[k] for k in ops), s["prio"], w, s["do_w"],
            True, claim_r=s["claim_r"], mask_r=s["do_r"]), "claim_probe"),
        "validate": (dict(x, begin=begin), lambda s, w: Kn.validate(
            s["claim_w"], *(s[k] for k in ops), s["lane"], s["check_w"], w,
            True, claim_r=s["claim_r"], check_r=s["check_r"],
            install_w=s["do_w"], install_r=s["do_r"], begin=s["begin"],
            snap_ts=mvstore.snapshot_ts(w)), "validate"),
        "validate_dual": (dict(x), lambda s, w: Kn.validate_dual(
            s["claim_w"], *(s[k] for k in ops), s["lane"], s["check_w"], w,
            install=s["do_w"]), "validate_dual"),
        "mv_install": (dict(x, begin=begin.clone(), head=head.clone()),
                       lambda s, w: Kn.mv_install(
                           s["begin"], s["head"], *(s[k] for k in ops),
                           s["do_w"], mvstore.install_ts(w)), "mv_install"),
        "route_pack": (route, lambda s, w: Kn.route_pack(
            s["owner"], s["vals"], 8, 2048, (NO_OP, META_FILL, LANE_FILL)),
            "route_pack"),
        "segment_count (control)": (dict(x), lambda s, w: Kn.segment_count(
            *(s[k] for k in ops), G, s["do_w"]), "segment_count"),
    }
    return out


def _flat(out) -> list:
    if out is None:
        return []
    if isinstance(out, (tuple, list)):
        return [t for o in out for t in _flat(o)]
    return [out]


def _copy(state: dict) -> dict:
    return {k: v.clone() for k, v in state.items()}


def probe(name: str, state: dict, call, wrapper: str, dev) -> dict:
    """Capture ``call(state, wave)`` alone, replay it twice on the next
    waves, and hold each replay against an eager call."""
    from repro_torch import kernels as Kn
    row = {"kernel": name}
    wave = torch.tensor(WAVE0, dtype=torch.int64, device=dev)
    call(_copy(state), wave.clone())          # builds, warms the caches
    torch.cuda.synchronize(dev)
    graph = torch.cuda.CUDAGraph()
    first = []
    try:
        with torch.cuda.graph(graph):
            try:
                captured = _flat(call(state, wave))
            except Exception as e:  # noqa: BLE001 - kept as the finding
                first.append(e)
                raise
    except Exception as e:  # noqa: BLE001 - the finding is the error text
        err = first[0] if first else e
        row.update(captured=False, error=f"{type(err).__name__}: {err}"[:400])
        # A failed launch leaves its error as the library's last error:
        # one eager call returns (and so clears) it.
        try:
            call(_copy(state), wave.clone())
        except Exception:  # noqa: BLE001
            pass
        torch.cuda.synchronize(dev)
        return row
    row["captured"] = True
    same, launched = [], 0
    for step in (1, 2):
        base = _copy(state)                 # the tables this replay sees
        wave.fill_(WAVE0 + step)            # the next wave, on the device
        before = getattr(Kn, wrapper).launches
        graph.replay()
        launched += getattr(Kn, wrapper).launches - before
        torch.cuda.synchronize(dev)
        got = [t.clone() for t in captured] + [state[k] for k in state]
        want_out = _flat(call(base, torch.tensor(
            WAVE0 + step, dtype=torch.int64, device=dev)))
        want = want_out + [base[k] for k in state]
        same.append(len(got) == len(want) and all(
            torch.equal(a, b) for a, b in zip(got, want)))
    row["launches"] = launched
    row["replays_identical"] = all(same)
    row["replays"] = same
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("capture_probe needs a CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    print(f"torch {torch.__version__} CUDA {torch.version.cuda}", flush=True)
    for name, (state, call, wrapper) in cases(dev).items():
        print(json.dumps(probe(name, state, call, wrapper, dev)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
