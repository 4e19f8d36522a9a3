"""Checkpoints: npz + JSON manifest, atomic, async (port of
``repro/checkpoint/store.py``).

- atomic: written to ``step_K.tmp/``, then renamed to ``step_K/``; a crash
  mid-save never corrupts the latest durable checkpoint;
- async: ``save(..., blocking=False)`` copies the tree to host memory
  before it returns and writes it on a daemon thread, so training goes on
  (and may update the tensors in place); ``wait()`` joins;
- retention: the newest ``keep`` checkpoints stay;
- contents: a tree of dicts and lists of tensors (parameters, optimizer
  state), the step, ``extra`` and a config fingerprint; ``restore``
  refuses a checkpoint of another fingerprint.

npz cannot hold bfloat16: such leaves are stored as their 16-bit patterns
(uint16) with a dtype tag.  The manifest keeps logical shapes only;
``restore`` rebuilds every leaf in the dtype of the tree it is given and
puts it on the device the caller names (else that tree leaf's device).
Leaf names follow JAX's ``keystr`` (``['layers'][0]['attn']['wq']``).
"""
from __future__ import annotations

import json
import os
import shutil
import threading

import numpy as np
import torch

from repro_torch.models.common import flatten


def _key(path: tuple) -> str:
    return "".join(f"[{p}]" if isinstance(p, int) else f"['{p}']"
                   for p in path)


def _flatten(tree) -> dict:
    return {_key(path): leaf for path, leaf in flatten(tree)}


def _encode(t: torch.Tensor):
    """(numpy array, dtype tag) of a host tensor."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    a = t.numpy()
    return a, str(a.dtype)


def _decode(a: np.ndarray, dtype: str) -> torch.Tensor:
    a = np.array(a)              # contiguous and writable; keeps 0-d
    if dtype == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def save(ckpt_dir: str, step: int, tree, *, fingerprint: str = "",
         extra: dict | None = None, blocking: bool = True, keep: int = 3):
    """Write ``tree`` under ckpt_dir/step_<step>/ atomically; returns the
    writer thread when not ``blocking``."""
    host, dtypes = {}, {}
    for k, t in _flatten(tree).items():       # snapshot now
        host[k], dtypes[k] = _encode(t.detach().to("cpu", copy=True))

    def write():
        final = os.path.join(ckpt_dir, f"step_{step:08d}")
        tmp = final + ".tmp"
        os.makedirs(tmp, exist_ok=True)
        np.savez(os.path.join(tmp, "arrays.npz"), **host)
        manifest = {
            "step": step,
            "fingerprint": fingerprint,
            "extra": extra or {},
            "leaves": {k: {"shape": list(v.shape), "dtype": dtypes[k]}
                       for k, v in host.items()},
        }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        _retain(ckpt_dir, keep)

    if blocking:
        write()
        return None
    t = threading.Thread(target=write, daemon=True)
    t.start()
    return t


def _retain(ckpt_dir: str, keep: int):
    steps = sorted(d for d in os.listdir(ckpt_dir)
                   if d.startswith("step_") and not d.endswith(".tmp"))
    for d in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, d), ignore_errors=True)


def latest_step(ckpt_dir: str):
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
             if d.startswith("step_") and not d.endswith(".tmp")]
    return max(steps) if steps else None


def _rebuild(like, leaves: dict, prefix: tuple = ()):
    if isinstance(like, dict):
        return {k: _rebuild(v, leaves, prefix + (k,))
                for k, v in like.items()}
    if isinstance(like, list):
        return [_rebuild(v, leaves, prefix + (i,))
                for i, v in enumerate(like)]
    return leaves[_key(prefix)]


def restore(ckpt_dir: str, step: int, like_tree, *, fingerprint: str = "",
            device=None):
    """Load step_<step> into the structure and dtypes of ``like_tree``,
    each leaf on ``device`` (default: the like leaf's device).  Returns
    (tree, manifest)."""
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    if fingerprint and manifest["fingerprint"] != fingerprint:
        raise ValueError(
            f"checkpoint fingerprint {manifest['fingerprint']!r} does not "
            f"match the current config {fingerprint!r}")
    out = {}
    with np.load(os.path.join(d, "arrays.npz")) as arrays:
        for k, like in _flatten(like_tree).items():
            t = _decode(arrays[k], manifest["leaves"][k]["dtype"])
            if tuple(t.shape) != tuple(like.shape):
                raise ValueError(f"leaf {k}: saved {tuple(t.shape)} != "
                                 f"{tuple(like.shape)}")
            out[k] = t.to(device=device if device is not None
                          else like.device, dtype=like.dtype)
    return _rebuild(like_tree, out), manifest


class CheckpointManager:
    """Save-loop helper: interval policy, async handle, preemption
    flush."""

    def __init__(self, ckpt_dir: str, *, interval: int = 100, keep: int = 3,
                 fingerprint: str = ""):
        self.dir = ckpt_dir
        self.interval = interval
        self.keep = keep
        self.fingerprint = fingerprint
        self._pending = None
        os.makedirs(ckpt_dir, exist_ok=True)

    def maybe_save(self, step: int, tree, *, extra=None, force=False):
        if not force and (step == 0 or step % self.interval):
            return
        self.wait()
        self._pending = save(self.dir, step, tree,
                             fingerprint=self.fingerprint, extra=extra,
                             blocking=False, keep=self.keep)

    def wait(self):
        if self._pending is not None:
            self._pending.join()
            self._pending = None

    def latest(self):
        return latest_step(self.dir)

    def restore_latest(self, like_tree, device=None):
        step = self.latest()
        if step is None:
            return None, None
        return restore(self.dir, step, like_tree,
                       fingerprint=self.fingerprint, device=device)
