"""Serving driver: batched prefill, then greedy decode with caches.

    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch recurrentgemma-9b --requests 4 --prompt-len 3072 --gen 32
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch qwen3-32b --smoke --device cpu

Port of ``repro/launch/serve.py``: random weights drawn on the device
from ``--seed``, prompts from the Zipf-flavoured token draw (seed + 1),
one prefill of every request, then ``gen - 1`` decode steps, each taking
the argmax.  On the card the prefill runs the ``flash_attention``,
``rglru`` and ``rwkv6`` kernels; ``--device cpu`` runs their plain
versions.  Prints prefill ms, decode tokens/s and peak device memory with
the card's name and power limit.
"""
from __future__ import annotations

import argparse
import dataclasses
import subprocess
import time
from typing import Optional

import numpy as np
import torch

from repro_torch import kernels as K
from repro_torch.core.types import resolve_device
from repro_torch.data import pipeline
from repro_torch.models import model as model_mod
from repro_torch.models import steps


@dataclasses.dataclass
class ServeResult:
    tokens: np.ndarray          # int64 [requests, gen]: greedy tokens
    prefill_s: float            # host seconds of the prefill, synchronized
    decode_s: float             # host seconds of the gen - 1 decode steps
    prefill_logits: torch.Tensor        # float32 [requests, vocab], host
    decode_logits: Optional[torch.Tensor]  # first decode step's, or None
    launches: list              # per step {op: kernel launches}: prefill,
                                # then each decode step
    peak_bytes: int             # torch.cuda.max_memory_allocated (0: CPU)
    device: str                 # the card's name, or "cpu"

    @property
    def decode_tokens_per_s(self) -> float:
        n = self.tokens.shape[0] * (self.tokens.shape[1] - 1)
        return n / self.decode_s if self.decode_s > 0 else 0.0


def greedy(logits: torch.Tensor) -> torch.Tensor:
    """argmax over the vocabulary (the first maximum, as jnp.argmax)."""
    return torch.argmax(logits, dim=-1)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _step_launches(before: dict) -> dict:
    return {op: n - before[op] for op, n in K.launch_counts().items()}


def serve(cfg, *, n_requests: int, prompt_len: int, gen: int, seed: int = 0,
          device="cuda", tokens=None, params=None) -> ServeResult:
    """Serve ``n_requests`` prompts of ``prompt_len`` tokens for ``gen``
    tokens each.  ``tokens`` ([requests, prompt_len] ints) replaces the
    random prompts, ``params`` the random weights.  ``device`` defaults
    to CUDA and raises without it."""
    dev = resolve_device(device)
    if params is None:
        params = model_mod.init_params(cfg, seed, dev)
    if tokens is None:
        g = torch.Generator(device=dev)
        g.manual_seed(seed + 1)
        tokens = pipeline.tokens(g, (n_requests, prompt_len), cfg.vocab)
    tokens = torch.as_tensor(tokens).to(device=dev, dtype=torch.int64)
    prefill = steps.build_prefill_step(cfg, prompt_len + gen)
    decode = steps.build_decode_step(cfg)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)

    launches = []
    _sync(dev)
    before = K.launch_counts()
    t0 = time.perf_counter()
    cache, logits = prefill(params, {"tokens": tokens})
    tok = greedy(logits)[:, None]
    _sync(dev)
    t_prefill = time.perf_counter() - t0
    launches.append(_step_launches(before))
    prefill_logits, decode_logits = logits, None

    out = [tok]
    t0 = time.perf_counter()
    for i in range(gen - 1):
        before = K.launch_counts()
        logits, cache = decode(params, cache, tok, prompt_len + i)
        launches.append(_step_launches(before))
        if i == 0:
            decode_logits = logits
        tok = greedy(logits)[:, None]
        out.append(tok)
    _sync(dev)
    t_decode = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    return ServeResult(
        tokens=torch.cat(out, dim=1).cpu().numpy(),
        prefill_s=t_prefill, decode_s=t_decode,
        prefill_logits=prefill_logits.float().cpu(),
        decode_logits=(None if decode_logits is None
                       else decode_logits.float().cpu()),
        launches=launches, peak_bytes=peak,
        device=(torch.cuda.get_device_name(dev) if dev.type == "cuda"
                else "cpu"))


def card_line(dev: torch.device) -> str:
    """The card's name and power limit as nvidia-smi prints them."""
    if dev.type != "cuda":
        return "cpu"
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", f"--id={index}"],
            capture_output=True, text=True, timeout=60, check=True)
        return out.stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return f"{torch.cuda.get_device_name(dev)}, power limit not read"


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="the architecture's small smoke configuration")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=24)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cpu runs the plain PyTorch versions of the "
                         "kernels")
    args = ap.parse_args(argv)
    if args.gen < 1 or args.prompt_len < 1 or args.requests < 1:
        ap.error("--requests, --prompt-len and --gen must be >= 1")

    from repro_torch import configs
    cfg = (configs.get_smoke(args.arch) if args.smoke
           else configs.get(args.arch))
    dev = resolve_device(args.device)
    res = serve(cfg, n_requests=args.requests, prompt_len=args.prompt_len,
                gen=args.gen, seed=args.seed, device=dev)
    print(f"[serve] {cfg.name} on {card_line(dev)}")
    print(f"[serve] {args.requests} requests x {args.prompt_len} tokens: "
          f"prefill {res.prefill_s * 1e3:.3f} ms; {args.gen - 1} decode "
          f"steps in {res.decode_s * 1e3:.3f} ms "
          f"({res.decode_tokens_per_s:.1f} tok/s); peak device memory "
          f"{res.peak_bytes / 2**30:.3f} GiB")
    print("[serve] first request:", res.tokens[0][:16].tolist())
    return res


if __name__ == "__main__":
    main()
