"""End-to-end training driver of the PyTorch + CUDA port: a
~100M-parameter dense LM trained for a few hundred steps on one card,
with checkpointing and fault-tolerant resume (the twin of
examples/train_lm.py).

    PYTHONPATH=src python examples/train_lm_torch.py --steps 300
    PYTHONPATH=src python examples/train_lm_torch.py --device cpu --steps 20

On the card attention runs the ``flash_attention`` kernels (forward and
backward); ``--device cpu`` runs their plain versions.  The loss must
decrease.
"""
import argparse
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs.base import ModelConfig, ShapeSpec
from repro_torch.core.types import resolve_device
from repro_torch.launch.serve import card_line
from repro_torch.launch.train import TrainRun, run_supervised
from repro_torch.optim import AdamW

# ~100M params: 12 x (d=640, H=10, kv=5, F=2560) + 48k vocab
CFG_100M = ModelConfig(
    name="demo-100m", family="dense",
    n_layers=12, d_model=640, n_heads_raw=10, n_kv=5, d_head=64,
    d_ff=2560, vocab_raw=48_000,
    rope_theta=10_000.0, head_pad=1,
    param_dtype="float32", adam_master_f32=False,
    n_micro=1, remat=False,
)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_lm"))
    ap.add_argument("--out", default="reports/train_lm_torch_loss.json")
    args = ap.parse_args()

    cfg = CFG_100M
    dev = resolve_device(args.device)
    n = cfg.param_count(padded=True)
    print(f"[train_lm] {cfg.name}: {n/1e6:.1f}M params, "
          f"{args.steps} steps of {args.batch}x{args.seq} tokens on "
          f"{card_line(dev)}")

    shape = ShapeSpec("demo", "train", args.seq, args.batch)
    opt = AdamW.from_config(cfg, peak_lr=6e-4, total_steps=args.steps,
                            warmup_steps=max(args.steps // 20, 5))
    run = TrainRun(
        cfg=cfg, optimizer=opt, shape=shape,
        ckpt=CheckpointManager(args.ckpt_dir, interval=100,
                               fingerprint=cfg.name),
        log_every=10, device=dev)

    t0 = time.time()
    _, _, losses, restarts = run_supervised(run, args.steps)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.time() - t0
    tok_s = args.steps * args.batch * args.seq / dt
    print(f"[train_lm] {dt:.0f}s wall ({tok_s:.0f} tok/s), "
          f"loss {losses[0][1]:.3f} -> {losses[-1][1]:.3f}")
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"losses": losses, "wall_s": dt, "params": n,
                   "device": card_line(dev)}, f)
    assert losses[-1][1] < losses[0][1], "loss must decrease"


if __name__ == "__main__":
    main()
